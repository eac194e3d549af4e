"""The benchmark of ``mcmc_ammsb_tpu_torch`` on one NVIDIA H100.

``python -m ammsb_bench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Each configuration (``configs/``), traffic mix
(``traffic/``), metric (``metrics/``) and set of output limits
(``limits/``) is a file of its own, found by the name that
``BENCHMARK.json`` gives it.
"""
