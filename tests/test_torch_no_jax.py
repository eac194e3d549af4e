"""The port never imports JAX or the JAX package: with ``jax`` and
``mcmc_ammsb_tpu`` made unimportable, every module of the port and its
CLI still import (the GPU machine has no JAX), the multi-GPU package
``parallel/`` among them, the config ladder, the entry() twin and the
bench, and the native library builds and loads."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['mcmc_ammsb_tpu'] = None\n"
            "import mcmc_ammsb_tpu_torch, mcmc_ammsb_tpu_torch.cli\n"
            "import mcmc_ammsb_tpu_torch.testing\n"
            "import mcmc_ammsb_tpu_torch.interop\n"
            "import mcmc_ammsb_tpu_torch.models.mmsb\n"
            "import mcmc_ammsb_tpu_torch.ops.window_mmsb\n"
            "import mcmc_ammsb_tpu_torch.ops.phi_pallas\n"
            "import mcmc_ammsb_tpu_torch.chains_flat\n"
            "import mcmc_ammsb_tpu_torch.chains\n"
            "import mcmc_ammsb_tpu_torch.checkpoint\n"
            "import mcmc_ammsb_tpu_torch.refckpt\n"
            "import mcmc_ammsb_tpu_torch.ops.sort\n"
            "import mcmc_ammsb_tpu_torch.ops.rowops\n"
            "import mcmc_ammsb_tpu_torch.models.ammsb\n"
            "import mcmc_ammsb_tpu_torch.native\n"
            "import mcmc_ammsb_tpu_torch.sampling\n"
            "import mcmc_ammsb_tpu_torch.data\n"
            "import mcmc_ammsb_tpu_torch.learner\n"
            "import mcmc_ammsb_tpu_torch.ops.edgeset\n"
            "import mcmc_ammsb_tpu_torch.ops.phi\n"
            "import mcmc_ammsb_tpu_torch.ops.beta\n"
            "import mcmc_ammsb_tpu_torch.ops.device_sampling\n"
            "import mcmc_ammsb_tpu_torch.rng.reference\n"
            "import mcmc_ammsb_tpu_torch.rng.refblock\n"
            "import mcmc_ammsb_tpu_torch.utils.profiling\n"
            "import mcmc_ammsb_tpu_torch.autotune\n"
            "import mcmc_ammsb_tpu_torch.parallel\n"
            "import mcmc_ammsb_tpu_torch.parallel.mesh\n"
            "import mcmc_ammsb_tpu_torch.parallel.multihost\n"
            "import mcmc_ammsb_tpu_torch.parallel.sharded\n"
            "import mcmc_ammsb_tpu_torch.parallel.chains_sharded\n"
            "import mcmc_ammsb_tpu_torch.parallel.partitioned\n"
            "import mcmc_ammsb_tpu_torch.parallel.dryrun\n"
            "import mcmc_ammsb_tpu_torch.ladder\n"
            "import mcmc_ammsb_tpu_torch.graft\n"
            "import mcmc_ammsb_tpu_torch.bench\n"
            "from mcmc_ammsb_tpu_torch import rng\n"
            "assert rng.make_streams and rng.reference.make_seeds\n"
            "mcmc_ammsb_tpu_torch.native.available()\n"
            "from pathlib import Path\n"
            "pkg = Path(mcmc_ammsb_tpu_torch.__file__).resolve().parent\n"
            "assert pkg in mcmc_ammsb_tpu_torch.native.SOURCE.parents\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', "
            "'mcmc_ammsb_tpu.')) or m == 'mcmc_ammsb_tpu' "
            "for m, v in sys.modules.items() if v is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_jax_fixtures_restore_without_jax():
    """``cli.main(... --restore <fixture>)`` of each committed JAX-written
    checkpoint (tests/fixtures/jax_ckpt/) with ``jax`` and
    ``mcmc_ammsb_tpu`` unimportable: rc 0, restored at step 11, and no
    module of either imported (the pickled batches name the JAX
    package's classes)."""
    code = (
        "import json, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mcmc_ammsb_tpu'] = None\n"
        "from mcmc_ammsb_tpu_torch import cli\n"
        "for name in ('learner_host', 'learner_reference'):\n"
        "    base = 'tests/fixtures/jax_ckpt/' + name\n"
        "    argv = json.load(open(base + '.json'))['argv']\n"
        "    assert cli.main(argv + ['--restore', base + '.npz', '--device',\n"
        "                            'cpu', '-x', '0']) == 0\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', "
        "'mcmc_ammsb_tpu.')) or m == 'mcmc_ammsb_tpu' "
        "for m, v in sys.modules.items() if v is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stderr.count("(step=11)") == 2, proc.stderr
