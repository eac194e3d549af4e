"""Window-size autotuner (counterpart of ``mcmc_ammsb_tpu/autotune.py``).

The CLI's ``--window 0`` picks T by the JAX package's measured rule (12
up to 8 chains, 96 // C up to 16); ``--auto-tune-window`` measures
instead: each candidate T runs a few chunks on the actual device, graph
and config, and the fastest is kept. The window size does not change
the trajectory's law (the windowed run is the sequential scan's up to
float reduction order), so tuning T is a pure performance choice.

The JAX package's rule is kept: best of two timed probes per candidate,
the largest rate wins. Two changes: the TPU's VMEM envelope becomes the
port's shared-memory rule (``ops/window.window_plan``, the rule the
kernel's launch goes by): a T whose window fits the card's shared memory
in neither of the kernel's modes is not a candidate; and
only a candidate that the config guards refuse (``ValueError``) or that
runs out of device memory is recorded as failed. Any other error, such as
a kernel that does not build or launch, ends the tuning: a broken kernel
must not hide behind window 0.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from mcmc_ammsb_tpu_torch.config import Config, PhiImpl, RngBackend

log = logging.getLogger(__name__)

#: The JAX package's frontier of useful window sizes (0 = no windows).
DEFAULT_CANDIDATES = (0, 6, 8, 12, 16)


def window_candidates(cfg: Config,
                      candidates: Sequence[int] = DEFAULT_CANDIDATES,
                      smem_limit: Optional[int] = None) -> List[int]:
    """Candidate window sizes valid for ``cfg`` (always including 0): the
    window engine's preconditions (device sampling, shared draws, the
    native RNG, the jnp phi), the auto rule's fallback for hub-padded
    batches (max_batch_nodes > 64), and the window kernel's plan
    (``window_plan``) at the card's limit (``smem_limit``, the H100's by
    default),
    which does not depend on the chain count: each chain is a cluster."""
    from mcmc_ammsb_tpu_torch.ops import window

    if (not cfg.device_sampling or not cfg.shared_neighbors
            or cfg.rng_backend != RngBackend.NATIVE
            or cfg.phi_impl != PhiImpl.JNP or cfg.max_batch_nodes > 64):
        return [0]
    limit = window.H100_SMEM if smem_limit is None else smem_limit
    out = [0]
    for t in candidates:
        if t <= 1 or t in out or t > window.MAX_WINDOW:
            continue
        try:
            window.window_plan(t, cfg.max_batch_nodes, cfg.num_node_sample,
                               cfg.max_batch_edges, cfg.K, limit)
        except ValueError:
            continue
        out.append(t)
    return out


def probe_rate(make_learner: Callable[[], object], probe_steps: int,
               warm_steps: int,
               clock: Callable[[], float] = time.perf_counter,
               repeats: int = 2) -> float:
    """Measured steps/s of one engine configuration: ``make_learner()``
    returns an engine with ``run(n)``, ``state.step_count`` and
    ``close()``; the warm-up (kernel builds, the first chunk) runs
    outside the timed region; ``run`` waits for the device before it
    returns. ``repeats`` timed probes run back to back and the best is
    returned: stalls only ever slow a probe down."""
    learner = make_learner()
    try:
        learner.run(warm_steps)
        best = 0.0
        for _ in range(max(1, repeats)):
            s0 = int(learner.state.step_count)
            t0 = clock()
            learner.run(probe_steps)
            steps = int(learner.state.step_count) - s0
            dt = clock() - t0
            if steps != probe_steps:
                raise RuntimeError(f"probe advanced {steps} steps, "
                                   f"expected {probe_steps}")
            best = max(best, steps / dt)
        return best
    finally:
        learner.close()


def tune_window(cfg: Config, make_learner: Callable[[Config], object],
                candidates: Optional[Sequence[int]] = None,
                probe_steps: Optional[int] = None,
                warm_steps: Optional[int] = None,
                clock: Callable[[], float] = time.perf_counter,
                smem_limit: Optional[int] = None,
                ) -> Tuple[Config, Dict[int, Optional[float]]]:
    """Probe each candidate window size; return ``(best_cfg, table)``,
    the table mapping window -> steps/s (per chain for a chain engine),
    or None for a candidate refused by a config guard or out of device
    memory (its error is logged). Other errors propagate. Raises when
    every candidate failed."""
    cands = (window_candidates(cfg, smem_limit=smem_limit)
             if candidates is None else list(candidates))
    spc = max(1, cfg.steps_per_call)
    warm = spc if warm_steps is None else warm_steps
    probe = 2 * spc if probe_steps is None else probe_steps
    table: Dict[int, Optional[float]] = {}
    for w in cands:
        cand = cfg.replace(window=w)
        try:
            table[w] = probe_rate(lambda: make_learner(cand), probe, warm,
                                  clock=clock)
            log.info("autotune: window=%d -> %.0f updates/s", w, table[w])
        except (ValueError, torch.cuda.OutOfMemoryError) as e:
            table[w] = None
            log.warning("autotune: window=%d failed (%s: %s)", w,
                        type(e).__name__, e)
    measured = {w: r for w, r in table.items() if r is not None}
    if not measured:
        raise RuntimeError(f"autotune: every candidate failed ({table})")
    best = max(measured, key=measured.get)
    return cfg.replace(window=best), table
