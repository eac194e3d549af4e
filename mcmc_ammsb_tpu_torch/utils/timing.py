"""Stage timers + stats table (a copy of
``mcmc_ammsb_tpu/utils/timing.py``).

The reference accumulates per-kernel seconds and prints a stage table
with % of total at exit (learner.cc:252-299). The port's stages are the
device chunks of the training loop (``device_step``), evaluation
(``ppx``) and the whole run (``total``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict


class StageTimers:
    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def print_table(self, log: Callable[[str], None] = print) -> None:
        total = self.seconds.get("total", sum(self.seconds.values()))
        log(f"TOTAL    : {total:.6f}")
        for name in sorted(self.seconds):
            if name == "total":
                continue
            s = self.seconds[name]
            pct = 100.0 * s / total if total else 0.0
            log(f"{name.upper():9s}: {s:.6f} (%{pct:.2f}) "
                f"[{self.calls[name]} calls]")
