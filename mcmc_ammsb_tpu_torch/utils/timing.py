"""Stage timers + stats table (a copy of
``mcmc_ammsb_tpu/utils/timing.py``, timed on the device on a card).

The reference accumulates per-kernel seconds and prints a stage table
with % of total at exit (learner.cc:252-299). The port's stages are the
device chunks of the training loop (``device_step``), evaluation
(``ppx``, ``train_ppx``) and the whole run (``total``). The host only
enqueues their work, so on a card (``device``) these ``DEVICE_STAGES``
are timed by CUDA events recorded on the device's stream at the stage's
start and end, without a fence: the seconds the device took from the
start's event to the end's. A stage's seconds count once its end event
has completed; reading ``seconds`` resolves the completed ones. Other
stages (``sampling``, host work) and every stage on the CPU read the
host clock.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict

import torch

#: the stages whose work is the device's
DEVICE_STAGES = frozenset({"total", "device_step", "ppx", "train_ppx"})

#: unresolved event pairs kept before a stage's start resolves them
_MAX_PENDING = 64


class StageTimers:
    def __init__(self, device=None):
        self._seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        device = None if device is None else torch.device(device)
        self._device = (device if device is not None
                        and device.type == "cuda" else None)
        self._pending = []   # (name, start event, end event), end order

    @property
    def seconds(self) -> Dict[str, float]:
        """Seconds per stage (the device stages' completed ones)."""
        self._resolve()
        return self._seconds

    def _resolve(self) -> None:
        done = 0
        for name, start, end in self._pending:
            if not end.query():
                break
            self._seconds[name] += start.elapsed_time(end) * 1e-3
            done += 1
        del self._pending[:done]

    @contextlib.contextmanager
    def stage(self, name: str):
        if self._device is None or name not in DEVICE_STAGES:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1
            return
        if len(self._pending) >= _MAX_PENDING:
            self._resolve()
        stream = torch.cuda.current_stream(self._device)
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        try:
            yield
        finally:
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            self._pending.append((name, start, end))
            self.calls[name] += 1

    def print_table(self, log: Callable[[str], None] = print) -> None:
        seconds = self.seconds
        total = seconds.get("total", sum(seconds.values()))
        log(f"TOTAL    : {total:.6f}")
        for name in sorted(seconds):
            if name == "total":
                continue
            s = seconds[name]
            pct = 100.0 * s / total if total else 0.0
            log(f"{name.upper():9s}: {s:.6f} (%{pct:.2f}) "
                f"[{self.calls[name]} calls]")
