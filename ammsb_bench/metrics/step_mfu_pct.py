"""The whole step's least time on the card over its measured time, in
percent. The least time is ``counts.step_least_seconds`` of the cell's
shape (the step is memory-bound, so this is a roofline share of the
step); the measured time is the window's seconds per step outside the
traced stretch and the profiler's work (host clock, evaluations
included)."""

from ammsb_bench import counts


def read(rec):
    t = rec["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    steps = rec["steps"] - t["steps"]
    seconds = rec["window_s"] - t["total_s"]
    if steps <= 0 or seconds <= 0:
        return None
    return 100.0 * counts.step_least_seconds(rec["shape"]) / (seconds / steps)
