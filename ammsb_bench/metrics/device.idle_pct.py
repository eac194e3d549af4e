"""The share of a step in which no kernel, copy or fill runs on the
card, in percent: one less the device's busy seconds per step in the
traced stretch (the union of the busy intervals) over the window's
seconds per step outside the traced stretch and the profiler's work.
The untraced step time is taken because the profiler slows the host's
launches, which would add idle time that untraced runs do not have."""


def read(rec):
    t = rec["trace"]
    if not t or t["busy_s"] <= 0 or not t["steps"]:
        return None
    steps = rec["steps"] - t["steps"]
    seconds = rec["window_s"] - t["total_s"]
    if steps <= 0 or seconds <= 0:
        return None
    return 100.0 * (1.0 - (t["busy_s"] / t["steps"]) / (seconds / steps))
