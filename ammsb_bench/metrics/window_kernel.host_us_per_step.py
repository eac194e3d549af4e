"""Host microseconds per step spent issuing whole windows: the traced
stretch's ``window_kernel`` spans less the ``device_wait`` and
``readback`` spans inside them, where the host waits for the card, over
the steps of the ``chunk`` spans. Read from the program's span recorder
(``utils/profiling.recorded``), which the traced stretch alone fills;
None where the program has no recorder, no window was recorded, the
recorded steps are not the stretch's, a ``window_kernel`` span carries
no tag (the kernel layout that ran it), or the spans' tags name more
than one layout: a cell whose windows split across layouts reads as
missing, not as a number."""

WAITS = ("device_wait", "readback")


def _inside(spans, i, names):
    """Whether span ``i`` opened inside a span named in ``names``."""
    p = spans[i].parent
    while p >= 0:
        if spans[p].name in names:
            return True
        p = spans[p].parent
    return False


def read(rec):
    from mcmc_ammsb_tpu_torch.utils import profiling

    recorded = getattr(profiling, "recorded", None)
    t = rec["trace"]
    if recorded is None or not t or not t["steps"]:
        return None
    spans = recorded()
    steps = sum(s.count or 0 for i, s in enumerate(spans)
                if s.name == "chunk" and not _inside(spans, i, ("chunk",)))
    windows = [s for s in spans if s.name == "window_kernel"]
    tags = {getattr(s, "tag", None) for s in spans} - {None}
    if (steps != t["steps"] or any(s.end_ns is None for s in spans)
            or not windows or len(tags) != 1
            or any(getattr(s, "tag", None) is None for s in windows)):
        return None
    host_ns = 0
    for i, s in enumerate(spans):
        if s.name == "window_kernel" and not _inside(spans, i,
                                                     ("window_kernel",)):
            host_ns += s.end_ns - s.start_ns
        elif (s.name in WAITS and _inside(spans, i, ("window_kernel",))
              and not _inside(spans, i, WAITS)):
            host_ns -= s.end_ns - s.start_ns
    return host_ns * 1e-3 / steps
