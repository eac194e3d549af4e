"""Host microseconds per step in the chunk tail: the traced stretch's
``window_tail`` spans (the steps after a chunk's last window, run
through the step body) less the ``device_wait`` spans inside them, where
the host waits for the card, over the steps of the ``chunk`` spans. Read
from the program's span recorder (``utils/profiling.recorded``), which
the traced stretch alone fills; None where the program has no recorder,
no tail was recorded, or the recorded steps are not the stretch's."""


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
    if steps != t["steps"] or any(s.end_ns is None for s in spans) \
            or not any(s.name == "window_tail" for s in spans):
        return None
    host_ns = 0
    for i, s in enumerate(spans):
        if s.name == "window_tail":
            host_ns += s.end_ns - s.start_ns
        elif (s.name == "device_wait"
              and _inside(spans, i, ("window_tail",))):
            host_ns -= s.end_ns - s.start_ns
    return host_ns * 1e-3 / steps
