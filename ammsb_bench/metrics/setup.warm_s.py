"""The ``Learner`` (edge sets, held-out population, pi drawn on the
card, kernels loaded) through the fenced warm-up call (host clock)."""


def read(rec):
    return rec["setup"]["warm_s"]
