"""SGRLD steps completed in the window, evaluations included, over the
window's fenced seconds (host clock)."""


def read(rec):
    return rec["steps"] / rec["window_s"]
