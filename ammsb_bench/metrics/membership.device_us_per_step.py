"""Device microseconds per step under the program's ``membership``
stage range (the hoisted edge labels)."""


def read(rec):
    t = rec["trace"]
    if not t or not t["steps"]:
        return None
    s = t["stage_device_s"].get("membership", 0.0)
    return s / t["steps"] * 1e6 if s > 0 else None
