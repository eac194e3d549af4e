"""Device microseconds per step under the program's ``window_kernel``
stage range (each window's launch and what it issues)."""


def read(rec):
    t = rec["trace"]
    if not t or not t["steps"]:
        return None
    s = t["stage_device_s"].get("window_kernel", 0.0)
    return s / t["steps"] * 1e6 if s > 0 else None
