"""Device milliseconds per held-out evaluation under the program's
``ppx`` stage range."""


def read(rec):
    t = rec["trace"]
    if not t or not t["evals"]:
        return None
    s = t["stage_device_s"].get("ppx", 0.0)
    return s / t["evals"] * 1e3 if s > 0 else None
