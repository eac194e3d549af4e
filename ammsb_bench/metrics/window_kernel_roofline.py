"""The windows' least time on the card over their measured device time
under ``window_kernel``, in percent. The least time of one window is
``counts.window_least_seconds`` of the cell's shape; the traced steps
ran interval // T windows in each chunk of ``interval`` steps."""

from ammsb_bench import counts


def read(rec):
    t = rec["trace"]
    if not t or not t["steps"]:
        return None
    s = t["stage_device_s"].get("window_kernel", 0.0)
    shape = rec["shape"]
    windows = (t["steps"] // shape.interval) * (shape.interval // shape.T)
    if s <= 0 or windows <= 0:
        return None
    return 100.0 * windows * counts.window_least_seconds(shape) / s
