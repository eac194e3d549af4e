"""Device microseconds per step under the program's sampling and
hoisting stage ranges: device sampling (``device_sampling``, ``ds_*``),
the shared neighbor draws, the noise and the edge lane maps."""

STAGES = ("device_sampling", "ds_link", "ds_nonlink", "ds_extract_nodes",
          "ds_bf_link", "ds_bf_nonlink", "neighbor_draws", "noise",
          "edge_lanes")


def read(rec):
    t = rec["trace"]
    if not t or not t["steps"]:
        return None
    s = sum(t["stage_device_s"].get(name, 0.0) for name in STAGES)
    return s / t["steps"] * 1e6 if s > 0 else None
