"""The program's host data preparation: ``generate_sets`` and
``Graph.from_edges`` (host clock)."""


def read(rec):
    return rec["setup"]["data_s"]
