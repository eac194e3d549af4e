"""Seconds from the start of the process to the first timed step: the
graph (cache read or generation), the program's data preparation, the
learner and one warm-up call (host clock)."""


def read(rec):
    return rec["setup"]["setup_s"]
