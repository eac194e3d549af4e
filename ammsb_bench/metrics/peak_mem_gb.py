"""``torch.cuda.max_memory_allocated()`` at the window's end, after a
reset at the start of set-up, in GB (10^9 bytes); none off the card."""


def read(rec):
    return rec["peak_bytes"] / 1e9 if rec["peak_bytes"] else None
