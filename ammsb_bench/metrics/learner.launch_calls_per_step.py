"""The host's launch calls (``cudaLaunchKernel*``, ``cuLaunchKernel*``,
``cudaGraphLaunch``) in the traced stretch, per step. A CUDA graph's
replay is one call, so capturing a chunk moves this count."""


def read(rec):
    t = rec["trace"]
    if not t or not t["launch_calls"] or not t["steps"]:
        return None
    return t["launch_calls"] / t["steps"]
