"""The share of the measured window, in %, that the step loop spent in
``next(loader)`` (host clock, around the call in the benchmark's loop)."""


def read(ctx):
    h = ctx["host"]
    if ctx["kind"] != "train" or not h.get("window_s"):
        return None
    return 100.0 * h["loader_wait_s"] / h["window_s"]
