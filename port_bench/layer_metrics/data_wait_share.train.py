"""The share of the traced window, in %, that the step loop spent in the
port's ``data.wait`` span, waiting on the loader's lookahead thread: the
in-program twin of ``loader_wait_share.train`` (``port_bench/spans.py``)."""
from port_bench.spans import per_item_ms


def read(ctx):
    ms = per_item_ms(ctx, "train", ["data.wait"], "host_s")
    t = ctx.get("trace")
    if ms is None or not t["window_s"]:
        return None
    return 100.0 * ms * t["spans"]["items"] / (1e3 * t["window_s"])
