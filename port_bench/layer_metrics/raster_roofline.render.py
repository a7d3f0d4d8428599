"""The hand-written rasterizer kernels' share of their roofline, in %:
the least time of the work they did in the traced window (counted by
work/ from the benchmark's inputs) over their device time there. A
window without them gives nothing."""
from port_bench.work import KERNELS


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["device_seen"] or ctx["kind"] != "viewer":
        return None
    spent = sum(t["by_class"].get(k, 0.0) for k in KERNELS["hand_written"])
    if spent <= 0.0 or ctx["least"]["kernels_s"] <= 0.0:
        return None
    return 100.0 * ctx["least"]["kernels_s"] / spent
