"""The share of the traced window, in %, in which the card runs no
kernel, copy or fill (the union of the trace's device intervals)."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["device_seen"] or ctx["kind"] != "train":
        return None
    if t["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
