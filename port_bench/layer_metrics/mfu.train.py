"""The whole training step's share of the card's peak, in %: the least
time of every part of the traced window's items (the counts of work/) over the
traced window's length."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["device_seen"] or ctx["kind"] != "train":
        return None
    if t["window_s"] <= 0.0 or ctx["least"]["all_s"] <= 0.0:
        return None
    return 100.0 * ctx["least"]["all_s"] / t["window_s"]
