"""Device ms per training step in kernels that are neither the port's
hand-written ones nor the sort's: the plain-torch layers (projection, SH,
SSIM, the loss, autograd, Adam, indexing), from the device trace."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["device_seen"] or ctx["kind"] != "train":
        return None
    return 1e3 * t["by_class"].get("torch", 0.0) / t["items"]
