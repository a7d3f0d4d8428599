"""Device ms per training step launched inside the port's
``train.backward`` span: all of autograd, the rasterizer's K3 / K3s and
K4 included (``port_bench/spans.py``)."""
from port_bench.spans import per_item_ms


def read(ctx):
    return per_item_ms(ctx, "train", ["train.backward"], "device_s")
