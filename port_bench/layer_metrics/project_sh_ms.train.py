"""Device ms per training step launched inside the port's
``render.project`` and ``render.colors`` spans: the forward projection and
SH evaluation (their gradients fall to ``train.backward``;
``port_bench/spans.py``)."""
from port_bench.spans import per_item_ms


def read(ctx):
    return per_item_ms(ctx, "train", ["render.project", "render.colors"],
                       "device_s")
