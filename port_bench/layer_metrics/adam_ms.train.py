"""Device ms per training step launched inside the port's ``train.adam``
span: Adam's moments and the parameters' update (``port_bench/spans.py``)."""
from port_bench.spans import per_item_ms


def read(ctx):
    return per_item_ms(ctx, "train", ["train.adam"], "device_s")
