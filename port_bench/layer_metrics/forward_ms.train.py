"""Device ms per training step launched inside the port's
``train.forward`` span (render, loss, the plugins' terms), from the
device trace joined to the program's spans (``port_bench/spans.py``)."""
from port_bench.spans import per_item_ms


def read(ctx):
    return per_item_ms(ctx, "train", ["train.forward"], "device_s")
