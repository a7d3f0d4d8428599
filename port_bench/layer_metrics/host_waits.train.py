"""The port's ``wait.*`` spans per training step: how often the host
blocks on the card (a step captured as one CUDA graph needs 0;
``port_bench/spans.py``)."""
from port_bench.spans import waits


def read(ctx):
    return waits(ctx, "train", "calls")
