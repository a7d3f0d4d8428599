"""Host ms per training step inside the port's ``wait.*`` spans, each
around one site that blocks the host on the card (``port_bench/spans.py``)."""
from port_bench.spans import waits


def read(ctx):
    return waits(ctx, "train", "host_s")
