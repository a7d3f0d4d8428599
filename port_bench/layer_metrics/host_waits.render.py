"""The port's ``wait.*`` spans per served frame: how often the host
blocks on the card (``port_bench/spans.py``)."""
from port_bench.spans import waits


def read(ctx):
    return waits(ctx, "viewer", "calls")
