"""Host ms per training step inside the port's ``train.step`` span, less
its ``wait.*`` spans: what the host spends issuing the step's work, its
waits on the card taken out (``port_bench/spans.py``)."""
from port_bench.spans import per_item_ms


def read(ctx):
    host = per_item_ms(ctx, "train", ["train.step"], "host_s")
    if host is None:
        return None
    return host - per_item_ms(ctx, "train", ["train.step"], "wait_host_s")
