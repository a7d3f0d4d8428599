"""Host ms per served frame inside the port's ``viewer.frame`` span, less
its ``wait.*`` spans: what the host spends issuing the frame's work, its
waits on the card taken out (``port_bench/spans.py``)."""
from port_bench.spans import per_item_ms


def read(ctx):
    host = per_item_ms(ctx, "viewer", ["viewer.frame"], "host_s")
    if host is None:
        return None
    return host - per_item_ms(ctx, "viewer", ["viewer.frame"],
                              "wait_host_s")
