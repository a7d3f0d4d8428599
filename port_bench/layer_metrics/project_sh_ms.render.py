"""Device ms per served frame launched inside the port's
``render.project`` and ``render.colors`` spans: projection and SH
evaluation (``port_bench/spans.py``)."""
from port_bench.spans import per_item_ms


def read(ctx):
    return per_item_ms(ctx, "viewer", ["render.project", "render.colors"],
                       "device_s")
