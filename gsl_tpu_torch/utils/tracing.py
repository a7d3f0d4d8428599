"""Named spans at the port's layer boundaries, recorded in the same
``torch.profiler`` trace as the device's kernels.

``with span("train.adam"):`` is ``torch.profiler.record_function`` while a
torch profiler records (``torch.autograd.profiler._is_profiler_enabled``,
which ``torch.profiler.profile`` sets on entry and clears on exit), and
otherwise one shared context manager that does nothing: one attribute
read and an empty enter and exit. There is no switch of its own: the spans
are on exactly when someone profiles. They are host events of the
profiler's own trace, on the same clock as its device events, so a
kernel's time falls to the span whose runtime call launched it and an
idle stretch of the device to the span the host was in.

Names are ``<layer>.<stage>``: ``data.*``, ``train.*``, ``render.*``,
``raster.*``, ``sh.*``, ``viewer.*``. A ``wait.<site>`` span holds the
one site whose calls block the host on the device (a read of a device
value, a copy to or from pageable host memory, which synchronises the
stream), so the host waits of a step are the ``wait.*`` spans in it. Rules for a
site: a fixed string as the name; no span held across a ``yield``; a span
adds no device read, synchronisation or allocation of its own.
"""
from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records `name` while a torch profiler
    records, and does nothing otherwise."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF
