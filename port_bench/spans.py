"""The port's own spans (``gsl_tpu_torch/utils/tracing.py``) read out of a
traced window's Chrome trace: each span's calls, host time and the device
time it launched, and what no span covers.

A program span is a ``user_annotation`` event other than the harness's
item mark. Spans on one host thread nest; a span on another thread
(autograd's, where the backward of a card's tensors runs) whose own
thread holds no span around it sits in the span open on the items'
thread when it starts. A device event (kernel, copy, fill) is joined to
the runtime call that launched it by the trace's ``correlation`` id and
falls to the innermost program span open on the launching thread, or,
where none is open there, to the innermost one open at that moment on
the items' thread: a backward kernel autograd launches outside the
rasterizer's spans falls to ``train.backward``. A span's ``device_s``
holds what falls to it and to every span inside it.

``attribute(events, mark)`` returns, over the window from the first mark
to the later of the last mark's end and the last device event's (as
``trace.parse`` takes it):

- ``by_span``: per span name, ``calls``, ``host_s``, ``self_host_s``
  (less its child spans on its own thread), ``wait_host_s`` (the host
  time of the ``wait.*`` spans inside it on its own thread), ``device_s``
  and ``kernel_s`` (kernels alone), and ``idle_s``: the window's idle
  stretches (no device event running) while it was the innermost span
  open on the items' thread;
- ``items``, ``device_s`` and ``kernel_s`` of the whole window,
  ``idle_s``; ``device_outside_s``, launched in no span;
  ``idle_outside_s``, idle while no span was open on the items' thread;
- ``blocking_outside``: the calls that block the host on the device
  (stream and device synchronisations, ``cudaMemcpy``, a
  ``cudaMemcpyAsync`` to or from pageable memory) made inside a program
  span and inside no ``wait.*`` span, counted by innermost span and call;
  ``blocking_unspanned``: those made in no program span (the fit loop's
  own body), counted by call.
"""
from __future__ import annotations

import bisect
import collections

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CAT = "user_annotation"
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
            "cudaEventSynchronize")
WAIT = "wait."


class _Span:
    __slots__ = ("name", "s", "e", "tid", "parent", "same_thread")

    def __init__(self, name, s, e, tid):
        self.name, self.s, self.e, self.tid = name, s, e, tid
        self.parent = None          # the span it sits in, any thread
        self.same_thread = False    # whether that parent is on its thread


class _Thread:
    """One thread's spans, nested, for the innermost span open at a time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda sp: (sp.s, -sp.e))
        self.starts = [sp.s for sp in self.spans]
        self.edges = sorted({x for sp in self.spans for x in (sp.s, sp.e)})
        stack = []
        for sp in self.spans:
            while stack and stack[-1].e <= sp.s:
                stack.pop()
            if stack:
                sp.parent, sp.same_thread = stack[-1], True
            stack.append(sp)

    def at(self, t):
        """The innermost span open at `t`, or None."""
        j = bisect.bisect_right(self.starts, t) - 1
        sp = self.spans[j] if j >= 0 else None
        while sp is not None and not (sp.s <= t < sp.e):
            sp = sp.parent if sp.same_thread else None
        return sp


def _events(events, mark):
    spans, marks, dev, runtime = [], [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        s = float(e["ts"])
        end = s + float(e["dur"])
        if cat == SPAN_CAT:
            if name == mark:
                marks.append((s, end, e.get("tid")))
            else:
                spans.append(_Span(name, s, end, e.get("tid")))
        elif cat in DEVICE_CATS:
            dev.append((s, end, name, cat,
                        (e.get("args") or {}).get("correlation")))
        elif cat in RUNTIME_CATS:
            corr = (e.get("args") or {}).get("correlation")
            runtime[corr] = (s, end, name, e.get("tid"))
    return spans, marks, dev, runtime


def _union(intervals):
    segs = []
    for s, e in sorted(intervals):
        if segs and s <= segs[-1][1]:
            segs[-1][1] = max(segs[-1][1], e)
        else:
            segs.append([s, e])
    return segs


def _chain(sp):
    while sp is not None:
        yield sp
        sp = sp.parent


def attribute(events: list, mark: str) -> dict:
    """Chrome-trace events (µs) -> seconds by program span; see the
    module's docstring."""
    spans, marks, dev, runtime = _events(events, mark)
    empty = dict(by_span={}, items=len(marks), device_s=0.0, kernel_s=0.0,
                 idle_s=0.0, device_outside_s=0.0, idle_outside_s=0.0,
                 blocking_outside=[], blocking_unspanned=[])
    if not marks:
        return empty
    w0 = min(m[0] for m in marks)
    w1 = max([m[1] for m in marks] + [d[1] for d in dev])
    main = marks[0][2]
    spans = [sp for sp in spans if w0 <= sp.s < w1]
    threads = {}
    for sp in spans:
        threads.setdefault(sp.tid, []).append(sp)
    threads = {tid: _Thread(sps) for tid, sps in threads.items()}
    items_thread = threads.get(main)

    def on_items_thread(t):
        return items_thread.at(t) if items_thread is not None else None

    for sp in spans:            # a thread's outermost spans, placed
        if sp.parent is None and sp.tid != main:
            sp.parent = on_items_thread(sp.s)

    def owner(tid, t):
        th = threads.get(tid)
        sp = th.at(t) if th is not None else None
        return sp if sp is not None else on_items_thread(t)

    by = collections.defaultdict(lambda: dict(
        calls=0, host_s=0.0, self_host_s=0.0, wait_host_s=0.0,
        device_s=0.0, kernel_s=0.0, idle_s=0.0))
    for sp in spans:
        d = sp.e - sp.s
        b = by[sp.name]
        b["calls"] += 1
        b["host_s"] += d
        b["self_host_s"] += d
        if sp.parent is not None and sp.same_thread:
            by[sp.parent.name]["self_host_s"] -= d
        if sp.name.startswith(WAIT):
            for up in _chain(sp.parent):
                if up.tid == sp.tid:
                    by[up.name]["wait_host_s"] += d

    total = kernels = outside = 0.0
    pageable = set()
    for s, e, name, cat, corr in dev:
        if cat == "gpu_memcpy" and "Pageable" in name:
            pageable.add(corr)
        call = runtime.get(corr)
        if call is None or not w0 <= call[0] < w1:
            if e > w0 and s < w1:
                outside += e - s
                total += e - s
                kernels += (e - s) if cat == "kernel" else 0.0
            continue
        total += e - s
        kernels += (e - s) if cat == "kernel" else 0.0
        sp = owner(call[3], call[0])
        if sp is None:
            outside += e - s
        for up in _chain(sp):
            by[up.name]["device_s"] += e - s
            if cat == "kernel":
                by[up.name]["kernel_s"] += e - s

    busy = _union([(max(s, w0), min(e, w1)) for s, e, _, _, _ in dev
                   if e > w0 and s < w1])
    edges = [w0] + [x for seg in busy for x in seg] + [w1]
    idle = idle_outside = 0.0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            idle += b - a
            idle_outside += _idle_by_span(items_thread, a, b, by)

    blocking, unspanned = collections.Counter(), collections.Counter()
    for corr, (s, e, name, tid) in runtime.items():
        if not w0 <= s < w1:
            continue
        if name in BLOCKING or (name == "cudaMemcpyAsync"
                                and corr in pageable):
            sp = owner(tid, s)
            if sp is None:
                unspanned[name] += 1
            elif not any(up.name.startswith(WAIT) for up in _chain(sp)):
                blocking[(sp.name, name)] += 1

    sec = 1e-6
    for b in by.values():
        for k in ("host_s", "self_host_s", "wait_host_s", "device_s",
                  "kernel_s", "idle_s"):
            b[k] *= sec
    return dict(by_span=dict(by), items=len(marks), device_s=total * sec,
                kernel_s=kernels * sec, idle_s=idle * sec,
                device_outside_s=outside * sec,
                idle_outside_s=idle_outside * sec,
                blocking_outside=[{"span": sp, "call": call, "count": n}
                                  for (sp, call), n in
                                  sorted(blocking.items())],
                blocking_unspanned=[{"call": call, "count": n} for call, n
                                    in sorted(unspanned.items())])


def _idle_by_span(thread, a, b, by) -> float:
    """Puts the idle stretch [a, b) down to the innermost spans open on
    the items' thread over it; returns the part under none."""
    if thread is None:
        return b - a
    i = bisect.bisect_right(thread.edges, a)
    j = bisect.bisect_left(thread.edges, b)
    cuts = [a] + thread.edges[i:j] + [b]
    none = 0.0
    for x, y in zip(cuts, cuts[1:]):
        sp = thread.at(x)
        if sp is None:
            none += y - x
        else:
            by[sp.name]["idle_s"] += y - x
    return none


def per_item_ms(ctx: dict, kind: str, names, field: str):
    """1e3 x the sum of `field` over the spans `names` of the traced
    window, per item: None for another kind of cell or a trace without
    the program's spans (a program without them reads 0 calls)."""
    t = ctx.get("trace")
    if ctx["kind"] != kind or not t or not t.get("spans"):
        return None
    sp = t["spans"]
    if not sp["items"] or not any(n in sp["by_span"] for n in names):
        return None
    return 1e3 * sum(sp["by_span"][n][field] for n in names
                     if n in sp["by_span"]) / sp["items"]


def waits(ctx: dict, kind: str, field: str):
    """The `field` of every ``wait.*`` span, per item (a count for
    ``calls``, else ms); None as `per_item_ms` gives it. A program with
    spans and no wait reads 0."""
    t = ctx.get("trace")
    if ctx["kind"] != kind or not t or not t.get("spans"):
        return None
    sp = t["spans"]
    if not sp["items"] or not sp["by_span"]:
        return None
    total = sum(v[field] for n, v in sp["by_span"].items()
                if n.startswith(WAIT))
    return (total if field == "calls" else 1e3 * total) / sp["items"]
