"""Profiling on ``torch.profiler``: the port of
``learning_embeddings_tpu/utils/profiling.py``, and the spans the port
records about itself.

``trace_steps`` runs a step callable under the profiler and writes a
chrome trace; ``summarize_trace`` sums that trace's device time by op
class. Only device activity counts (CUDA kernels, memcpys and memsets):
host ranges and annotations such as ``Optimizer.step#Adam.step`` span
kernels that are counted on their own, so they are left out. A CPU run
has no device activity, and its summary is empty.

Spans. ``span(name)`` is a host span: its name, thread and
``time.perf_counter_ns()`` at entry and exit go into a bounded ring (the
newest ``RING`` records), at the cost of two clock reads, one flag read
and one append. ``span(name, device)`` is a device span: a host span
that, only while a ``torch.profiler`` records, also opens a profiler
range (so that it shows in ``trace_steps``'s chrome trace) and, on a CUDA
device, records a pair of timing events on the device's current stream.
The pairs are used again: once a pair's end has completed, its reading
is kept and the pair goes back to a pool, so a profiled run makes about
as many pairs as it has device spans in flight. ``in_device_span`` runs
a function in a device span while a profiler records and records nothing
otherwise, at the cost of one flag read (the hot paths: the BatchNorm
epilogues). ``traced_op`` does the same for an op with a backward: its
forward in one device span, and its backward, from the node after its
output to the node before its inputs, in another (``ops/attention.py``,
``models/swin.py``). The profiler being on is the only switch.

Readers: ``spans`` (records by name and time), ``device_ms`` (a record's
event-timed milliseconds, read after a synchronise),
``profiled_since_ns`` (when a span first saw a profiler on: it separates
a run's untraced part from its traced part) and ``trace_offset_ns``
(puts the spans on a profiler trace's clock).

Counters, always on. ``count(name)`` adds to the counter `name`: the
kernel wrappers count their launches, ``ops/bn.py`` its channels_last
copies, ``parallel/mesh.py`` its collectives ("collective_<tag>").
``counts()`` reads them all, ``reset_counts()`` zeroes them.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import re
import threading
import time
from typing import Callable, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["trace_steps", "summarize_trace", "TRACE_FILE", "span",
           "in_device_span", "traced_op", "spans", "device_ms",
           "profiled_since_ns", "trace_offset_ns", "clear_spans",
           "SpanRecord", "Offset", "RING", "count", "counts",
           "reset_counts"]

TRACE_FILE = "trace.json"

#: chrome-trace categories of device activity
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_steps(step_fn: Callable, n_steps: int, trace_dir: str,
                device="cuda", sync: Callable = None) -> str:
    """Run `step_fn()` `n_steps` times under the profiler (CPU activity,
    and CUDA activity when `device` is a card); writes
    `trace_dir`/trace.json and returns `trace_dir`. `sync(out)` forces
    the last output; by default the card is synchronised."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        out = None
        for _ in range(n_steps):
            out = step_fn()
        if sync is not None:
            sync(out)
        elif on_card:
            torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
    return trace_dir


def summarize_trace(trace_dir: str, n_steps: int = 1,
                    top_k: int = 20) -> List[Tuple[str, float, float]]:
    """[(op class, device ms per step, share of the device time)], the
    largest first; an op class is a kernel name without trailing
    digits and dots."""
    with open(os.path.join(trace_dir, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    cat = collections.Counter()
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
                and e.get("dur")):
            cat[re.sub(r"[.\d]+$", "", e["name"])] += float(e["dur"])
    total = sum(cat.values()) or 1.0
    return [(name, us / n_steps / 1e3, us / total)
            for name, us in cat.most_common(top_k)]


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

#: span records the ring keeps: more than a 51-s benchmark run of any cell
#: makes; also the number of device readings kept
RING = 1 << 16

#: the profiler range of a device span: a C++ range, a fraction of
#: ``torch.profiler.record_function``'s cost
_Range = torch._C._profiler._RecordFunctionFast


class SpanRecord(NamedTuple):
    """One span: its name, the thread that ran it, its host interval on
    ``time.perf_counter_ns()`` and the key of its device reading (None for
    a host span, or a device span off the card or outside a profiler)."""
    name: str
    thread: int
    t0_ns: int
    t1_ns: int
    events: Optional[int]

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6


class _Recorder:
    """The ring of span records (plain tuples, made `SpanRecord`s when
    read) and the device spans' event pairs: those recorded and not yet
    read (`live`, and in the order recorded `pending`), the readings
    (`ms`, the newest `RING`), and the pairs free to use again, by
    device."""

    def __init__(self):
        self.records: collections.deque = collections.deque(maxlen=RING)
        #: perf_counter_ns at which a span first saw a profiler on
        self.profiled_ns: Optional[int] = None
        self.keys = itertools.count()
        self.lock = threading.Lock()
        self.free = collections.defaultdict(list)
        self.pending: collections.deque = collections.deque()
        self.live, self.ms = {}, {}

    def take(self, index: int):
        """(key, event pair) for a device span on card `index`: a free
        pair, after reading every pending pair whose end has completed
        when none is free, or a new one."""
        with self.lock:
            free = self.free[index]
            if not free:
                while self.pending and self.pending[0][2][1].query():
                    key, i, pair = self.pending.popleft()
                    self.ms[key] = pair[0].elapsed_time(pair[1])
                    if len(self.ms) > RING:
                        del self.ms[next(iter(self.ms))]
                    del self.live[key]
                    self.free[i].append(pair)
            pair = free.pop() if free else None
            key = next(self.keys)
        if pair is None:
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
        return key, pair

    def recorded(self, key: int, index: int, pair) -> None:
        with self.lock:
            self.live[key] = pair
            self.pending.append((key, index, pair))

    def device_ms(self, key: int) -> Optional[float]:
        with self.lock:
            if key in self.ms:
                return self.ms[key]
            pair = self.live.get(key)
            return None if pair is None else pair[0].elapsed_time(pair[1])


_RECORDER = _Recorder()


class _Span:
    __slots__ = ("name", "device", "t0", "range", "key", "index", "pair",
                 "stream")

    def __init__(self, name: str, device=None):
        self.name, self.device = name, device
        self.range = self.key = self.pair = None

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        if _autograd_profiler._is_profiler_enabled:
            if _RECORDER.profiled_ns is None:
                _RECORDER.profiled_ns = self.t0
            if self.device is not None:
                self.range = _Range(self.name)
                self.range.__enter__()
                dev = torch.device(self.device)
                if dev.type == "cuda":
                    self.index = (dev.index if dev.index is not None
                                  else torch.cuda.current_device())
                    self.stream = torch.cuda.current_stream(self.index)
                    self.key, self.pair = _RECORDER.take(self.index)
                    self.pair[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.pair is not None:
            self.pair[1].record(self.stream)
            _RECORDER.recorded(self.key, self.index, self.pair)
        if self.range is not None:
            self.range.__exit__(*exc)
        _RECORDER.records.append((self.name, threading.get_ident(), self.t0,
                                  time.perf_counter_ns(), self.key))
        return False


def span(name: str, device=None) -> _Span:
    """A context manager that records the span `name`: a host span, or
    with `device` (a ``torch.device`` or its name) a device span, whose
    range and event pair are recorded while a profiler records."""
    return _Span(name, device)


def in_device_span(name: str, device, fn: Callable, *args):
    """`fn(*args)` inside the device span `name` while a profiler records;
    otherwise `fn(*args)` alone: no span is built and nothing recorded."""
    if not _autograd_profiler._is_profiler_enabled:
        return fn(*args)
    with _Span(name, device):
        return fn(*args)


class _Box:
    """The backward span of one ``traced_op`` call, open between its two
    nodes."""
    __slots__ = ("span",)

    def __init__(self):
        self.span = None


class _BackwardStarts(torch.autograd.Function):
    """Identity on the output; its backward counts the op's counters and,
    under a profiler, opens the op's backward span."""

    @staticmethod
    def forward(ctx, out, box, name, counters):
        ctx.box, ctx.name, ctx.counters = box, name, counters
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        for c in ctx.counters:
            count(c)
        if _autograd_profiler._is_profiler_enabled:
            ctx.box.span = span(ctx.name, g.device)
            ctx.box.span.__enter__()
        return g, None, None, None


class _BackwardEnds(torch.autograd.Function):
    """Identity on the inputs that take a gradient; its backward closes
    the span that ``_BackwardStarts`` opened."""

    @staticmethod
    def forward(ctx, box, *inputs):
        ctx.box = box
        return tuple(t.view_as(t) for t in inputs)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.box.span is not None:
            ctx.box.span.__exit__(None, None, None)
            ctx.box.span = None
        return (None,) + grads


def traced_op(fwd_name: str, bwd_name: str, counters: Tuple[str, ...],
              fn: Callable, *inputs):
    """`fn(*inputs)` in the device span `fwd_name` (``in_device_span``),
    each of `counters` counted once. Where a gradient flows to any of the
    tensor `inputs` (None is passed on as it is), the backward counts
    `counters` again and, while a profiler records, runs in the device
    span `bwd_name`: it opens in an autograd node after the output and
    closes in the one before the inputs that take a gradient, so it
    encloses the backward of `fn`'s own nodes. Inputs other than tensors
    (None, sizes) are passed on as they are; the output is a tensor."""
    device = next(t.device for t in inputs if isinstance(t, torch.Tensor))
    box = None
    grad = [i for i, t in enumerate(inputs)
            if isinstance(t, torch.Tensor) and t.requires_grad] \
        if torch.is_grad_enabled() else []
    if grad:
        box = _Box()
        inputs = list(inputs)
        for i, t in zip(grad, _BackwardEnds.apply(
                box, *(inputs[i] for i in grad))):
            inputs[i] = t
    for c in counters:
        count(c)
    out = in_device_span(fwd_name, device, fn, *inputs)
    return _BackwardStarts.apply(out, box, bwd_name, counters) if grad \
        else out


def spans(name: Optional[str] = None, since_ns: Optional[int] = None,
          until_ns: Optional[int] = None) -> List[SpanRecord]:
    """The records in the ring, oldest first: those named `name` (all for
    None) that start at or after `since_ns` and end at or before
    `until_ns`."""
    out = []
    for r in list(_RECORDER.records):
        if ((name is None or r[0] == name)
                and (since_ns is None or r[2] >= since_ns)
                and (until_ns is None or r[3] <= until_ns)):
            out.append(SpanRecord._make(r))
    return out


def device_ms(record: SpanRecord) -> Optional[float]:
    """The device milliseconds between the two events of `record` on its
    stream, or None where it has no event pair. Both events must have
    completed: read after a synchronise."""
    if record.events is None:
        return None
    return _RECORDER.device_ms(record.events)


def profiled_since_ns() -> Optional[int]:
    """``time.perf_counter_ns()`` at which a span first saw a profiler
    recording (None if none has): spans that end before it ran untraced."""
    return _RECORDER.profiled_ns


def clear_spans() -> None:
    """Empties the ring and its readings, and forgets when a profiler was
    seen (the event pairs stay)."""
    _RECORDER.records.clear()
    _RECORDER.ms.clear()
    _RECORDER.profiled_ns = None


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

_COUNTS: collections.Counter = collections.Counter()
#: a count is a read and a write: threads (the joint step's two) share it
_COUNTS_LOCK = threading.Lock()


def count(name: str, n: int = 1) -> None:
    """Adds `n` to the counter `name`."""
    with _COUNTS_LOCK:
        _COUNTS[name] += n


def counts() -> collections.Counter:
    """A copy of every counter since the process started or the last
    ``reset_counts``: a name not counted yet reads 0."""
    with _COUNTS_LOCK:
        return collections.Counter(_COUNTS)


def reset_counts() -> None:
    """Sets every counter to 0."""
    with _COUNTS_LOCK:
        _COUNTS.clear()


# ---------------------------------------------------------------------------
# the spans on a profiler trace's clock
# ---------------------------------------------------------------------------

class Offset(NamedTuple):
    """Span time − trace time, in ns: a span at `t` ns lies at
    (t − ns) / 1000 µs of the trace. `width_ns` is the interval of offsets
    every matched pair allows (`ns` is its middle); `matched` of the
    `anchors` enclose a range there."""
    ns: int
    width_ns: float
    matched: int
    anchors: int


def trace_offset_ns(anchor_spans: Iterable[Tuple[int, int]],
                    runtime_ranges: Iterable[Tuple[float, float]],
                    min_share: float = 0.9) -> Optional[Offset]:
    """The offset between the spans' clock and a trace's.

    `anchor_spans` are host spans (t0_ns, t1_ns) on
    ``time.perf_counter_ns()`` each of which encloses at least one of the
    runtime calls `runtime_ranges` (start_us, end_us, on the trace's
    clock), such as the program's own host-to-device ``cudaMemcpyAsync``
    calls. A pair (anchor, range) allows the offsets [a0 − r0, a1 − r1].
    The offset is the one under which the most anchors enclose a range
    and, among those, the enclosed ranges last longest in all (an
    anchor's own copies fill it; other threads' and other calls' copies
    are short); it is narrowed to the interval every enclosed pair
    allows. None when under `min_share` of the anchors match, or when two
    separate intervals tie."""
    a = np.asarray(list(anchor_spans), np.float64).reshape(-1, 2)
    r = np.asarray(list(runtime_ranges), np.float64).reshape(-1, 2) * 1e3
    if not len(a) or not len(r):
        return None
    # sweep the pairs' intervals: a start enters a pair, a point past an
    # end leaves it
    points, weights, owners = [], [], []
    for i, (a0, a1) in enumerate(a):
        lo, hi = a0 - r[:, 0], a1 - r[:, 1]
        ok = hi >= lo
        w = (r[ok, 1] - r[ok, 0]) + 1.0        # ns; every pair counts
        points += [lo[ok], hi[ok]]
        weights += [w, -w]
        owners += [np.full(len(w), i), np.full(len(w), i)]
    points, weights = np.concatenate(points), np.concatenate(weights)
    owners = np.concatenate(owners)
    order = np.lexsort((weights < 0, points))       # starts before ends
    active = np.zeros(len(a), np.int64)
    n_anchors, covered = 0, 0.0
    best, regions, start = (0, 0.0), [], None
    for j in order:
        x, i, w = points[j], owners[j], weights[j]
        if w > 0:
            n_anchors += active[i] == 0
            active[i] += 1
            covered += w
            if (n_anchors, covered) > best:
                best, regions = (n_anchors, covered), []
            if (n_anchors, covered) == best:
                start = x
        else:
            if (n_anchors, covered) == best and start is not None:
                regions.append((start, x))
                start = None
            active[i] -= 1
            n_anchors -= active[i] == 0
            covered += w
    if best[0] < min_share * len(a) or len(regions) != 1:
        return None
    lo, hi = regions[0]
    return Offset(int(round(0.5 * (lo + hi))), float(hi - lo), int(best[0]),
                  len(a))
