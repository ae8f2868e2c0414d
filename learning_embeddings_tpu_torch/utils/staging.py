"""Host → card copies through pinned memory: the CUDA path of
``train/classifier.py::to_device``.

A copy from pageable host memory (a numpy batch) does not overlap the
card's work: CUDA stages it through buffers of its own behind
what is already queued on the stream, so the host waits for the card to
drain and then for the copy itself. Here each card has a ring of pinned
host memory (at least `RING_BYTES`) and a copy stream of its own. A copy
fills a region of the ring with torch's parallel CPU copy (which also
converts the dtype and gathers any strides) and makes one
``cudaMemcpyAsync`` from it on the copy stream; the stream current on
the calling thread then waits on the copy's event (``wait_event``). The
host waits for neither.

The whole array is one fill and one DMA. Pieces of 8 or 32 MiB, each
DMA started as soon as its piece was filled, finished the copy alone a
little sooner but returned to the caller later, so the eval pass
launched its forward later and scored 2-11% fewer images a second on an
H100; the train step read the same (PERF.md §6).

What keeps it safe:

* the ring: bytes of the ring are filled again only after the event
  recorded behind the DMA that last read them has completed. One card's
  DMAs run in order on its copy stream, so waiting for the newest copy
  that a reservation overlaps covers every older one. Each wait counts
  "copy_pinned_wait" (``utils/profiling.py::count``): a ring too small
  for the caller's pace. A copy larger than the ring replaces it by one
  twice its size, once every DMA from the old one is done.
* the device tensor: allocated while the copy stream is current, and
  marked with ``record_stream`` for the consuming stream, so that the
  caching allocator hands its block to no later allocation (the next
  copy's included) before the work queued on the consumer up to the
  tensor's release has completed.

Nothing is kept by the caller's array: every call copies what it is
given, and has read all of it when it returns. Spans: "copy.stage"
around the fill, "copy.h2d" around the ``cudaMemcpyAsync`` (the anchors
of ``utils/profiling.py::trace_offset_ns``); the counter "copy_pinned"
counts the staged copies.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, Tuple

import torch

from . import profiling

__all__ = ["to_cuda", "Arena", "RING_BYTES"]

#: pinned host bytes of one card's ring, at least: three batches of
#: 128 × 448² × 3 uint8 and their labels
RING_BYTES = 256 << 20
#: a copy's start in the ring, in bytes (any dtype's alignment)
_ALIGN = 256


class Arena:
    """Reservations in a ring of `size` bytes, each held until its event
    (anything with ``query()`` and ``synchronize()``) has completed. The
    events complete in the order they were added (one stream's)."""

    def __init__(self, size: int):
        self.size = size
        self.head = 0
        #: (start, end, event) of the reservations in flight, oldest first
        self.inflight: collections.deque = collections.deque()

    def reserve(self, n: int) -> int:
        """The start of `n` bytes that no DMA in flight reads: after the
        newest overlapping reservation's event, waited for and counted as
        "copy_pinned_wait" where it has not completed. Where `n` exceeds
        the ring, the ring becomes `2n` bytes (the caller's buffer must
        follow `size`) once every reservation is done."""
        if n > self.size:
            self._release(len(self.inflight) - 1)
            self.size, self.head = 2 * n, 0
        start = self.head if self.head + n <= self.size else 0
        end = start + n
        self.head = -(-end // _ALIGN) * _ALIGN
        last = -1
        for i, (s, e, _) in enumerate(self.inflight):
            if s < end and start < e:
                last = i
        self._release(last)
        return start

    def hold(self, start: int, n: int, event) -> None:
        """Keeps [start, start + n) until `event` has completed."""
        self.inflight.append((start, start + n, event))

    def _release(self, last: int) -> None:
        """Frees the reservations up to the `last`-th (none for -1),
        waiting for its event."""
        if last < 0:
            return
        event = self.inflight[last][2]
        if not event.query():
            profiling.count("copy_pinned_wait")
            event.synchronize()
        for _ in range(last + 1):
            self.inflight.popleft()


class _Ring:
    """One card's pinned ring, its copy stream and its lock (the joint's
    prefetch thread copies beside the main thread)."""

    def __init__(self, device: torch.device):
        self.arena = Arena(RING_BYTES)
        self.buf = self._pinned()
        self.stream = torch.cuda.Stream(device)
        self.lock = threading.Lock()

    def _pinned(self) -> torch.Tensor:
        return torch.empty(self.arena.size, dtype=torch.uint8,
                           pin_memory=True)

    def reserve(self, n: int) -> Tuple[torch.Tensor, int]:
        """`n` bytes of the ring (``Arena.reserve``), and their start."""
        start = self.arena.reserve(n)
        if self.arena.size != self.buf.numel():
            self.buf = self._pinned()
        return self.buf[start:start + n], start


_RINGS: Dict[int, _Ring] = {}
_RINGS_LOCK = threading.Lock()


def _ring(device: torch.device) -> _Ring:
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    with _RINGS_LOCK:
        ring = _RINGS.get(index)
        if ring is None:
            ring = _RINGS[index] = _Ring(torch.device("cuda", index))
    return ring


def to_cuda(t: torch.Tensor, device: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    """The host tensor `t` as a new contiguous tensor of `dtype` on the
    card `device`, copied through the card's pinned ring on its copy
    stream; the calling thread's current stream is ordered after the
    copy. Returns without waiting for it."""
    ring = _ring(device)
    consumer = torch.cuda.current_stream(device)
    n = t.numel() * dtype.itemsize
    with ring.lock, torch.cuda.stream(ring.stream):
        out = torch.empty(t.shape, dtype=dtype, device=device)
        if n:
            region, start = ring.reserve(n)
            staged = region.view(dtype).view(t.shape)
            with profiling.span("copy.stage"):
                staged.copy_(t)
            with profiling.span("copy.h2d"):
                out.copy_(staged, non_blocking=True)
            event = torch.cuda.Event()
            event.record(ring.stream)
            ring.arena.hold(start, n, event)
            consumer.wait_event(event)
            out.record_stream(consumer)
    profiling.count("copy_pinned")
    return out
