"""Host → device copies (``train/classifier.py::to_device``) on the CPU:
a CPU destination keeps the plain ``.to()`` in one "copy.h2d" span and
stages nothing; the card path's ring (``utils/staging.py::Arena``) never
hands out bytes that a copy in flight still reads, and grows to a copy
larger than itself. The card path itself runs in
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from learning_embeddings_tpu_torch.train.classifier import to_device
from learning_embeddings_tpu_torch.utils import profiling, staging

_RNG = np.random.RandomState(0)
_IMAGES = _RNG.randint(0, 256, (6, 16, 12, 3)).astype(np.uint8)

#: (array, dtype asked for): the classifier's and the joint's copies
CASES = {
    "uint8_images": (_IMAGES, None),
    "int32_labels_to_int64": (_RNG.randint(0, 50, (6, 4)).astype(np.int32),
                              torch.int64),
    "f32_multihot": ((_RNG.rand(6, 9) < 0.3).astype(np.float32),
                     torch.float32),
    "height_split_view": (_IMAGES[:, 8:], None),
    "ragged_rows": (_RNG.randint(0, 256, (38, 4, 4, 3)).astype(np.uint8),
                    None),
    "f64_to_f32": (_RNG.randn(5, 3), torch.float32),
    "scalar": (np.int64(7), None),
    "empty": (np.zeros((0, 3), np.int64), None),
}


@pytest.fixture(autouse=True)
def empty_ring():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@pytest.mark.parametrize("case", sorted(CASES))
def test_to_device_on_the_cpu_is_the_plain_copy(case):
    a, dtype = CASES[case]
    before = profiling.counts()
    got = to_device(a, "cpu", dtype)
    plain = torch.as_tensor(a)
    want = plain.to("cpu", dtype=dtype or plain.dtype, non_blocking=True)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.stride() == want.stride()
    if isinstance(a, np.ndarray) and got.dtype == plain.dtype \
            and got.numel():
        # no conversion: the plain .to() hands back the array's own memory
        assert got.data_ptr() == plain.data_ptr()
    assert torch.equal(got, want)
    now = profiling.counts()
    assert now["copy_pinned"] == before["copy_pinned"]
    assert now["copy_pinned_wait"] == before["copy_pinned_wait"]
    assert [r.name for r in profiling.spans()] == ["copy.h2d"]


class _Stream:
    """A copy stream's events, which complete in the order recorded."""

    def __init__(self):
        self.events = []

    def event(self):
        ev = _Event(self)
        self.events.append(ev)
        return ev


class _Event:
    def __init__(self, stream):
        self.stream, self.done, self.waited = stream, False, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = True
        for ev in self.stream.events[:self.stream.events.index(self) + 1]:
            ev.done = True


def test_arena_waits_only_for_bytes_still_read():
    size = 4096
    arena = staging.Arena(size)
    before = profiling.counts()["copy_pinned_wait"]
    stream, held = _Stream(), []
    # three reservations fill the ring in order, aligned
    for n in (1000, 1000, 1500):
        start = arena.reserve(n)
        held.append((start, start + n, stream.event()))
        arena.hold(start, n, held[-1][2])
    assert [h[0] for h in held] == [0, 1024, 2048]
    # the next one wraps to 0 and overlaps the first, still in flight:
    # waited for and counted, the others kept
    assert arena.reserve(600) == 0
    assert held[0][2].waited and not held[1][2].waited
    assert profiling.counts()["copy_pinned_wait"] == before + 1
    arena.hold(0, 600, stream.event())
    # overlapping the second, already done: no wait
    held[1][2].done = True
    assert arena.reserve(900) == 768
    assert not held[1][2].waited
    assert profiling.counts()["copy_pinned_wait"] == before + 1
    # every reservation in flight lies clear of every other
    spans = [(s, e) for s, e, _ in arena.inflight]
    assert spans == [(2048, 3548), (0, 600)]


def test_arena_never_hands_out_bytes_in_flight():
    """Random sizes through a small ring: a reservation overlaps no
    reservation whose event has not completed."""
    rng = np.random.RandomState(1)
    arena = staging.Arena(10_000)
    stream, live = _Stream(), []
    for _ in range(500):
        n = int(rng.randint(1, 4000))
        start = arena.reserve(n)
        assert 0 <= start and start + n <= arena.size
        for s, e, ev in live:
            assert ev.done or not (s < start + n and start < e)
        ev = stream.event()
        arena.hold(start, n, ev)
        live = [x for x in live if not x[2].done] + [(start, start + n, ev)]
        # the copy stream finishes its oldest copies now and then, in order
        k = int(rng.randint(0, 3))
        if k:
            live[min(k, len(live)) - 1][2].synchronize()


def test_arena_grows_to_a_copy_larger_than_itself():
    """A copy larger than the ring waits for every copy in flight, then
    the ring holds two of it; copies that fit start at its head."""
    arena = staging.Arena(1024)
    stream = _Stream()
    before = profiling.counts()["copy_pinned_wait"]
    arena.hold(arena.reserve(300), 300, stream.event())
    arena.hold(arena.reserve(300), 300, stream.event())
    assert arena.reserve(5000) == 0
    assert arena.size == 10_000 and not arena.inflight
    assert all(ev.done for ev in stream.events)
    assert profiling.counts()["copy_pinned_wait"] == before + 1
    arena.hold(0, 5000, stream.event())
    assert arena.reserve(4000) == 5120
    # all done already: growing waits for nothing
    stream.events[-1].done = True
    assert arena.reserve(30_000) == 0 and arena.size == 60_000
    assert profiling.counts()["copy_pinned_wait"] == before + 1
