"""CPU checks of the readers of the program's spans: each runs on a
synthetic Window and a span ring filled by hand, reads the number it
should, and reads nothing where the run gives it nothing to read."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(BENCH))

from benchmark.lib import harness  # noqa: E402
from benchmark.lib.trace import Window  # noqa: E402
from learning_embeddings_tpu_torch.utils import profiling  # noqa: E402

S = 10**9   # ns a second
#: the profiler first seen at 100 s; the untraced part is the 10 s before
SEEN, UNTRACED_S = 100 * S, 10.0
INFO = {"host": {"window_s": UNTRACED_S}}
BUSY = Window([("k", 0.0, 1.0)], [], 1.0)


@pytest.fixture
def ring(monkeypatch):
    """Fills the program's ring: ring(name, t0_s, t1_s, device_ms=None)."""
    profiling.clear_spans()
    ms = {}
    monkeypatch.setattr(profiling, "device_ms", lambda r: ms.get(r.events))

    def add(name, t0, t1, device=None, thread=1):
        key = None
        if device is not None:
            key = (0, len(ms))
            ms[key] = device
        profiling._RECORDER.records.append(
            (name, thread, int(t0 * S), int(t1 * S), key))
    yield add
    profiling.clear_spans()


def _read(name, window=BUSY, info=INFO):
    return harness.metric(name).read(window, info)


NEW = ["bn_epilogue_fwd_ms.train", "bn_epilogue_bwd_ms.train",
       "optimizer_ms.train", "sampler_ms.joint", "launch_ms.joint",
       "batch_wait_ms.joint", "idle_in_batch_wait.joint"]


@pytest.mark.parametrize("name", NEW)
def test_no_spans_read_nothing(ring, name):
    assert _read(name) is None
    profiling._RECORDER.profiled_ns = SEEN
    assert _read(name) is None


def _train_steps(ring):
    profiling._RECORDER.profiled_ns = SEEN
    # an untraced step (no event pair) and two traced ones
    ring("classifier.optimizer", 95, 95.1)
    ring("bn.fwd_epilogue", 94.9, 94.95)
    for t, opt in ((100, 1.5), (101, 2.5)):
        for k in range(3):
            ring("bn.fwd_epilogue", t + 0.01 * k, t + 0.01 * k + 0.005, 1.0)
            ring("bn.bwd_epilogue", t + 0.5 + 0.01 * k,
                 t + 0.5 + 0.01 * k + 0.005, 4.0)
        ring("classifier.optimizer", t + 0.8, t + 0.9, opt)


@pytest.mark.parametrize("name,expected", [
    ("bn_epilogue_fwd_ms.train", 3.0), ("bn_epilogue_bwd_ms.train", 12.0),
    ("optimizer_ms.train", 2.0)])
def test_train_readers_sum_event_time_a_step(ring, name, expected):
    _train_steps(ring)
    assert _read(name) == pytest.approx(expected)


def test_train_readers_read_nothing_without_event_pairs(ring):
    profiling._RECORDER.profiled_ns = SEEN
    ring("classifier.optimizer", 100, 100.1)
    ring("bn.fwd_epilogue", 100, 100.01)
    for name in NEW[:3]:
        assert _read(name) is None


def _joint_steps(ring):
    profiling._RECORDER.profiled_ns = SEEN
    # set-up, before the untraced part: left out
    ring("joint.sample", 80, 85, thread=2)
    ring("joint.launch", 80, 85)
    for t in (91, 93, 95, 97):             # four untraced steps
        ring("joint.sample", t, t + 0.02, thread=2)
        ring("joint.wait_batch", t, t + 0.01)
        ring("joint.launch", t + 0.01, t + 0.11)
    ring("joint.sample", 100.5, 100.6, thread=2)   # traced: left out
    ring("joint.launch", 100.5, 100.9)


@pytest.mark.parametrize("name,expected", [
    ("sampler_ms.joint", 20.0), ("launch_ms.joint", 100.0),
    ("batch_wait_ms.joint", 10.0)])
def test_joint_host_readers_read_the_untraced_part(ring, name, expected):
    _joint_steps(ring)
    assert _read(name) == pytest.approx(expected)
    # a run whose trace holds no device operation reads nothing
    assert _read(name, window=Window([], [], 1.0)) is None


def _aligned_run(ring, offset_s=42.0):
    """A traced part at 100 s: eight copy spans, two every 0.1 s, each
    around its copy, which lies `offset_s` earlier on the trace's clock
    (µs from its zero: span second s is trace µs (s − offset_s)·1e6);
    device ops with gaps [10, 20] and [40, 60] ms; one wait over [15, 45]
    ms."""
    profiling._RECORDER.profiled_ns = SEEN
    copies, base = [], (100 - offset_s) * 1e6
    for k in range(4):
        t = 100 + 0.1 * k
        for j in range(2):
            ring("copy.h2d", t + 0.001 * j, t + 0.001 * j + 0.0007, thread=2)
            s = base + 1e5 * k + 1e3 * j + 100
            copies.append(("cudaMemcpyAsync", s, s + 500))
    copies.append(("cudaMemcpyAsync", base - 7e4, base - 6.9e4))   # decoy
    ring("joint.wait_batch", 100.015, 100.045)
    ops = [("k", base, base + 1e4), ("k", base + 2e4, base + 4e4),
           ("k", base + 6e4, base + 4e5)]
    return Window(ops, copies + [("cudaLaunchKernel", base, base + 5)], 1.0)


def test_idle_in_batch_wait_reads_the_aligned_share(ring):
    window = _aligned_run(ring)
    # of 30 ms of gaps the wait covers [15, 20] and [40, 45]: 10 ms
    assert _read("idle_in_batch_wait.joint", window) == pytest.approx(
        100 / 3, rel=1e-6)


def test_idle_in_batch_wait_reads_nothing_unaligned(ring):
    window = _aligned_run(ring)
    # the copies gone from the trace: no anchor encloses one
    window.host = [h for h in window.host if h[0] != "cudaMemcpyAsync"]
    assert _read("idle_in_batch_wait.joint", window) is None
