"""The port's spans (``utils/profiling.py``) on the CPU: host spans and
their ring, device spans switched by the profiler alone, the BatchNorm
epilogues' spans (nothing built outside a profiler, the same arithmetic
inside one), the joint epoch's spans, the collectives' spans, and
``trace_offset_ns`` on synthetic spans and runtime ranges."""

import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
from learning_embeddings_tpu_torch.losses.joint_sampling import (
    build_joint_graph)
from learning_embeddings_tpu_torch.ops import bn
from learning_embeddings_tpu_torch.parallel import mesh as pmesh
from learning_embeddings_tpu_torch.parallel import programs
from learning_embeddings_tpu_torch.train.joint_cnn import (
    JointCNNConfig, JointCNNTrainer)
from learning_embeddings_tpu_torch.utils import profiling

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def empty_ring():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_host_spans_record_name_thread_and_nesting():
    with profiling.span("outer"):
        with profiling.span("inner"):
            pass
    t = threading.Thread(target=lambda: profiling.span("other").__enter__()
                         .__exit__(None, None, None))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    inner, outer, other = profiling.spans()
    assert (inner.name, outer.name, other.name) == ("inner", "outer",
                                                    "other")
    assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= outer.t1_ns
    assert inner.thread == outer.thread == threading.get_ident()
    assert other.thread != outer.thread
    assert inner.events is None and inner.host_ms >= 0
    assert profiling.spans("inner") == [inner]
    assert profiling.spans(since_ns=inner.t0_ns, until_ns=inner.t1_ns) == \
        [inner]
    # no profiler was seen
    assert profiling.profiled_since_ns() is None


def test_ring_keeps_the_newest_records():
    for i in range(profiling.RING + 10):
        with profiling.span(f"s{i}"):
            pass
    got = profiling.spans()
    assert len(got) == profiling.RING
    assert got[0].name == "s10" and got[-1].name == f"s{profiling.RING + 9}"


def test_device_spans_are_switched_by_the_profiler_alone():
    assert not torch.autograd.profiler._is_profiler_enabled
    with profiling.span("before", "cpu"):
        pass
    assert profiling.in_device_span("skipped", "cpu", lambda v: v + 1, 1) == 2
    assert profiling.profiled_since_ns() is None
    with _cpu_profile() as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        with profiling.span("during", "cpu"):
            torch.ones(3).sum()
        assert profiling.in_device_span("inside", "cpu", lambda v: v, 7) == 7
    assert not torch.autograd.profiler._is_profiler_enabled
    names = [r.name for r in profiling.spans()]
    assert names == ["before", "during", "inside"]
    during = profiling.spans("during")[0]
    assert profiling.profiled_since_ns() == during.t0_ns
    # the ranges show in the profile; event pairs only on a card
    ranges = {e.name for e in prof.events()}
    assert {"during", "inside"} <= ranges and "before" not in ranges
    assert all(r.events is None for r in profiling.spans())
    assert profiling.device_ms(during) is None


class _FakeEvent:
    """A timing event on a clock of whole milliseconds; `done` says
    whether the device has reached it."""
    clock = 0
    made = 0

    def __init__(self, enable_timing=False):
        _FakeEvent.made += 1
        self.t, self.done = None, True

    def record(self, stream=None):
        _FakeEvent.clock += 1
        self.t = _FakeEvent.clock

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return float(end.t - self.t)


def test_event_pairs_are_read_then_used_again(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.made = 0
    rec = profiling._Recorder()

    def device_span(index=0, ticks=1, done=True):
        key, (start, end) = rec.take(index)
        start.record()
        _FakeEvent.clock += ticks - 1
        end.record()
        end.done = done
        rec.recorded(key, index, (start, end))
        return key, end

    a, a_end = device_span(ticks=2, done=False)
    b, b_end = device_span(ticks=3, done=False)
    assert _FakeEvent.made == 4 and set(rec.live) == {a, b}
    a_end.done = b_end.done = True
    # none free: both completed pairs are read, and one is used again
    c, c_end = device_span(ticks=4, done=False)
    assert _FakeEvent.made == 4 and len(rec.free[0]) == 1
    assert rec.ms == {a: 2.0, b: 3.0} and set(rec.live) == {c}
    d, _ = device_span(ticks=5)
    assert _FakeEvent.made == 4
    # none free, and c's end not reached: c blocks d, a new pair is made
    device_span()
    assert _FakeEvent.made == 6 and {c, d} <= set(rec.live)
    c_end.done = True
    assert [rec.device_ms(k) for k in (a, b, c, d)] == [2.0, 3.0, 4.0, 5.0]
    # another card's pairs are its own
    device_span(index=1)
    assert _FakeEvent.made == 8
    assert rec.device_ms(12345) is None


def _bn_step(route, x, scale, bias):
    x = x.detach().clone().requires_grad_()
    scale = scale.detach().clone().requires_grad_()
    bias = bias.detach().clone().requires_grad_()
    if route == "fused":
        y, mean, var = bn.batch_norm_train(x, scale, bias)
    else:
        y, mean, var = bn.ghost_batch_norm_train(
            x, scale, bias, stats_rows=2, stats_dtype=torch.bfloat16)
    dy = torch.linspace(-1, 1, y.numel()).view_as(y).to(y.dtype)
    y.backward(dy)
    return [y, mean, var, x.grad, scale.grad, bias.grad]


def _bn_inputs():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 6, 5, 5, generator=g).to(torch.bfloat16).to(
        memory_format=torch.channels_last)
    return x, torch.rand(6, generator=g) + 0.5, torch.randn(6, generator=g)


@pytest.mark.parametrize("route", ["fused", "ghost"])
def test_batch_norm_builds_no_span_off_the_profiler(route, monkeypatch):
    built = []

    class Counted(profiling._Span):
        __slots__ = ()

        def __init__(self, name, device=None):
            built.append(name)
            super().__init__(name, device)

    monkeypatch.setattr(profiling, "_Span", Counted)
    _bn_step(route, *_bn_inputs())
    assert built == [] and profiling.spans() == []
    with _cpu_profile():
        _bn_step(route, *_bn_inputs())
    assert built == ["bn.fwd_epilogue", "bn.bwd_epilogue"]
    assert [r.name for r in profiling.spans()] == built


@pytest.mark.parametrize("route", ["fused", "ghost"])
def test_batch_norm_is_bit_identical_with_spans_on(route):
    off = _bn_step(route, *_bn_inputs())
    with _cpu_profile():
        on = _bn_step(route, *_bn_inputs())
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def _synthetic(seed=0, n=60, offset=987_654_321_123):
    """Anchors (ns) each enclosing three copies (µs, on the trace's
    clock) 0.4-0.9 µs from its ends, every ~0.1 s, with six decoy copies
    around each anchor."""
    rng = np.random.default_rng(seed)
    anchors, ranges, t = [], [], 5e9
    for _ in range(n):
        a0 = t
        r = a0 + rng.uniform(400, 900)
        for _ in range(3):
            d = rng.uniform(2e4, 3e6)
            ranges.append((r / 1e3, (r + d) / 1e3))
            end = r + d
            r = end + rng.uniform(1e3, 5e3)
        anchors.append((int(a0 + offset),
                        int(end + rng.uniform(400, 900) + offset)))
        for _ in range(6):
            d0 = t + rng.uniform(-5e7, 5e7)
            ranges.append((d0 / 1e3, (d0 + rng.uniform(1e3, 1e5)) / 1e3))
        t += rng.uniform(1e8, 1.3e8)
    return anchors, ranges, offset


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trace_offset_recovers_a_known_offset(seed):
    anchors, ranges, offset = _synthetic(seed)
    got = profiling.trace_offset_ns(anchors, ranges)
    assert got is not None
    assert abs(got.ns - offset) <= 1000
    assert got.width_ns <= 2000
    assert (got.matched, got.anchors) == (60, 60)


def test_trace_offset_reads_nothing_below_nine_tenths_matched():
    anchors, ranges, _ = _synthetic()
    # a sixth of the anchors moved past every copy: 50 of 60 can match
    moved = [(a0 + k, a1 + k) for i, (a0, a1) in enumerate(anchors)
             for k in [10**12 * (i + 1) if i % 6 == 0 else 0]]
    assert profiling.trace_offset_ns(moved, ranges) is None
    assert profiling.trace_offset_ns([], ranges) is None
    assert profiling.trace_offset_ns(anchors, []) is None


@pytest.fixture(scope="module")
def joint_setup():
    lm = toy_labelmap(2, 3)
    rng = np.random.RandomState(0)
    paths = lm.leaf_paths()[rng.randint(0, lm.levels[-1], 24)]
    graph, edges = build_joint_graph(lm, paths)
    bank = rng.randint(0, 256, (24, 32, 32, 3)).astype(np.uint8)
    img_edges = edges[edges[:, 1] >= graph.n_labels][::3]
    return lm, graph, img_edges, lambda rows: bank[np.asarray(rows) % 24]


@pytest.mark.parametrize("prefetch", [True, False])
def test_joint_epoch_records_its_spans_once_a_step(joint_setup, prefetch):
    lm, graph, edges, loader = joint_setup
    tr = JointCNNTrainer(lm, graph, edges, loader, JointCNNConfig(
        energy="order", backbone="resnet18", embedding_dim=4, image_size=32,
        batch_size=8, tower_dtype="float32", prefetch=prefetch,
        inflight_steps=2, device="cpu"))
    tr.train_epoch(0, np.random.RandomState(1))
    steps = len(edges) // 8
    count = {n: len(profiling.spans(n)) for n in
             ("joint.launch", "joint.wait_batch", "joint.sample",
              "copy.h2d")}
    # nine copies a step: the pixels, four edge-id and four slot arrays
    assert count == {"joint.launch": steps, "joint.wait_batch": steps,
                     "joint.sample": steps, "copy.h2d": 9 * steps}
    assert {r.name for r in profiling.spans()} == set(count)
    # the sampler runs on the prefetch thread, the launches on this one
    assert {r.thread for r in profiling.spans("joint.launch")} == \
        {threading.get_ident()}
    assert ({r.thread for r in profiling.spans("joint.sample")}
            != {threading.get_ident()}) == prefetch


def test_collectives_are_timed_by_their_spans(tmp_path):
    assert not dist.is_initialized()
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        group = dist.group.WORLD

        def step():
            pmesh.all_reduce_(torch.ones(5), group, "grads")
            pmesh.all_reduce_(torch.ones(2), group, "loss")

        step()        # outside a profiler: host spans alone
        assert [r.name for r in profiling.spans()] == [
            "collective.grads", "collective.loss"]
        step_s, ms = programs._profiled_collectives("cpu", step)
    finally:
        dist.destroy_process_group()
    assert set(ms) == {"grads", "loss"}
    assert all(v >= 0 for v in ms.values())
    assert sum(ms.values()) <= 1e3 * step_s
    assert not hasattr(pmesh, "TIME_COLLECTIVES")
    assert not hasattr(pmesh, "COLLECTIVE_SECONDS")
