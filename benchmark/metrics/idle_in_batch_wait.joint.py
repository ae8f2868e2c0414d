"""idle_in_batch_wait.joint: the share of the traced epoch's device-idle
time (the gaps between the union of the profiled device operations) that
falls inside the main thread's waits for its next batch (the program's
host spans "joint.wait_batch"). The spans are put on the trace's clock by
``utils/profiling.py::trace_offset_ns``: each host-to-device copy of the
program runs in a "copy.h2d" span, which encloses its
``cudaMemcpyAsync`` call, a host range of the trace. Where that alignment
fails (under 90% of the anchors matched), or the program has no such
spans, it reads nothing. Layer: trainer host path. Moves joint_edges_per_s."""

import sys

import numpy as np

ANCHOR, WAIT, COPY = "copy.h2d", "joint.wait_batch", "cudaMemcpyAsync"


def idle_gaps_us(ops):
    """(starts, ends) of the gaps between the union of `ops` (name,
    start_us, end_us), sorted by start."""
    s = np.array([o[1] for o in ops])
    e = np.maximum.accumulate(np.array([o[2] for o in ops]))
    gap = s[1:] > e[:-1]
    return e[:-1][gap], s[1:][gap]


def read(window, info):
    try:
        from learning_embeddings_tpu_torch.utils.profiling import (
            profiled_since_ns, spans, trace_offset_ns)
    except ImportError:
        return None
    since = profiled_since_ns()
    if since is None or len(window.ops) < 2:
        return None
    anchors = [(r.t0_ns, r.t1_ns) for r in spans(ANCHOR, since_ns=since)]
    copies = [(s, e) for n, s, e in window.host if n == COPY]
    off = trace_offset_ns(anchors, copies)
    print(f"[spans] {ANCHOR} on the trace: {off} ({len(anchors)} anchors, "
          f"{len(copies)} {COPY} ranges)", file=sys.stderr, flush=True)
    gs, ge = idle_gaps_us(window.ops)
    if off is None or not len(gs):
        return None
    inside = 0.0
    for r in spans(WAIT, since_ns=since):
        a, b = (r.t0_ns - off.ns) / 1e3, (r.t1_ns - off.ns) / 1e3
        inside += np.clip(np.minimum(ge, b) - np.maximum(gs, a), 0, None).sum()
    return 100.0 * inside / (ge - gs).sum()
