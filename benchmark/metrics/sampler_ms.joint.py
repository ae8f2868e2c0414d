"""sampler_ms.joint: the mean host milliseconds of the joint step's
negative sampler (``sample_joint_negatives_np`` on the prefetch thread),
read from the program's host spans "joint.sample"
(``train/joint_cnn.py::prepare_batch``) over the window's untraced part:
the spans that end before the program first saw the profiler and start
no earlier than the untraced part's length before that. A program
without the span reads nothing, nor does a run whose trace holds no
device operation (no card: the benchmark's CPU runs). Layer: trainer
host path. Moves joint_edges_per_s."""

SPAN = "joint.sample"


def read(window, info):
    try:
        from learning_embeddings_tpu_torch.utils.profiling import (
            profiled_since_ns, spans)
    except ImportError:
        return None
    until = profiled_since_ns()
    untraced_s = info.get("host", {}).get("window_s")
    if until is None or not untraced_s or not window.ops:
        return None
    got = spans(SPAN, since_ns=until - int(untraced_s * 1e9), until_ns=until)
    if not got:
        return None
    return sum(r.host_ms for r in got) / len(got)
