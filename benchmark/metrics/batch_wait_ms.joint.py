"""batch_wait_ms.joint: host milliseconds a joint step in which the main
thread waits for its next prepared batch (from ``prefetch_one``, or the
batch generator without prefetch): the program's host spans
"joint.wait_batch" (``train/joint_cnn.py::train_epoch``) summed over the
window's untraced part and divided by its steps ("joint.launch" spans).
The untraced part's spans end before the program first saw the profiler
and start no earlier than its length before that. A program without the
spans reads nothing, nor does a run whose trace holds no device
operation (no card: the benchmark's CPU runs). Layer: trainer host path.
Moves joint_edges_per_s."""


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
    since = until - int(untraced_s * 1e9)
    steps = len(spans("joint.launch", since_ns=since, until_ns=until))
    waits = spans("joint.wait_batch", since_ns=since, until_ns=until)
    if not steps or not waits:
        return None
    return sum(r.host_ms for r in waits) / steps
