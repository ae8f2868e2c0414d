"""bn_epilogue_fwd_ms.train: device milliseconds a classifier train step
of the BatchNorm forward epilogues: the program's device spans
"bn.fwd_epilogue" (``ops/bn.py``: from K1's sums to y, that is the
statistics, the fold into a and b and the addcmul), each timed by its
event pair on the compute stream, summed over the traced part and divided
by its steps (its "classifier.optimizer" spans). K1 itself is outside the
span. An event pair times the stream, not the kernels: where the host
launches the epilogue's short kernels late, the stream's wait is inside
the span. A program without these spans reads nothing. Layer: ops. Moves
train_images_per_s."""

SPAN = "bn.fwd_epilogue"


def read(window, info):
    try:
        from learning_embeddings_tpu_torch.utils.profiling import (
            device_ms, profiled_since_ns, spans)
    except ImportError:
        return None
    since = profiled_since_ns()
    if since is None:
        return None
    steps = len(spans("classifier.optimizer", since_ns=since))
    ms = [device_ms(r) for r in spans(SPAN, since_ns=since)]
    if not steps or not ms or None in ms:
        return None
    return sum(ms) / steps
