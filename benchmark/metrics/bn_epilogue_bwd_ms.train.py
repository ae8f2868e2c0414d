"""bn_epilogue_bwd_ms.train: device milliseconds a classifier train step
of the BatchNorm backward epilogues: the program's device spans
"bn.bwd_epilogue" (``ops/bn.py``: from K2's sums to the returned dx cast,
that is the f32 dx passes and the scale's and bias's gradients), each
timed by its event pair on the compute stream, summed over the traced
part and divided by its steps (its "classifier.optimizer" spans). K2
itself is outside the span. A program without these spans reads nothing.
Layer: ops. Moves train_images_per_s."""

SPAN = "bn.bwd_epilogue"


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
