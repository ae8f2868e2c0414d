"""attention_ms.vit: device milliseconds a ViT train step of the
attention, forward and backward: the program's device spans
"attention.fwd" and "attention.bwd" (``ops/attention.py``: the fused
attention call, and its backward node), each timed by its event pair on
the compute stream, summed over the traced part and divided by its steps
(its "classifier.optimizer" spans). A program without these spans reads
nothing. Layer: ops. Moves train_images_per_s."""

SPANS = ("attention.fwd", "attention.bwd")


def step_ms(names=SPANS):
    """Device ms a traced step of the spans `names`, or None."""
    try:
        from learning_embeddings_tpu_torch.utils.profiling import (
            device_ms, profiled_since_ns, spans)
    except ImportError:
        return None
    since = profiled_since_ns()
    if since is None:
        return None
    steps = len(spans("classifier.optimizer", since_ns=since))
    ms = [device_ms(r) for n in names for r in spans(n, since_ns=since)]
    if not steps or not ms or None in ms:
        return None
    return sum(ms) / steps


def read(window, info):
    return step_ms()
