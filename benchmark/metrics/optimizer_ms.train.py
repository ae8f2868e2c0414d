"""optimizer_ms.train: device milliseconds a classifier train step of the
optimizer update: the program's device span "classifier.optimizer"
(``train/classifier.py``: Adam's step and the learning-rate schedule's),
timed by its event pair on the compute stream, averaged over the traced
part's steps (one such span each). A program without the span reads
nothing. Layer: model step. Moves train_images_per_s."""

SPAN = "classifier.optimizer"


def read(window, info):
    try:
        from learning_embeddings_tpu_torch.utils.profiling import (
            device_ms, profiled_since_ns, spans)
    except ImportError:
        return None
    since = profiled_since_ns()
    if since is None:
        return None
    ms = [device_ms(r) for r in spans(SPAN, since_ns=since)]
    if not ms or None in ms:
        return None
    return sum(ms) / len(ms)
