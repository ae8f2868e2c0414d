"""Host input pipeline: the port of ``prefetch_one`` from
``learning_embeddings_tpu/data/pipeline.py`` (lines 88-108). The rest of
that module (decode, augment, batching) is not ported yet."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

__all__ = ["prefetch_one"]

_PREFETCH_END = object()


def prefetch_one(iterable):
    """One-deep pipelined iteration: item k+1 is computed on a background
    thread while the consumer processes item k. Production of consecutive
    items stays serialised (safe for stateful generators, such as samplers
    drawing from one RNG); only production overlaps consumption."""
    it = iter(iterable)
    ex = ThreadPoolExecutor(max_workers=1)
    try:
        fut = ex.submit(next, it, _PREFETCH_END)
        while True:
            item = fut.result()
            if item is _PREFETCH_END:
                return
            fut = ex.submit(next, it, _PREFETCH_END)
            yield item
    finally:
        ex.shutdown(wait=False)
