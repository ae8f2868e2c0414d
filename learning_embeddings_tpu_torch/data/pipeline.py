"""Host input pipeline: decode → augment → batch → prefetch. The port of
``learning_embeddings_tpu/data/pipeline.py`` (lines 30-302):

train:  resize (S+64, S+64) → random crop (S, S) → random hflip
        ('rrc': torchvision's RandomResizedCrop + hflip)
eval:   resize (S, S)

``ImagePipeline`` decodes and augments on a thread pool (cv2 releases the
GIL) and hands batches over through a bounded, stop-aware queue. Batches
are NHWC uint8 (the transfer format: the trainers scale on the device,
bit-identically) or float32 in [0, 1]. Every random draw comes from
``numpy.random.RandomState(seed * 1_000_003 + position)``, as in the JAX
package, so the crops and flips are the same there and here.

Images decode with cv2 where it imports, else with PIL, as in the JAX
module; both are imported inside the functions, so importing the package
needs neither. ``ImagePipeline(loader='native')`` decodes and augments
JPEG files in the C++ loader of ``data/native_loader.py`` instead (one
fused pass on its own threads, with random crops and flips of its own
generator). The JAX pipeline switches to that loader by itself
for .jpg files; the port takes it only when asked, and raises where it
cannot run.
"""

from __future__ import annotations

import functools
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np

__all__ = ["ImagePipeline", "LOADERS", "decode_image", "augment_train",
           "augment_random_resized_crop", "augment_eval",
           "augment_joint_train", "prefetch_one"]

_PREFETCH_END = object()
#: decode paths of ``ImagePipeline``: cv2/PIL in Python threads, or the
#: C++ JPEG loader
LOADERS = ("python", "native")
#: batches an ``ImagePipeline`` epoch holds ready ahead of its consumer
PIPELINE_PREFETCH = 4


@functools.lru_cache(maxsize=None)
def _cv2():
    """The cv2 module, or None where it does not import (then PIL)."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def decode_image(path: str, grayscale: bool = False) -> np.ndarray:
    """HWC uint8, RGB (or HW1 grayscale)."""
    cv2 = _cv2()
    if cv2 is not None:
        flag = cv2.IMREAD_GRAYSCALE if grayscale else cv2.IMREAD_COLOR
        img = cv2.imread(path, flag)
        if img is None:
            raise FileNotFoundError(path)
        if grayscale:
            return img[..., None]
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    from PIL import Image

    img = Image.open(path).convert("L" if grayscale else "RGB")
    arr = np.asarray(img)
    return arr[..., None] if grayscale else arr


def _resize(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    cv2 = _cv2()
    if cv2 is not None:
        out = cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)
        return out[..., None] if out.ndim == 2 else out
    from PIL import Image

    out = np.asarray(Image.fromarray(img.squeeze()).resize((hw[1], hw[0])))
    return out[..., None] if out.ndim == 2 else out


def augment_train(img: np.ndarray, size: int, rng: np.random.RandomState,
                  initial_pad: int = 64) -> np.ndarray:
    """resize (S+64)² → random crop S² → random hflip: the classifier's
    train transform."""
    big = _resize(img, (size + initial_pad, size + initial_pad))
    y = rng.randint(0, initial_pad + 1)
    x = rng.randint(0, initial_pad + 1)
    crop = big[y:y + size, x:x + size]
    if rng.rand() < 0.5:
        crop = crop[:, ::-1]
    return crop


def augment_eval(img: np.ndarray, size: int) -> np.ndarray:
    return _resize(img, (size, size))


def augment_joint_train(img: np.ndarray, size: int,
                        rng: np.random.RandomState) -> np.ndarray:
    """resize (S, S) → random hflip: the joint trainers' train transform
    (no crop, unlike the classifier's)."""
    out = _resize(img, (size, size))
    if rng.rand() < 0.5:
        out = out[:, ::-1]
    return out


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


def augment_random_resized_crop(img: np.ndarray, size: int,
                                rng: np.random.RandomState,
                                scale=(0.08, 1.0),
                                ratio=(3 / 4, 4 / 3)) -> np.ndarray:
    """torchvision's RandomResizedCrop + hflip (the CIFAR/FMNIST train
    transforms): ten tries at an area and aspect ratio, then a centre
    square."""
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        log_r = rng.uniform(np.log(ratio[0]), np.log(ratio[1]))
        r = np.exp(log_r)
        cw = int(round(np.sqrt(target * r)))
        ch = int(round(np.sqrt(target / r)))
        if 0 < cw <= w and 0 < ch <= h:
            y = rng.randint(0, h - ch + 1)
            x = rng.randint(0, w - cw + 1)
            crop = img[y:y + ch, x:x + cw]
            break
    else:
        s = min(h, w)
        y, x = (h - s) // 2, (w - s) // 2
        crop = img[y:y + s, x:x + s]
    out = _resize(crop, (size, size))
    if rng.rand() < 0.5:
        out = out[:, ::-1]
    return out


def _put_until_stopped(q: "queue.Queue", item, stop: threading.Event) -> None:
    """Puts `item` unless `stop` is set first: a consumer that abandons
    the generator stops draining the bounded queue, and a plain put would
    block the producer for ever."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return
        except queue.Full:
            pass


class ImagePipeline:
    """Threaded decode + augment over an ``EncodedDataset`` (image files
    under `image_root`) or an in-memory dataset with an ``images`` array;
    yields dict batches {image, level_labels, leaf_labels, multihot,
    index}. The order comes from the caller (shuffle or weighted
    resampling).

    ``loader='native'`` reads JPEG files through ``data/native_loader.py``
    (the JAX package's fast path, ``pipeline.py:185-193, 254-268``): decode,
    resize, crop, flip and scale in one C++ pass. Its uint8 batches round
    once more than its float32 ones (the fused pass rounds only the
    output), where the Python path's are bit-identical. It takes files
    only, with the 'ethec' transform."""

    def __init__(self, dataset, labelmap, image_root: str, *,
                 image_size: int = 448, batch_size: int = 64,
                 train: bool = True, grayscale: bool = False,
                 num_workers: int = 8, augment: str = "ethec",
                 out_dtype: str = "float32", loader: str = "python"):
        if augment not in ("ethec", "rrc"):
            raise ValueError(f"unknown augment {augment!r}")
        if loader not in LOADERS:
            raise ValueError(f"unknown loader {loader!r}; expected {LOADERS}")
        if loader == "native":
            if hasattr(dataset, "images") or augment != "ethec":
                raise ValueError("loader='native' reads image files with "
                                 "the 'ethec' transform only")
            bad = [p for p in dataset.image_paths
                   if not p.lower().endswith((".jpg", ".jpeg"))]
            if bad:
                raise ValueError(f"loader='native' decodes JPEG files "
                                 f"only, got {bad[:3]}")
        self.ds = dataset
        self.labelmap = labelmap
        self.image_root = image_root
        self.size = image_size
        self.bs = batch_size
        self.train = train
        self.grayscale = grayscale
        self.num_workers = num_workers
        self.augment = augment
        self.out_dtype = out_dtype
        self.loader = loader
        self._multihot = dataset.multihot(labelmap)

    def __len__(self):
        return (len(self.ds) // self.bs if self.train
                else -(-len(self.ds) // self.bs))

    def _load_one(self, i: int, seed: int) -> np.ndarray:
        if hasattr(self.ds, "images"):          # in-memory dataset
            img = self.ds.images[i]
        else:
            img = decode_image(
                os.path.join(self.image_root, self.ds.image_paths[i]),
                self.grayscale)
        if self.train:
            rng = np.random.RandomState(seed)
            if self.augment == "rrc":
                img = augment_random_resized_crop(img, self.size, rng)
            else:
                img = augment_train(img, self.size, rng)
        else:
            img = augment_eval(img, self.size)
        if self.out_dtype == "uint8":
            return img if img.dtype == np.uint8 else \
                np.clip(np.round(img), 0, 255).astype(np.uint8)
        return img.astype(np.float32) / 255.0

    def _load_native(self, idx: np.ndarray, seed: int) -> np.ndarray:
        from . import native_loader

        paths = [os.path.join(self.image_root, self.ds.image_paths[i])
                 for i in idx]
        images, status = native_loader.load_augment_batch(
            paths, self.size, pad=64, train=self.train,
            grayscale=self.grayscale, seed=seed,
            out_dtype=np.uint8 if self.out_dtype == "uint8" else np.float32)
        if (status != 0).any():
            bad = np.nonzero(status)[0][:3]
            raise FileNotFoundError(
                f"native loader failed on {[paths[j] for j in bad]} (codes "
                f"{status[bad]})")
        return images

    def batches(self, order: np.ndarray, seed: int = 0) -> Iterator[dict]:
        """Batches in `order` (a precomputed index sequence). Training
        drops the ragged tail, so every train batch has the full size."""
        bs = self.bs
        n_batches = len(order) // bs if self.train else -(-len(order) // bs)
        out_q: "queue.Queue" = queue.Queue(maxsize=PIPELINE_PREFETCH)
        stop = threading.Event()

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for b in range(n_batches):
                    if stop.is_set():
                        return
                    idx = order[b * bs:(b + 1) * bs]
                    if self.loader == "native":
                        images = self._load_native(
                            idx, seed * 1_000_003 + b * bs)
                    else:
                        images = np.stack(list(pool.map(
                            lambda t: self._load_one(
                                t[1], seed * 1_000_003 + t[0]),
                            enumerate(idx, start=b * bs))))
                    _put_until_stopped(out_q, {
                        "image": images,
                        "level_labels": self.ds.level_labels[idx],
                        "leaf_labels": self.ds.leaf_labels[idx],
                        "multihot": self._multihot[idx],
                        "index": np.asarray(idx),
                    }, stop)

        def producer():
            try:
                produce()
                payload = None            # end of the epoch
            except BaseException as exc:  # handed to the consumer, raised
                payload = exc             # there instead of a hang
            _put_until_stopped(out_q, payload, stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
