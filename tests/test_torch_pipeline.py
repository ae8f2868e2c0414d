"""The port's threaded input pipeline (``data/pipeline.py::ImagePipeline``,
``augment_train``, ``augment_random_resized_crop``) and index samplers
(``data/sampling.py``) against the JAX package on the CPU.

Tolerance: none. Both sides decode with the same cv2 and draw every crop,
flip and resampled index from the same numpy ``RandomState`` seeds, so
batches (pixels, labels, multi-hots, indices) and epoch orders are
compared bit for bit: train and eval, uint8 and float32 output,
grayscale, the 'rrc' augmentation and the in-memory branch, on PNGs the
tests write. Also: a producer's error reaches the consumer, and a
consumer that abandons an epoch leaves no producer thread behind.
"""

import threading
import time

import numpy as np
import pytest

from learning_embeddings_tpu import data as jdata
from learning_embeddings_tpu.data import pipeline as jpipe
from learning_embeddings_tpu.data import sampling as jsampling
from learning_embeddings_tpu.hierarchy import (
    labelmap_from_records as jax_labelmap_from_records)
from learning_embeddings_tpu_torch import data as tdata
from learning_embeddings_tpu_torch.data import pipeline as tpipe
from learning_embeddings_tpu_torch.data import sampling as tsampling
from learning_embeddings_tpu_torch.hierarchy import labelmap_from_records


def _records(n=22):
    recs = []
    for i in range(n):
        g = i % 4
        recs.append({"token": f"t{i:03d}", "family": f"F{g // 2}",
                     "subfamily": f"S{g // 2}", "genus": f"G{g}",
                     "specific_epithet": f"e{i % 3}",
                     "image_path": f"d{g}", "image_name": f"i{i:03d}.png"})
    return recs


@pytest.fixture(scope="module")
def png_data(tmp_path_factory):
    """Records and a 30×40 RGB PNG per record; the port's and the JAX
    package's labelmap and encoded dataset of them."""
    from PIL import Image

    root = tmp_path_factory.mktemp("pngs")
    recs = _records()
    rng = np.random.RandomState(0)
    for r in recs:
        d = root / r["image_path"]
        d.mkdir(exist_ok=True)
        Image.fromarray(rng.randint(0, 256, (30, 40, 3)).astype(
            np.uint8)).save(str(d / r["image_name"]))
    lm, jlm = labelmap_from_records(recs), jax_labelmap_from_records(recs)
    return (str(root), lm, tdata.encode_records(recs, lm), jlm,
            jdata.encode_records(recs, jlm))


def _all_batches(pipe, order, seed):
    return list(pipe.batches(order, seed=seed))


def _same_batches(a, b):
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


CASES = {
    "train_uint8": dict(train=True, out_dtype="uint8"),
    "train_f32": dict(train=True, out_dtype="float32"),
    "eval_uint8": dict(train=False, out_dtype="uint8"),
    "eval_f32": dict(train=False, out_dtype="float32"),
    "train_gray": dict(train=True, grayscale=True, out_dtype="uint8"),
    "eval_gray_f32": dict(train=False, grayscale=True),
    "train_rrc": dict(train=True, augment="rrc", out_dtype="uint8"),
    "train_rrc_f32": dict(train=True, augment="rrc"),
    "train_gray_f32": dict(train=True, grayscale=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_bit_equal_jax(png_data, case):
    root, lm, ds, jlm, jds = png_data
    kw = dict(image_size=16, batch_size=5, num_workers=3, **CASES[case])
    order = np.random.RandomState(1).permutation(len(ds))
    got = _all_batches(tpipe.ImagePipeline(ds, lm, root, **kw), order, 3)
    want = _all_batches(jpipe.ImagePipeline(jds, jlm, root, **kw), order, 3)
    _same_batches(got, want)
    c = 1 if kw.get("grayscale") else 3
    assert got[0]["image"].shape == (5, 16, 16, c)
    # train drops the ragged tail, eval keeps it
    assert len(got) == (len(ds) // 5 if kw["train"] else -(-len(ds) // 5))
    assert len(tpipe.ImagePipeline(ds, lm, root, **kw)) == len(got)


def test_epoch_seed_changes_the_crops(png_data):
    root, lm, ds, _, _ = png_data
    pipe = tpipe.ImagePipeline(ds, lm, root, image_size=16, batch_size=5,
                               num_workers=2, out_dtype="uint8")
    order = np.arange(len(ds))
    a, b = (_all_batches(pipe, order, s)[0]["image"] for s in (0, 1))
    assert not np.array_equal(a, b)


class _InMemory:
    """An in-memory dataset: pixels instead of image files."""

    def __init__(self, images, level_labels):
        self.images = images
        self.level_labels = level_labels
        self.leaf_labels = level_labels[:, -1].copy()

    def __len__(self):
        return len(self.images)

    def multihot(self, labelmap):
        return tdata.multihot_from_level_labels(self.level_labels, labelmap)


@pytest.mark.parametrize("augment", ["ethec", "rrc"])
def test_in_memory_branch_equal_jax(png_data, augment):
    _, lm, ds, jlm, _ = png_data
    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (len(ds), 20, 24, 3)).astype(np.uint8)
    mem = _InMemory(images, ds.level_labels)
    kw = dict(image_size=16, batch_size=4, num_workers=2, augment=augment)
    order = rng.permutation(len(ds))
    got = _all_batches(tpipe.ImagePipeline(mem, lm, "", **kw), order, 5)
    want = _all_batches(jpipe.ImagePipeline(mem, jlm, "", **kw), order, 5)
    _same_batches(got, want)


@pytest.mark.parametrize("seed", [0, 7])
def test_augment_functions_equal_jax(seed):
    img = np.random.RandomState(seed).randint(0, 256, (37, 52, 3)).astype(
        np.uint8)
    for fn in ("augment_train", "augment_random_resized_crop"):
        got = getattr(tpipe, fn)(img, 24, np.random.RandomState(seed))
        want = getattr(jpipe, fn)(img, 24, np.random.RandomState(seed))
        np.testing.assert_array_equal(got, want, err_msg=fn)
    np.testing.assert_array_equal(tpipe.augment_eval(img, 24),
                                  jpipe.augment_eval(img, 24))


def test_producer_errors_reach_the_consumer(png_data, tmp_path):
    _, lm, ds, _, _ = png_data
    pipe = tpipe.ImagePipeline(ds, lm, str(tmp_path / "missing"),
                               image_size=16, batch_size=4, num_workers=2)
    with pytest.raises(FileNotFoundError):
        _all_batches(pipe, np.arange(len(ds)), 0)


def test_abandoned_epoch_stops_its_producer(png_data):
    root, lm, ds, _, _ = png_data
    before = threading.active_count()
    pipe = tpipe.ImagePipeline(ds, lm, root, image_size=16, batch_size=2,
                               num_workers=2)
    gen = pipe.batches(np.arange(len(ds)))
    first = next(gen)
    assert first["image"].shape[0] == 2
    gen.close()              # the consumer walks away with the queue full
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before


@pytest.mark.parametrize("strategy", ["inv", "inv_sqrt"])
def test_weighted_resampler_order_bit_equal_jax(strategy):
    leaves = np.random.RandomState(4).randint(0, 9, 300)
    leaves[leaves == 3] = 4          # a leaf without samples
    got = tsampling.WeightedResampler(leaves, 9, strategy)
    want = jsampling.WeightedResampler(leaves, 9, strategy)
    np.testing.assert_array_equal(got.probs, want.probs)
    r1, r2 = np.random.RandomState(11), np.random.RandomState(11)
    for n in (None, 50):
        np.testing.assert_array_equal(got.order(r1, n), want.order(r2, n))
    np.testing.assert_array_equal(
        tsampling.shuffled_order(40, np.random.RandomState(3)),
        jsampling.shuffled_order(40, np.random.RandomState(3)))
    with pytest.raises(ValueError, match="weight_strategy"):
        tsampling.WeightedResampler(leaves, 9, "uniform")

