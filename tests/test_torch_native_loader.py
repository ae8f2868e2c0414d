"""The port's C++ JPEG loader (``data/native_loader.py`` over
``csrc/le_loader.cc``, built with g++ and libjpeg into
``.torch_kernels/native``): the JAX package's ``tests/test_native_loader.py``
cases, the port's loader bit-equal to the JAX package's at the same seeds,
``ImagePipeline(loader='native')`` and the joint CLI's native pixels, and
the failures that raise (no silent fallback: a failed build, a stale
library, a non-JPEG file, a missing file).

Tolerances: bit-equal to the JAX loader (the same source and flags);
against the Python decode path as the JAX tests hold it (a mean
difference below 0.02 in [0, 1], libjpeg and cv2 may differ by a few
levels); the uint8 output within one rounding (0.5/255) of the float32
one, where the Python path's are bit-identical.
"""

import ctypes
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from learning_embeddings_tpu.data import native_loader as jax_native
from learning_embeddings_tpu_torch.data import (ImagePipeline, encode_records,
                                                native_loader)
from learning_embeddings_tpu_torch.hierarchy import labelmap_from_records

RNG = np.random.RandomState(0)
CASES = {"train": dict(train=True, seed=1),
         "eval": dict(train=False),
         "pad0": dict(train=True, pad=0, seed=5),
         "uint8": dict(train=True, seed=3, out_dtype=np.uint8),
         "gray": dict(train=False, grayscale=True)}


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpegs")
    paths = []
    for i in range(8):
        p = str(d / f"im_{i}.jpg")
        cv2.imwrite(p, RNG.randint(0, 255, (90, 120, 3), np.uint8))
        paths.append(p)
    return paths


def _dataset(paths):
    recs = [{"token": f"t{i}", "image_path": "",
             "image_name": os.path.basename(p),
             "family": "F", "subfamily": "S", "genus": "G",
             "specific_epithet": f"e{i % 2}"} for i, p in enumerate(paths)]
    lm = labelmap_from_records(recs)
    return encode_records(recs, lm), lm


@pytest.mark.parametrize("case", sorted(CASES))
def test_bit_equal_to_the_jax_loader(jpegs, case):
    if not jax_native.available():
        pytest.fail("the JAX package's native loader did not build here")
    got, status = native_loader.load_augment_batch(jpegs, 48, **CASES[case])
    want, want_status = jax_native.load_augment_batch(jpegs, 48,
                                                      **CASES[case])
    assert got.dtype == want.dtype and (status == 0).all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(status, want_status)


def test_batch_shapes_and_range(jpegs):
    batch, status = native_loader.load_augment_batch(jpegs, 64, train=True)
    assert batch.shape == (8, 64, 64, 3) and batch.dtype == np.float32
    assert (status == 0).all()
    assert 0.0 <= batch.min() and batch.max() <= 1.0


def test_pad0_train_is_resize_plus_flip(jpegs):
    """pad=0 + train (the joint train transform): the zero-headroom crop is
    a plain resize, so each output is the eval resize or its mirror."""
    ev, _ = native_loader.load_augment_batch(jpegs, 64, train=False)
    tr, status = native_loader.load_augment_batch(jpegs, 64, pad=0,
                                                  train=True, seed=5)
    assert (status == 0).all()
    flips = 0
    for a, b in zip(tr, ev):
        if np.array_equal(a, b):
            continue
        assert np.array_equal(a, b[:, ::-1])
        flips += 1
    assert 0 < flips < len(jpegs)


def test_eval_matches_python_pipeline(jpegs):
    from learning_embeddings_tpu_torch.data.pipeline import (augment_eval,
                                                             decode_image)
    batch, _ = native_loader.load_augment_batch(jpegs, 56, train=False)
    for i, p in enumerate(jpegs[:3]):
        ref = augment_eval(decode_image(p), 56).astype(np.float32) / 255.0
        assert np.abs(batch[i] - ref).mean() < 0.02


def test_grayscale(jpegs):
    batch, status = native_loader.load_augment_batch(
        jpegs, 32, train=False, grayscale=True)
    assert batch.shape == (8, 32, 32, 1) and (status == 0).all()


def test_determinism_and_seed_variation(jpegs):
    a, _ = native_loader.load_augment_batch(jpegs, 48, train=True, seed=1)
    b, _ = native_loader.load_augment_batch(jpegs, 48, train=True, seed=1)
    c, _ = native_loader.load_augment_batch(jpegs, 48, train=True, seed=2)
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_missing_file_status(jpegs, tmp_path):
    batch, status = native_loader.load_augment_batch(
        [str(tmp_path / "missing.jpg")] + jpegs[:2], 32, train=False)
    assert status[0] != 0 and (status[1:] == 0).all()


def test_uint8_output_rounds_once_more_than_f32(jpegs):
    """The native uint8 path rounds the fused pass's output once: within
    0.5/255 of the float32 batch, and not equal to it (JAX
    ``cli/common.py:51-56``)."""
    f, _ = native_loader.load_augment_batch(jpegs, 48, train=True, seed=3)
    u, su = native_loader.load_augment_batch(jpegs, 48, train=True, seed=3,
                                             out_dtype=np.uint8)
    assert u.dtype == np.uint8 and u.shape == f.shape and (su == 0).all()
    d = np.abs(u.astype(np.float32) / 255.0 - f)
    assert d.max() <= 0.5 / 255 + 1e-6 and d.max() > 1e-4


def test_resize_matches_cv2():
    img = RNG.randint(0, 255, (75, 101, 3), np.uint8)
    ours = native_loader.resize_bilinear(img, 40, 64)
    ref = cv2.resize(img, (64, 40), interpolation=cv2.INTER_LINEAR)
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_pipeline_native_rounds_once_more_than_python(jpegs, train):
    """ImagePipeline(loader='native'): uint8 batches within one rounding of
    the native float32 ones; on the Python path the two are bit-identical
    (uint8 / 255 == float32)."""
    ds, lm = _dataset(jpegs)
    root = os.path.dirname(jpegs[0])
    kw = dict(image_size=40, batch_size=4, train=train, num_workers=2)
    out = {}
    for loader in ("native", "python"):
        for dtype in ("uint8", "float32"):
            pipe = ImagePipeline(ds, lm, root, out_dtype=dtype, loader=loader,
                                 **kw)
            batches = list(pipe.batches(np.arange(len(ds)), seed=5))
            assert len(batches) == 2
            out[loader, dtype] = np.concatenate([b["image"]
                                                 for b in batches])
    n = out["native", "uint8"].astype(np.float32) / 255.0
    assert np.abs(n - out["native", "float32"]).max() <= 0.5 / 255 + 1e-6
    assert not np.array_equal(n, out["native", "float32"])
    np.testing.assert_array_equal(
        out["python", "uint8"].astype(np.float32) / 255.0,
        out["python", "float32"])
    assert out["native", "uint8"].shape == (8, 40, 40, 3)


def test_pipeline_native_equals_the_jax_pipeline(jpegs):
    """The JAX pipeline takes its native loader by itself on JPEG files:
    the port's, asked for by name, gives the same batches."""
    from learning_embeddings_tpu.data import ImagePipeline as JaxPipeline
    from learning_embeddings_tpu.data import encode_records as jax_encode
    from learning_embeddings_tpu.hierarchy import (
        labelmap_from_records as jax_labelmap)
    ds, lm = _dataset(jpegs)
    recs = [{"token": f"t{i}", "image_path": "",
             "image_name": os.path.basename(p), "family": "F",
             "subfamily": "S", "genus": "G", "specific_epithet": f"e{i % 2}"}
            for i, p in enumerate(jpegs)]
    jlm = jax_labelmap(recs)
    jds = jax_encode(recs, jlm)
    root = os.path.dirname(jpegs[0])
    kw = dict(image_size=48, batch_size=4, train=True, num_workers=2,
              out_dtype="uint8")
    jp = JaxPipeline(jds, jlm, root, **kw)
    assert jp._native
    got = list(ImagePipeline(ds, lm, root, loader="native", **kw)
               .batches(np.arange(8), seed=3))
    want = list(jp.batches(np.arange(8), seed=3))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["level_labels"], w["level_labels"])


def test_pipeline_native_refuses_what_it_cannot_read(jpegs, tmp_path):
    ds, lm = _dataset(jpegs)
    with pytest.raises(ValueError, match="ethec"):
        ImagePipeline(ds, lm, "", augment="rrc", loader="native")
    with pytest.raises(ValueError, match="unknown loader"):
        ImagePipeline(ds, lm, "", loader="turbo")
    png = str(tmp_path / "a.png")
    cv2.imwrite(png, np.zeros((8, 8, 3), np.uint8))
    pds, plm = _dataset([png])
    with pytest.raises(ValueError, match="JPEG"):
        ImagePipeline(pds, plm, str(tmp_path), loader="native")
    # a file that goes missing raises in the consumer, naming it
    gone = str(tmp_path / "gone.jpg")
    cv2.imwrite(gone, np.zeros((8, 8, 3), np.uint8))
    gds, glm = _dataset([gone] * 2)
    pipe = ImagePipeline(gds, glm, str(tmp_path), image_size=8,
                         batch_size=2, loader="native")
    os.remove(gone)
    with pytest.raises(FileNotFoundError, match="gone.jpg"):
        list(pipe.batches(np.arange(2)))


def test_joint_native_pixels_are_resize_plus_flip(jpegs):
    from learning_embeddings_tpu_torch.cli._joint_main import native_pixels
    got = native_pixels(jpegs, 32, seed=4)
    ev, _ = native_loader.load_augment_batch(jpegs, 32, train=False)
    assert got.dtype == np.float32 and got.shape == (8, 32, 32, 3)
    for a, b in zip(got, ev):
        assert np.array_equal(a, b) or np.array_equal(a, b[:, ::-1])
    with pytest.raises(FileNotFoundError, match="missing"):
        native_pixels(jpegs[:1] + ["/nonexistent/missing.jpg"], 32, 0)


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch,
                                                        tmp_path):
    (tmp_path / "le_loader.cc").write_text("#include <no_such_header.h>\n")
    with open(os.path.join(native_loader._CSRC, "Makefile")) as f:
        (tmp_path / "Makefile").write_text(f.read())
    monkeypatch.setattr(native_loader, "_CSRC", str(tmp_path))
    monkeypatch.setattr(native_loader, "_BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(native_loader, "_LIB_PATH",
                        str(tmp_path / "out" / "lible_loader.so"))
    monkeypatch.setattr(native_loader, "_lib", None)
    with pytest.raises(RuntimeError, match="no_such_header"):
        native_loader.load_augment_batch(["x.jpg"], 8)


def test_a_stale_library_raises(monkeypatch):
    class Stale:
        def __init__(self, path):
            self.le_version = lambda: 1
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(ctypes, "CDLL", Stale)
    with pytest.raises(RuntimeError, match="version 1"):
        native_loader.resize_bilinear(np.zeros((4, 4, 3), np.uint8), 2, 2)
