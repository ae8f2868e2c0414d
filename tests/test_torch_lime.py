"""The port's ``viz/lime.py`` (a numpy copy) against the JAX package's, bit
for bit on the same seeded inputs: SLIC on the dense and the chunked
distance paths, the LIME core for one ``predict_fn``, the feature masks
and the renderers."""

import numpy as np
import pytest

from learning_embeddings_tpu.viz import lime as jlime
from learning_embeddings_tpu_torch.viz import lime as tlime


def _image(seed, h=40, w=52, c=3):
    return np.random.RandomState(seed).rand(h, w, c).astype(np.float32)


@pytest.mark.parametrize("path", ["dense", "chunked"])
@pytest.mark.parametrize("shape,n_segments", [((40, 52, 3), 16),
                                              ((33, 33, 1), 9),
                                              ((24, 70, 3), 48)], ids=str)
def test_slic_segments_equal_jax(monkeypatch, path, shape, n_segments):
    img = _image(3, *shape)
    if path == "chunked":
        # both modules keep the threshold as an attribute tests patch
        monkeypatch.setattr(jlime, "_DENSE_LIMIT", 1)
        monkeypatch.setattr(tlime, "_DENSE_LIMIT", 1)
    got = tlime.slic_segments(img, n_segments=n_segments)
    want = jlime.slic_segments(img, n_segments=n_segments)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_slic_chunked_path_is_taken_past_the_limit(monkeypatch):
    """A 300×300 image against ~49 centres is past the 4M threshold: the
    port takes the chunked path (over 65536-pixel chunks) and still gives
    the JAX segmentation."""
    img = _image(5, 300, 300)
    assert 300 * 300 * 49 > tlime._DENSE_LIMIT
    np.testing.assert_array_equal(tlime.slic_segments(img, n_segments=48),
                                  jlime.slic_segments(img, n_segments=48))


def _predict(images):
    """A deterministic 5-class softmax of per-channel means and corners."""
    feats = np.concatenate([images.mean(axis=(1, 2)),
                            images[:, :4, :4].mean(axis=(1, 2))], axis=1)
    w = np.random.RandomState(9).randn(feats.shape[1], 5).astype(np.float32)
    z = feats @ w
    z = np.exp(z - z.max(1, keepdims=True))
    return z / z.sum(1, keepdims=True)


@pytest.mark.parametrize("num_samples,batch_size", [(100, 32), (40, 40),
                                                    (7, 3)])
def test_lime_explain_equals_jax(num_samples, batch_size):
    img = _image(1) + 0.5
    seg = jlime.slic_segments(img, n_segments=12)
    got = tlime.lime_explain(img, _predict, seg, num_samples=num_samples,
                             batch_size=batch_size,
                             rng=np.random.RandomState(0))
    want = jlime.lime_explain(img, _predict, seg, num_samples=num_samples,
                              batch_size=batch_size,
                              rng=np.random.RandomState(0))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("positive_only", [False, True])
def test_top_feature_mask_equals_jax(positive_only):
    rng = np.random.RandomState(4)
    seg = jlime.slic_segments(_image(4), n_segments=16)
    coefs = rng.randn(seg.max() + 1).astype(np.float32)
    got = tlime.top_feature_mask(coefs, seg, num_features=6,
                                 positive_only=positive_only)
    want = jlime.top_feature_mask(coefs, seg, num_features=6,
                                  positive_only=positive_only)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [3, 1])
def test_renderers_equal_jax(channels):
    img = _image(6, c=channels)
    seg = jlime.slic_segments(img, n_segments=16)
    mask = jlime.top_feature_mask(
        np.random.RandomState(6).randn(seg.max() + 1), seg, num_features=5)
    np.testing.assert_array_equal(tlime._boundaries(seg),
                                  jlime._boundaries(seg))
    np.testing.assert_array_equal(tlime.mark_boundaries(img, seg),
                                  jlime.mark_boundaries(img, seg))
    got = tlime.overlay_mask(img, seg, mask)
    want = jlime.overlay_mask(img, seg, mask)
    assert got.shape == want.shape == img.shape[:2] + (3,)
    np.testing.assert_array_equal(got, want)
