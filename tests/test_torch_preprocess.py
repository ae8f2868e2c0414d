"""The port's offline tools against the JAX package's: ``data/preprocess.py``
(``contour_crop``, ``fixed_crop``, ``preprocess_images``), ``data/build_db.py``
(the dependency-free .xlsx reader and the json database built from it,
the family purge of the json and of the image tree, the labelmap dump and
the per-channel normalisation values over an ``ImagePipeline``), and the
``toy`` and ``fmnist`` debug launchers of ``cli/debug_launchers.py`` on
the CPU.

Everything here is numpy or cv2 on both sides, so the outputs are equal
(bit for bit for the crops, images and json; the normalisation values to
1e-12, float64 sums in the same order) except for the uuid tokens that
``generate_database_from_xlsx`` draws at random on each side.
"""

import json
import os
import sys
import zipfile

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from learning_embeddings_tpu.data import build_db as jax_db
from learning_embeddings_tpu.data import preprocess as jax_pre
from learning_embeddings_tpu.data.pipeline import (
    ImagePipeline as JaxPipeline)
from learning_embeddings_tpu.data.records import (
    encode_records as jax_encode)
from learning_embeddings_tpu.hierarchy import (
    labelmap_from_records as jax_labelmap)
from learning_embeddings_tpu_torch.cli import debug_launchers
from learning_embeddings_tpu_torch.data import (ImagePipeline, build_db,
                                                encode_records, preprocess)
from learning_embeddings_tpu_torch.hierarchy import (labelmap_from_records,
                                                     toy_labelmap)

torch.set_num_threads(2)

FAMILIES = ("Nymphalidae", "Pieridae", "Apatelodidae")


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The runners also log to tensorboard where it imports; that import
    pulls in TensorFlow (~15 s), so these tests keep to the jsonl mirror."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _drawer(seed, box=True):
    """A 120×160 'drawer photo': light noise with a dark specimen blob."""
    rng = np.random.RandomState(seed)
    img = (200 + rng.randint(0, 40, (120, 160, 3))).astype(np.uint8)
    if box:
        cv2.ellipse(img, (80 + seed, 60), (30, 22), 0, 0, 360,
                    (40, 50, 60), -1)
    return img


@pytest.mark.parametrize("seed,box", [(0, True), (3, True), (1, False)])
def test_crops_equal_jax(seed, box):
    img = _drawer(seed, box)
    assert preprocess.contour_crop(img) == jax_pre.contour_crop(img)
    assert preprocess.fixed_crop(img) == jax_pre.fixed_crop(img)
    if box:
        assert preprocess.contour_crop(img) is not None


def test_preprocess_images_equal_jax(tmp_path):
    rel = [f"d{i % 2}/im_{i}.jpg" for i in range(4)]
    src = tmp_path / "src"
    for i, p in enumerate(rel):
        os.makedirs(src / os.path.dirname(p), exist_ok=True)
        cv2.imwrite(str(src / p), _drawer(i, box=i != 2))
    for use_contour in (True, False):
        out = {}
        for side, mod in (("port", preprocess), ("jax", jax_pre)):
            dst = tmp_path / f"{side}{int(use_contour)}"
            n = mod.preprocess_images(str(src), str(dst), rel + ["nope.jpg"],
                                      size=48, use_contour=use_contour,
                                      n_workers=2)
            assert n == len(rel)
            out[side] = [cv2.imread(str(dst / p)) for p in rel]
        for a, b in zip(out["port"], out["jax"]):
            assert a.shape == (48, 48, 3)
            np.testing.assert_array_equal(a, b)


def _write_xlsx(path, rows):
    """A minimal .xlsx (shared strings, one numeric cell, a cell without
    an r= attribute, a trailing empty cell dropped by the writer)."""
    strings = sorted({v for r in rows for v in r if isinstance(v, str)})
    idx = {s: i for i, s in enumerate(strings)}
    sheet = []
    for ri, row in enumerate(rows, start=1):
        cells = []
        for ci, v in enumerate(row):
            ref = f'r="{chr(65 + ci)}{ri}" ' if ci != 1 else ""
            if v is None:
                continue
            if isinstance(v, str):
                cells.append(f'<c {ref}t="s"><v>{idx[v]}</v></c>')
            else:
                cells.append(f'<c {ref}><v>{v}</v></c>')
        sheet.append(f'<row r="{ri}">{"".join(cells)}</row>')
    ns = 'xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main"'
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("xl/sharedStrings.xml",
                   f'<sst {ns}>' + "".join(f"<si><t>{s}</t></si>"
                                           for s in strings) + "</sst>")
        z.writestr("xl/worksheets/sheet1.xml",
                   f'<worksheet {ns}><sheetData>{"".join(sheet)}'
                   "</sheetData></worksheet>")


def _rows():
    header = ["family", "subfamily", "genus", "specific_epithet",
              "image_path", "image_name", "count"]
    rows = [header]
    for i in range(6):
        rows.append([FAMILIES[i % 3], f"S{i % 2}", f"G{i % 3}", f"e{i}",
                     f"p{i % 2}/", f"im_{i}.jpg", i])
    rows[3][-1] = None          # a trailing empty cell
    return rows


def test_xlsx_reader_and_database_equal_jax(tmp_path):
    path = str(tmp_path / "master.xlsx")
    _write_xlsx(path, _rows())
    assert build_db._read_xlsx_rows(path) == jax_db._read_xlsx_rows(path)
    dbs = {}
    for side, mod in (("port", build_db), ("jax", jax_db)):
        out = str(tmp_path / f"{side}.json")
        db = mod.generate_database_from_xlsx(path, out)
        with open(out) as f:
            assert json.load(f) == db
        dbs[side] = sorted((({k: v for k, v in r.items() if k != "token"})
                            for r in db.values()), key=lambda r: r["image_name"])
    assert dbs["port"] == dbs["jax"] and len(dbs["port"]) == 6
    assert dbs["port"][2]["count"] == ""     # im_2's trailing empty cell


def test_purge_json_and_images_equal_jax(tmp_path):
    path = str(tmp_path / "master.xlsx")
    _write_xlsx(path, _rows())
    src = tmp_path / "images"
    full = str(tmp_path / "full.json")
    db = jax_db.generate_database_from_xlsx(path, full)
    for rec in db.values():
        if rec["image_name"] == "im_0.jpg":   # a kept record's image is
            continue                          # missing
        p = src / rec["image_path"] / rec["image_name"]
        os.makedirs(p.parent, exist_ok=True)
        cv2.imwrite(str(p), _drawer(1, False))
    for side, mod in (("port", build_db), ("jax", jax_db)):
        kept = mod.purge_json_data(full, str(tmp_path / f"{side}.json"))
        copied = mod.purge_image_data(str(tmp_path / f"{side}.json"),
                                      str(src), str(tmp_path / side))
        assert (kept, copied) == (4, 3), side
    with open(tmp_path / "port.json") as a, open(tmp_path / "jax.json") as b:
        assert json.load(a) == json.load(b)
    walk = {side: sorted(os.path.relpath(os.path.join(r, f), tmp_path / side)
                         for r, _, fs in os.walk(tmp_path / side) for f in fs)
            for side in ("port", "jax")}
    assert walk["port"] == walk["jax"] and len(walk["port"]) == 3


def test_print_labelmap_equals_jax():
    from learning_embeddings_tpu.hierarchy import toy_labelmap as jax_toy
    assert build_db.print_labelmap(toy_labelmap(2, 3)) == \
        jax_db.print_labelmap(jax_toy(2, 3))


@pytest.mark.parametrize("out_dtype", ["uint8", "float32"])
def test_normalization_values_equal_jax(tmp_path, out_dtype):
    recs = []
    for i in range(6):
        name = f"im_{i}.png"
        cv2.imwrite(str(tmp_path / name), _drawer(i, i % 2 == 0))
        recs.append({"token": f"t{i}", "image_path": "", "image_name": name,
                     "family": "F", "subfamily": "S", "genus": "G",
                     "specific_epithet": f"e{i % 3}"})
    kw = dict(image_size=32, batch_size=2, train=False, num_workers=2,
              out_dtype=out_dtype)
    lm, jlm = labelmap_from_records(recs), jax_labelmap(recs)
    port = ImagePipeline(encode_records(recs, lm), lm, str(tmp_path), **kw)
    ref = JaxPipeline(jax_encode(recs, jlm), jlm, str(tmp_path), **kw)
    order = np.arange(6)
    got = build_db.generate_normalization_values(port, order, max_batches=2)
    want = jax_db.generate_normalization_values(ref, order, max_batches=2)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert np.all((0 < got[0]) & (got[0] < 1)) and np.all(got[1] > 0)


def test_debug_launcher_toy_on_the_cpu(capsys):
    res = debug_launchers.main(["toy", "--device", "cpu"])
    assert 0.0 <= res["reconstruction_f1"] <= 1.0
    assert "debug launcher 'toy' completed" in capsys.readouterr().out


def test_debug_launcher_fmnist_on_the_cpu(monkeypatch, tmp_path):
    # the bf16 ResNet-18 at 32² meets oneDNN's bf16 weight-gradient fault
    # on 1×1 maps on AMX CPUs (onednn_dw_repro.py): native CPU convs
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)
    monkeypatch.chdir(tmp_path)     # no FashionMNIST files: the stand-in
    res = debug_launchers.fmnist("cpu")
    assert res["train_steps"] > 0
    assert all(np.isfinite(v) for v in res["test_metrics"].values())


def test_launchers_pass_the_device_on(monkeypatch):
    """Every launcher hands its `device` to the CLI it runs as --device
    (the default is the card)."""
    seen = []
    import learning_embeddings_tpu_torch.cli as cli
    for name, mod in (("toy", "embed_toy"), ("emb", "order_embeddings"),
                      ("fmnist", "fashion_mnist"), ("cifar", "cifar")):
        module = __import__(f"{cli.__name__}.{mod}", fromlist=["main"])
        monkeypatch.setattr(module, "main", lambda argv, name=name: seen.append(
            (name, argv[argv.index("--device") + 1])))
        getattr(debug_launchers, name)()
        debug_launchers.LAUNCHERS[name]("cpu")
    assert seen == [(n, d) for n in ("toy", "emb", "fmnist", "cifar")
                    for d in ("cuda", "cpu")]
    assert sorted(debug_launchers.LAUNCHERS) == sorted(
        ["toy", "emb", "ethec", "joint", "fmnist", "cifar"])
