"""Database construction and curation: the port of
``learning_embeddings_tpu/data/build_db.py`` (the reference's
`data/utilities.py` :7-46 `generate_database`, xlsx → token-keyed json;
`data/purge_database.py` :8-40, keep the 6 butterfly families and rewrite
json + image tree; `generate_labelmap` / `generate_normalization_values`,
db.py:3888-3917, 4024-4051). The .xlsx reader is dependency-free
(``_read_xlsx_rows``); openpyxl is used where it imports, and imported
only then."""

from __future__ import annotations

import json
import os
import shutil
import uuid
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "generate_database_from_xlsx",
    "purge_json_data",
    "purge_image_data",
    "print_labelmap",
    "generate_normalization_values",
    "ETHEC_FAMILIES",
]

# the 6 families the reference keeps (purge_database.py)
ETHEC_FAMILIES = ("Hesperiidae", "Papilionidae", "Pieridae", "Nymphalidae",
                  "Lycaenidae", "Riodinidae")


def _read_xlsx_rows(path: str) -> List[list]:
    """Minimal dependency-free .xlsx reader (an .xlsx is a zip of
    spreadsheetml XML): first worksheet, shared/inline strings + raw
    values — enough of the format for the ETHEC master sheet. Used when
    openpyxl is not installed."""
    import re
    import xml.etree.ElementTree as ET
    import zipfile

    def local(tag: str) -> str:
        return tag.rsplit("}", 1)[-1]

    with zipfile.ZipFile(path) as z:
        shared: List[str] = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root:
                shared.append("".join(t.text or "" for t in si.iter()
                                      if local(t.tag) == "t"))
        sheets = sorted(n for n in z.namelist()
                        if re.fullmatch(r"xl/worksheets/sheet\d+\.xml", n))
        if not sheets:
            raise ValueError(f"{path}: no worksheets found")
        root = ET.fromstring(z.read(sheets[0]))
        rows: List[list] = []
        for row in root.iter():
            if local(row.tag) != "row":
                continue
            cells: Dict[int, object] = {}
            next_ci = 1   # cells without an r= attribute are positional:
            #               they follow the previous cell (spreadsheetml)
            for c in row:
                if local(c.tag) != "c":
                    continue
                m = re.match(r"([A-Z]+)", c.attrib.get("r", ""))
                if m:
                    ci = 0
                    for ch in m.group(1):
                        ci = ci * 26 + ord(ch) - 64
                else:
                    ci = next_ci
                t = c.attrib.get("t", "n")
                v = None
                if t == "inlineStr":
                    v = "".join(x.text or "" for x in c.iter()
                                if local(x.tag) == "t")
                else:
                    for x in c:
                        if local(x.tag) == "v":
                            v = x.text
                    if v is not None and t == "s":
                        v = shared[int(v)]
                cells[ci - 1] = v
                next_ci = ci + 1
            width = max(cells) + 1 if cells else 0
            rows.append([cells.get(i) for i in range(width)])
    return rows


def generate_database_from_xlsx(xlsx_path: str, json_path: str,
                                mini: bool = False,
                                header_row: int = 0) -> Dict[str, dict]:
    """xlsx rows → {uuid-token: record} json (reference utilities.py:7-46).
    Uses openpyxl when present, otherwise the built-in spreadsheetml
    reader (_read_xlsx_rows)."""
    try:
        import openpyxl

        wb = openpyxl.load_workbook(xlsx_path, read_only=True)
        rows = wb.active.iter_rows(values_only=True)
    except ImportError:
        rows = iter(_read_xlsx_rows(xlsx_path))
    header = [str(h) for h in next(rows)]
    db: Dict[str, dict] = {}
    for i, row in enumerate(rows):
        if mini and i >= 10:
            break
        token = str(uuid.uuid4())
        # writers drop trailing empty <c> elements — pad so those columns
        # become "" (matching the openpyxl path) instead of vanishing keys
        row = list(row) + [None] * (len(header) - len(row))
        rec = {k: ("" if v is None else v) for k, v in zip(header, row)}
        rec["token"] = token
        db[token] = rec
    with open(json_path, "w") as f:
        json.dump(db, f, indent=4)
    return db


def purge_json_data(json_path: str, out_path: str,
                    keep_families: Sequence[str] = ETHEC_FAMILIES) -> int:
    """Keep records of the given families; returns kept count."""
    with open(json_path) as f:
        db = json.load(f)
    kept = {tok: rec for tok, rec in db.items()
            if rec.get("family") in keep_families}
    with open(out_path, "w") as f:
        json.dump(kept, f, indent=4)
    return len(kept)


def purge_image_data(json_path: str, src_image_root: str,
                     dst_image_root: str) -> int:
    """Copy only the images referenced by the (purged) json."""
    with open(json_path) as f:
        db = json.load(f)
    n = 0
    for rec in db.values():
        rel = os.path.join(rec.get("image_path", ""), rec["image_name"])
        src = os.path.join(src_image_root, rel)
        if not os.path.exists(src):
            continue
        dst = os.path.join(dst_image_root, rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copy2(src, dst)
        n += 1
    return n


def print_labelmap(labelmap) -> str:
    """Python-source dump of the taxonomy dicts (the reference regenerates
    its db.py literal dicts this way, db.py:4054-4094)."""
    lines = []
    for l, name in enumerate(labelmap.level_names):
        lines.append(f"{name} = " + json.dumps(
            dict(labelmap.name_to_ix[l]), indent=1))
    for l in range(labelmap.n_levels - 1):
        mapping = {
            labelmap.ix_to_name[l][p]: [labelmap.ix_to_name[l + 1][c]
                                        for c in labelmap.get_children_of(p, l + 1)]
            for p in range(labelmap.levels[l])
        }
        lines.append(f"child_of_{labelmap.level_names[l]} = "
                     + json.dumps(mapping, indent=1))
    return "\n".join(lines)


def generate_normalization_values(pipeline, order: np.ndarray,
                                  max_batches: Optional[int] = None):
    """Dataset per-channel mean/std (db.py:4024-4051) streamed over the
    input pipeline."""
    n, s, s2 = 0, 0.0, 0.0
    for i, batch in enumerate(pipeline.batches(order)):
        # float64 BEFORE squaring: a uint8 pipeline's (x ** 2) would wrap
        # mod 256 (200² -> 64), and uint8 batches are on the 0-255 scale
        # while float pipelines are [0,1] — normalize to [0,1] either way
        x = batch["image"].reshape(-1, batch["image"].shape[-1])
        x = x.astype(np.float64)
        if batch["image"].dtype == np.uint8:
            x = x / 255.0
        n += x.shape[0]
        s = s + x.sum(axis=0)
        s2 = s2 + (x ** 2).sum(axis=0)
        if max_batches and i + 1 >= max_batches:
            break
    mean = s / n
    std = np.sqrt(np.maximum(s2 / n - mean**2, 0.0))
    return mean, std
