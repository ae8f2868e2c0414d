"""Joint-embedding classification metrics, ranking labels per level by
energy: the port of ``learning_embeddings_tpu/eval/ranking.py``.

E(label, image) for all pairs comes from one ``pairwise_energy`` call on
the device the label embeddings lie on (for the order energy, the kernel of
``ops/pairwise_order.py`` on the card), then goes to numpy as in the JAX
package. Per level, labels are ranked by ascending energy with a stable
argsort:

* hit@k per level and overall,
* per-label tp / fp / fn / tn (tn for every non-gt label at a level on a
  correct top-1),
* micro / macro precision / recall / F1, accuracy,
* median embedding norms.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..geometry import pairwise_energy
from .metrics import prf1_from_counts

__all__ = ["joint_classification_metrics"]


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def joint_classification_metrics(
    label_emb,
    img_emb,
    img_paths_global: np.ndarray,
    labelmap,
    energy: str = "hyp_cone",
    ks: Sequence[int] = (1, 3, 5),
    **energy_kw,
) -> Dict[str, object]:
    """label_emb: (n_labels, D); img_emb: (n_images, D), tensors or arrays
    (the images are moved to the labels' device);
    img_paths_global: (n_images, L) gt ancestor (global label id) per
    level."""
    lab = torch.as_tensor(label_emb)
    img = torch.as_tensor(img_emb, device=lab.device)
    E = pairwise_energy(energy, lab, img, **energy_kw).detach().cpu().numpy()
    n_labels, n_images = E.shape
    L = labelmap.n_levels
    img_paths_global = np.asarray(img_paths_global)

    per_label = {k: np.zeros(n_labels, np.int64)
                 for k in ("tp", "fp", "fn", "tn")}
    hit_at_k = {k: np.zeros(L, np.int64) for k in ks}
    top1_per_level = np.zeros((n_images, L), np.int64)

    for l in range(L):
        a, b = int(labelmap.level_start[l]), int(labelmap.level_stop[l])
        scores = E[a:b]                                  # (n_l, n_images)
        order = np.argsort(scores, axis=0, kind="stable")  # ascending energy
        gt = img_paths_global[:, l]                      # global ids
        gt_rel = gt - a
        ranks_needed = max(ks)
        topk = order[:ranks_needed]                      # (K, n_images)
        for k in ks:
            hit_at_k[k][l] = (topk[:k] == gt_rel[None, :]).any(axis=0).sum()
        top1 = topk[0]
        top1_per_level[:, l] = top1 + a
        correct = top1 == gt_rel
        np.add.at(per_label["tp"], gt[correct], 1)
        np.add.at(per_label["fp"], a + top1[~correct], 1)
        np.add.at(per_label["fn"], gt[~correct], 1)
        # tn for every other label of the level on a correct prediction
        per_label["tn"][a:b] += int(correct.sum())
        np.add.at(per_label["tn"], gt[correct], -1)

    tp, fp, fn, tn = (per_label[k] for k in ("tp", "fp", "fn", "tn"))
    # degenerate_one=False: the joint metrics score never-predicted
    # zero-support labels 0.0 (oe_h.py:2071-2086), unlike MetricsMultiLevel
    prec, rec, f1 = prf1_from_counts(tp, tp + fp, tp + fn,
                                     degenerate_one=False)
    t_tp, t_fp, t_fn, t_tn = tp.sum(), fp.sum(), fn.sum(), tn.sum()
    micro_p, micro_r, micro_f1 = (float(x) for x in prf1_from_counts(
        t_tp, t_tp + t_fp, t_tp + t_fn, degenerate_one=False))

    out: Dict[str, object] = {
        "micro_precision": float(micro_p),
        "micro_recall": float(micro_r),
        "micro_f1": float(micro_f1),
        "macro_precision": float(prec.mean()),
        "macro_recall": float(rec.mean()),
        "macro_f1": float(f1.mean()),
        "accuracy": float((t_tp + t_tn) / max(t_tp + t_tn + t_fp + t_fn, 1)),
        "median_label_norm": float(np.median(
            np.linalg.norm(_numpy(label_emb), axis=1))),
        "median_img_norm": float(np.median(
            np.linalg.norm(_numpy(img_emb), axis=1))),
        "top1_per_level": top1_per_level,
    }
    for k in ks:
        out[f"hit@{k}"] = float(hit_at_k[k].sum() / (n_images * L))
        for l in range(L):
            out[f"hit@{k}/level_{l}"] = float(hit_at_k[k][l] / n_images)
    return out
