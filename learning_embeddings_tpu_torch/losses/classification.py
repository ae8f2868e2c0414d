"""Hierarchical classification losses: the port of
``learning_embeddings_tpu/losses/classification.py``, the reference's five
criteria:

* ``make_multi_level_ce``   — Σ_l w_l · CE(logits[level_l], y_l)
* ``make_last_level_ce``    — softmax over the leaves; a parent's
  probability is the sum of its children's (one masked matmul a level);
  NLL at every level. Returns (all-level probabilities, mean loss).
* ``make_masked_ce``        — per level, CE over the children of the gt
  parent until the predicted chain makes its first mistake, then CE over
  the whole level; returns (the predicted-chain-masked outputs the
  evaluator reads, **sum** loss: the reference's mean over a one-element
  tensor is the batch sum).
* ``multi_label_soft_margin`` — torch's MultiLabelSoftMarginLoss on the
  multi-hot.
* ``make_hierarchical_softmax`` / ``hierarchical_softmax_nll`` — a
  log-softmax within each sibling group chained down the tree, from one
  (B, n_classes) linear output; NLL on the leaf log-probabilities.

Conventions as there: ``logits`` (B, n_classes) over all levels
concatenated ((B, n_leaf) for last_level_ce), ``level_labels`` (B, L)
relative per-level integer labels. Class weights and the taxonomy's masks
move to the logits' device on the first call there.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "make_multi_level_ce",
    "make_last_level_ce",
    "make_masked_ce",
    "multi_label_soft_margin",
    "make_hierarchical_softmax",
    "hierarchical_softmax_nll",
]

_NEG_FILL = -1.0e8   # the reference's "masked" fill


def _level_slices(labelmap):
    return [
        (int(labelmap.level_start[l]), int(labelmap.level_stop[l]))
        for l in range(labelmap.n_levels)
    ]


class _PerDevice:
    """Host constants (numpy arrays) with a copy on each device they were
    asked for, made on the first request there."""

    def __init__(self, *arrays):
        self.host = [None if a is None else torch.as_tensor(a)
                     for a in arrays]
        self.copies = {}

    def on(self, device):
        got = self.copies.get(device)
        if got is None:
            got = self.copies[device] = [
                None if t is None else t.to(device) for t in self.host]
        return got


def _ce_from_logits(logits, labels, class_weights=None):
    """Per-sample cross entropy −w[y]·log softmax(logits)[y]
    (torch CrossEntropyLoss(weight, reduction='none') semantics)."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    if class_weights is not None:
        nll = nll * class_weights[labels]
    return nll


def _class_weights(class_weights):
    return (None if class_weights is None
            else np.asarray(class_weights, np.float32))


def make_multi_level_ce(labelmap, level_weights=None, class_weights=None):
    """Σ_l w_l · CE over each level's logit slice; batch mean."""
    slices = _level_slices(labelmap)
    lw = (np.ones(labelmap.n_levels) if level_weights is None
          else np.asarray(level_weights))
    consts = _PerDevice(_class_weights(class_weights))

    def loss_fn(logits, level_labels):
        (cw,) = consts.on(logits.device)
        total = 0.0
        for l, (a, b) in enumerate(slices):
            w_l = None if cw is None else cw[a:b]
            total = total + float(lw[l]) * _ce_from_logits(
                logits[:, a:b], level_labels[:, l], w_l)
        return total.mean()

    return loss_fn


def make_last_level_ce(labelmap, level_weights=None, class_weights=None):
    """Leaf softmax propagated bottom-up; NLL at every level. Returns
    (all_probs (B, n_classes), scalar loss)."""
    slices = _level_slices(labelmap)
    lw = (np.ones(labelmap.n_levels) if level_weights is None
          else np.asarray(level_weights))
    L = labelmap.n_levels
    consts = _PerDevice(_class_weights(class_weights),
                        *[m.astype(np.float32) for m in labelmap.child_masks])

    def loss_fn(leaf_logits, level_labels):
        cw, *masks = consts.on(leaf_logits.device)
        probs = [None] * L
        probs[L - 1] = F.softmax(leaf_logits, dim=-1)
        for l in range(L - 2, -1, -1):
            probs[l] = probs[l + 1] @ masks[l].T
        total = 0.0
        for l, (a, b) in enumerate(slices):
            logp = torch.log(torch.clamp_min(probs[l], 1e-30))
            nll = -logp.gather(-1, level_labels[:, l][:, None])[:, 0]
            if cw is not None:
                nll = nll * cw[a:b][level_labels[:, l]]
            total = total + float(lw[l]) * nll
        return torch.cat(probs, dim=-1), total.mean()

    return loss_fn


def _masked_ce(logits, mask, labels):
    """CE over the candidate subset only: −logit[y] + lse(logits | mask)
    (y must be in the mask)."""
    masked = torch.where(mask > 0, logits, torch.finfo(logits.dtype).min)
    lse = torch.logsumexp(masked, dim=-1)
    picked = logits.gather(-1, labels[:, None])[:, 0]
    return lse - picked


def make_masked_ce(labelmap, level_weights=None):
    """Top-down masked CE with first-mistake fall-back:

    * level 0: CE over the whole level.
    * level l > 0, while the *predicted* chain has matched gt so far: CE
      over the children of the **gt** parent; after the first mismatch,
      CE over the full level.
    * the returned outputs are −1e8 except at level 0 (all logits) and at
      each level's children-of-the-**predicted**-parent positions.
    """
    slices = _level_slices(labelmap)
    lw = (np.ones(labelmap.n_levels) if level_weights is None
          else np.asarray(level_weights))
    consts = _PerDevice(*[m.astype(np.float32) for m in labelmap.child_masks])

    def loss_fn(logits, level_labels):
        masks = consts.on(logits.device)
        B = logits.shape[0]
        total = torch.zeros((B,), dtype=logits.dtype, device=logits.device)
        outputs = []
        wrong_so_far = torch.zeros((B,), dtype=torch.bool,
                                   device=logits.device)
        pred_prev = None
        for l, (a, b) in enumerate(slices):
            lvl_logits = logits[:, a:b]
            if l == 0:
                loss_l = _ce_from_logits(lvl_logits, level_labels[:, 0])
                pred_l = lvl_logits.argmax(-1)
                outputs.append(lvl_logits)
            else:
                M = masks[l - 1]
                gt_mask = M[level_labels[:, l - 1]]          # (B, n_l)
                pred_mask = M[pred_prev]
                loss_masked = _masked_ce(lvl_logits, gt_mask,
                                         level_labels[:, l])
                loss_full = _ce_from_logits(lvl_logits, level_labels[:, l])
                loss_l = torch.where(wrong_so_far, loss_full, loss_masked)
                neg_inf = torch.finfo(lvl_logits.dtype).min
                pred_l = torch.where(pred_mask > 0, lvl_logits,
                                     neg_inf).argmax(-1)
                outputs.append(torch.where(pred_mask > 0, lvl_logits,
                                           _NEG_FILL))
            total = total + float(lw[l]) * loss_l
            wrong_so_far = wrong_so_far | (pred_l != level_labels[:, l])
            pred_prev = pred_l
        return torch.cat(outputs, dim=-1), total.sum()

    return loss_fn


def multi_label_soft_margin(logits, targets, weight=None):
    """torch MultiLabelSoftMarginLoss: mean over classes of
    −[y·logσ(x) + (1−y)·logσ(−x)], then mean over the batch."""
    term = (targets * F.logsigmoid(logits)
            + (1.0 - targets) * F.logsigmoid(-logits))
    if weight is not None:
        term = term * weight
    return (-term.mean(dim=-1)).mean()


def make_hierarchical_softmax(labelmap):
    """Raw (B, n_classes) linear output → chained hierarchical
    log-probabilities: per level l > 0, each node's logit is log-softmaxed
    within its sibling group and added to its parent's log-probability (a
    masked segment log-sum-exp). Returns (all_log_probs, leaf_log_probs)."""
    slices = _level_slices(labelmap)
    rel_parents = []
    for l in range(1, labelmap.n_levels):
        gstart = labelmap.level_start[l]
        pstart = labelmap.level_start[l - 1]
        rel_parents.append((labelmap.parent_ix[gstart:labelmap.level_stop[l]]
                            - pstart).astype(np.int64))
    L = labelmap.n_levels
    consts = _PerDevice(*[m.astype(np.float32) for m in labelmap.child_masks],
                        *rel_parents)

    def log_probs_fn(raw):
        got = consts.on(raw.device)
        masks, parents = got[:L - 1], got[L - 1:]
        a, b = slices[0]
        out = [F.log_softmax(raw[:, a:b], dim=-1)]
        for l in range(1, L):
            a, b = slices[l]
            x = raw[:, a:b]                                   # (B, n_l)
            M = masks[l - 1]                                  # (n_{l-1}, n_l)
            par = parents[l - 1]                              # (n_l,)
            neg_inf = torch.finfo(x.dtype).min
            seg_max = torch.where(M[None] > 0, x[:, None, :],
                                  neg_inf).amax(-1)           # (B, n_{l-1})
            shifted = torch.exp(x - seg_max[:, par])
            lse = torch.log(shifted @ M.T) + seg_max          # (B, n_{l-1})
            out.append(x - lse[:, par] + out[l - 1][:, par])
        return torch.cat(out, dim=-1), out[-1]

    return log_probs_fn


def hierarchical_softmax_nll(leaf_log_probs, level_labels):
    """NLL on the leaf log-probabilities."""
    return -leaf_log_probs.gather(-1, level_labels[:, -1][:, None]).mean()
