"""Margin edge losses for the joint trainers: the port of
``learning_embeddings_tpu/losses/margin.py`` (lines 147-222).

All losses are sums over the batch, not means, as in the JAX package.
Negative layout: for positive i and pass r ∈ [0, R), slot 2R·i + r holds
(u_i, corrupted v) and slot 2R·i + R + r (corrupted u, v_i).

The label-only on-device sampler (lines 63-145) waits for the label-only
slice (ROADMAP.md queue A item 17).
"""

from __future__ import annotations

import torch

from ..geometry import ENERGY_FNS

__all__ = ["margin_loss", "simple_euclidean_nll_loss",
           "vendrov_ranking_loss", "variant_loss"]


def margin_loss(emb_pos_from, emb_pos_to, emb_neg_from, emb_neg_to, *,
                energy: str, alpha: float, pos_weights=None,
                neg_weights=None, **energy_kw):
    """Σ w⁺·E⁺ + Σ w⁻·max(0, α − E⁻). Returns (loss, (e_pos, e_neg))."""
    efn = ENERGY_FNS[energy]
    e_pos = efn(emb_pos_from, emb_pos_to, **energy_kw)
    e_neg = efn(emb_neg_from, emb_neg_to, **energy_kw)
    pw = 1.0 if pos_weights is None else pos_weights
    nw = 1.0 if neg_weights is None else neg_weights
    loss = ((pw * e_pos).sum()
            + (nw * torch.clamp_min(alpha - e_neg, 0.0)).sum())
    return loss, (e_pos, e_neg)


def simple_euclidean_nll_loss(emb_pos_from, emb_pos_to, emb_neg_from,
                              emb_neg_to, neg_to_pos_ratio: int):
    """NLL of softmax(−d²) over {positive, its negatives}:
    loss_i = d²(u_i, v_i) + log(Σ_j exp(−d²(u'_ij, v'_ij)) + exp(0)).
    Returns (loss, (d_pos, d_neg))."""
    d_pos = ((emb_pos_to - emb_pos_from) ** 2).sum(-1)       # (B,)
    d_neg = ((emb_neg_to - emb_neg_from) ** 2).sum(-1)       # (2RB,)
    B = d_pos.shape[0]
    d_neg_b = d_neg.reshape(B, 2 * neg_to_pos_ratio)
    loss = (d_pos + torch.log(torch.exp(-d_neg_b).sum(1) + 1.0)).sum()
    return loss, (d_pos, d_neg)


def vendrov_ranking_loss(emb_pos_from, emb_pos_to, emb_neg_from, emb_neg_to,
                         *, energy: str, alpha: float,
                         neg_to_pos_ratio: int, **energy_kw):
    """Max-margin ranking loss S_i = Σ_j max(0, α − s⁺_i + s⁻_ij) with
    s = −E. Returns (loss, (e_pos, e_neg))."""
    efn = ENERGY_FNS[energy]
    e_pos = efn(emb_pos_from, emb_pos_to, **energy_kw)       # (B,)
    e_neg = efn(emb_neg_from, emb_neg_to, **energy_kw)       # (2RB,)
    B = e_pos.shape[0]
    e_neg_b = e_neg.reshape(B, 2 * neg_to_pos_ratio)
    margins = torch.clamp_min(alpha + e_pos[:, None] - e_neg_b, 0.0)
    return margins.sum(), (e_pos, e_neg)


def variant_loss(variant: str, emb_pos_from, emb_pos_to, emb_neg_from,
                 emb_neg_to, *, energy: str, alpha: float,
                 neg_to_pos_ratio: int, **energy_kw):
    """'margin', 'vendrov' or 'nll'. Returns (loss, (e_pos, e_neg))."""
    embs = (emb_pos_from, emb_pos_to, emb_neg_from, emb_neg_to)
    if variant == "vendrov":
        return vendrov_ranking_loss(*embs, energy=energy, alpha=alpha,
                                    neg_to_pos_ratio=neg_to_pos_ratio,
                                    **energy_kw)
    if variant == "nll":
        return simple_euclidean_nll_loss(
            *embs, neg_to_pos_ratio=neg_to_pos_ratio)
    return margin_loss(*embs, energy=energy, alpha=alpha, **energy_kw)
