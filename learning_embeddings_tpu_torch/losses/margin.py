"""Margin edge losses and the label-only negative sampler: the port of
``learning_embeddings_tpu/losses/margin.py``.

All losses are sums over the batch, not means, as in the JAX package.
Negative layout: for positive i and pass r ∈ [0, R), slot 2R·i + r holds
(u_i, corrupted v) and slot 2R·i + R + r (corrupted u, v_i).

The sampler draws on the device, from an explicit device
``torch.Generator``: uniform over each node's negative candidates,
optionally one level per pass, the same distribution and layout as the
JAX sampler's ``jax.random.categorical`` (the draws themselves differ).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..geometry import ENERGY_FNS

__all__ = ["NegativeSampler", "masked_uniform_categorical",
           "make_negative_sampler", "level_weights_for_nodes",
           "degree_neg_weights", "margin_loss", "simple_euclidean_nll_loss",
           "vendrov_ranking_loss", "variant_loss", "eval_edge_energies"]


class NegativeSampler(NamedTuple):
    """(generator, pos_from, pos_to) -> (neg_from, neg_to), each (B·2R,)."""

    sample: Callable
    neg_to_pos_ratio: int


def masked_uniform_categorical(generator: torch.Generator,
                               mask: torch.Tensor) -> torch.Tensor:
    """mask: (..., n) bool -> a uniform index over the True entries of each
    row; a row with no True entry falls back to the whole row. Gumbel-max
    with equal logits, which is the argmax of i.i.d. uniforms over the
    candidates."""
    safe = mask | ~mask.any(-1, keepdim=True)
    u = torch.rand(mask.shape, generator=generator, device=mask.device)
    return torch.where(safe, u, -1.0).argmax(-1)


def make_negative_sampler(negatives: np.ndarray, neg_to_pos_ratio: int, *,
                          level_start: Optional[np.ndarray] = None,
                          level_stop: Optional[np.ndarray] = None,
                          pick_per_level: bool = False,
                          device="cpu") -> NegativeSampler:
    """A sampler over a boolean negative adjacency (n, n), True where
    (i, j) is a negative pair, kept on `device`. With `pick_per_level` the
    corrupted node of pass r is restricted to level r % n_levels (nodes
    past the last level never qualify); a row with no candidate at that
    level falls back to the whole row (every node)."""
    neg = torch.as_tensor(np.asarray(negatives, bool), device=device)
    neg_t = neg.T.contiguous()
    n = neg.shape[0]
    R = int(neg_to_pos_ratio)
    if pick_per_level:
        node_ix = np.arange(n)
        level_masks = np.stack(
            [(node_ix >= a) & (node_ix < b)
             for a, b in zip(np.asarray(level_start), np.asarray(level_stop))])
        pass_mask = torch.as_tensor(level_masks[np.arange(R)
                                                % len(level_masks)],
                                    device=device)                  # (R, n)
    else:
        pass_mask = torch.ones((R, n), dtype=torch.bool, device=device)

    def sample(generator, pos_from, pos_to):
        B = pos_from.shape[0]
        # corrupt the 'to' side: candidates negatives[u, :] ∩ level(pass)
        corrupted_to = masked_uniform_categorical(
            generator, neg[pos_from][:, None, :] & pass_mask[None])  # (B, R)
        # corrupt the 'from' side: candidates negatives[:, v] ∩ level(pass)
        corrupted_from = masked_uniform_categorical(
            generator, neg_t[pos_to][:, None, :] & pass_mask[None])
        nf = torch.cat([pos_from[:, None].expand(B, R), corrupted_from], 1)
        nt = torch.cat([corrupted_to, pos_to[:, None].expand(B, R)], 1)
        return nf.reshape(-1), nt.reshape(-1)

    return NegativeSampler(sample=sample, neg_to_pos_ratio=R)


def level_weights_for_nodes(nodes: torch.Tensor, level_stop: np.ndarray,
                            level_weights) -> torch.Tensor:
    """Per-edge weight from the level of the `to` node; nodes past the last
    level boundary (images) weigh 1."""
    stops = torch.as_tensor(np.asarray(level_stop), dtype=nodes.dtype,
                            device=nodes.device)
    lw = torch.as_tensor(np.asarray(level_weights, np.float32),
                         device=nodes.device)
    level = torch.searchsorted(stops, nodes, right=True)
    in_range = level < lw.shape[0]
    return torch.where(in_range, lw[torch.clamp_max(level, lw.shape[0] - 1)],
                       1.0)


def degree_neg_weights(neg_from, neg_to, in_deg, out_deg,
                       neg_to_pos_ratio: int, n_nodes: int) -> torch.Tensor:
    """Every corrupted edge weighs n_nodes/R × 1/deg_tc(corrupted node):
    the closure in-degree of a corrupted 'to' node (the first R slots of
    each positive) or the out-degree of a corrupted 'from' node (the last
    R); degree 0 gives no degree factor."""
    R = neg_to_pos_ratio
    slot = torch.arange(neg_from.shape[0], device=neg_from.device) % (2 * R)
    deg = torch.where(slot < R, in_deg[neg_to], out_deg[neg_from]).float()
    factor = torch.where(deg > 0, 1.0 / torch.clamp_min(deg, 1.0), 1.0)
    return (float(n_nodes) / R) * factor


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


def eval_edge_energies(emb_from, emb_to, status, *, energy: str, alpha: float,
                       **energy_kw):
    """Eval loss and energies of pre-generated edges split by a status flag
    (1 = positive): returns (loss, e, is_pos)."""
    e = ENERGY_FNS[energy](emb_from, emb_to, **energy_kw)
    is_pos = status == 1
    loss = (torch.where(is_pos, e, 0.0).sum()
            + torch.where(is_pos, 0.0, torch.clamp_min(alpha - e, 0.0)).sum())
    return loss, e, is_pos
