"""Random balanced sampling of anchors and proposals as fixed-shape masks (port of ``models/sampling.py``).

detectron2's ``subsample_labels`` (``modeling/sampling.py``): up to
``num * positive_fraction`` random positives, the rest of ``num`` random
negatives, formulated as ranks under random priorities so that every
shape stays fixed. The priorities are uniform draws: the port's own from a
``torch.Generator``, or handed in (``pri``), which is how the tests feed
the JAX package's ``jax.random.uniform`` draws. ``jnp.argsort`` and
``lax.top_k`` break ties by the lowest index; so do the stable sorts here.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _rank_within(mask: Tensor, pri: Tensor) -> Tensor:
    """0-based rank of each True entry of ``mask`` (..., N) by ascending
    priority; False entries get N."""
    n = mask.shape[-1]
    pri = torch.where(mask, pri, torch.full_like(pri, torch.inf))
    order = torch.sort(pri, dim=-1, stable=True).indices
    rank = torch.empty_like(order).scatter_(-1, order, torch.arange(n, device=mask.device).expand_as(order))
    return torch.where(mask, rank, torch.full_like(rank, n))


def subsample_labels(labels: Tensor, num_samples: int, positive_fraction: float,
                     pri_pos: Tensor, pri_neg: Tensor) -> tuple[Tensor, Tensor]:
    """labels (..., N) in {-1 ignore, 0 negative, 1 positive} -> (pos_mask,
    neg_mask): the positives' quota ``int(num * fraction)`` capped by the
    positives there are, the negatives filling the rest of ``num``.
    ``pri_pos``/``pri_neg`` (..., N) are the uniform priorities (the JAX
    function draws them from its key's two halves)."""
    pos, neg = labels == 1, labels == 0
    max_pos = int(num_samples * positive_fraction)
    pos_sel = pos & (_rank_within(pos, pri_pos) < max_pos)
    neg_quota = num_samples - pos_sel.sum(dim=-1, keepdim=True)
    neg_sel = neg & (_rank_within(neg, pri_neg) < neg_quota)
    return pos_sel, neg_sel


def gather_topk_mask(mask: Tensor, k: int, pri: Tensor) -> tuple[Tensor, Tensor]:
    """Up to k indices (..., k) where ``mask`` (..., N) is True, by
    descending priority ``pri`` (uniform draws, or scores), and their
    validity (..., k): the fixed-shape bridge from a selection mask to a
    gathered subset."""
    pri = torch.where(mask, pri, torch.full_like(pri, -torch.inf))
    vals, idx = torch.sort(pri, dim=-1, descending=True, stable=True)
    return idx[..., :k], torch.isfinite(vals[..., :k])
