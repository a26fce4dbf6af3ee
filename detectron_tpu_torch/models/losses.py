"""Detection losses.

The port of ``detectron_tpu/models/losses.py``: every loss is weighted by
masks (padding-aware) and reduced with an explicit normalizer, so padded
entries contribute exactly nothing.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F


def smooth_l1(pred, target, sigma: float = 1.0):
    """Elementwise smooth-L1 in the sigma form:
    ``0.5*(sigma*x)^2`` if ``|x| < 1/sigma^2`` else ``|x| - 0.5/sigma^2``."""
    s2 = sigma * sigma
    diff = pred - target
    a = diff.abs()
    return torch.where(a < 1.0 / s2, 0.5 * s2 * diff * diff, a - 0.5 / s2)


def smooth_l1_beta(pred, target, beta: float):
    """Detectron's beta form: ``0.5*x^2/beta`` if ``|x| < beta`` else
    ``|x| - beta/2``."""
    diff = pred - target
    a = diff.abs()
    if beta <= 0.0:
        return a
    return torch.where(a < beta, 0.5 * diff * diff / beta, a - 0.5 * beta)


def softmax_cross_entropy(logits, labels, weights=None, normalizer=None):
    """Mean cross-entropy over weighted entries; logits ``[N, K]``, labels
    int ``[N]``."""
    ll = F.log_softmax(logits, dim=-1)
    ce = -torch.gather(ll, -1, labels[..., None].long())[..., 0]
    if weights is None:
        weights = torch.ones_like(ce)
    if normalizer is None:
        normalizer = weights.sum().clamp_min(1.0)
    return (ce * weights).sum() / normalizer


def optax_sigmoid_ce(logits, labels):
    """Numerically stable sigmoid cross-entropy, optax's formula."""
    return logits.clamp_min(0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits, labels_onehot, alpha: float = 0.25, gamma: float = 2.0,
                       weights=None, normalizer=None):
    """Focal loss ``-alpha_t (1-p_t)^gamma log(p_t)`` summed over the last
    axis, weighted per anchor and divided by ``max(normalizer, 1)``."""
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, labels_onehot)
    p_t = p * labels_onehot + (1.0 - p) * (1.0 - labels_onehot)
    alpha_t = alpha * labels_onehot + (1.0 - alpha) * (1.0 - labels_onehot)
    loss = (alpha_t * ((1.0 - p_t) ** gamma) * ce).sum(-1)
    if weights is not None:
        loss = loss * weights
    if normalizer is None:
        normalizer = 1.0
    normalizer = torch.as_tensor(normalizer, dtype=loss.dtype, device=loss.device)
    return loss.sum() / normalizer.clamp_min(1.0)


def mask_bce_loss(mask_logits, mask_targets, class_ids, weights, normalizer=None):
    """Sigmoid cross-entropy on each RoI's own class channel only.

    mask_logits ``[R, M, M, K]``; mask_targets ``[R, M, M]`` in {0, 1};
    class_ids ``[R]`` (1-based, channel ``k - 1`` is used); weights ``[R]``.
    """
    k = torch.clamp(class_ids.long() - 1, 0, mask_logits.shape[-1] - 1)
    own = torch.take_along_dim(mask_logits, k[:, None, None, None], dim=-1)[..., 0]
    per_roi = optax_sigmoid_ce(own, mask_targets).mean(dim=(1, 2))
    if normalizer is None:
        normalizer = weights.sum().clamp_min(1.0)
    return (per_roi * weights).sum() / normalizer
