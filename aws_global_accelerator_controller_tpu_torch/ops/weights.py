"""Batched endpoint traffic-weight planner (plain PyTorch).

Global Accelerator endpoint weights are integers in [0, 255].  The
planner turns per-endpoint scores into a weight allocation per endpoint
group:

    weights = round(255 * masked_softmax(scores / temperature))

Shapes are [G, E] (groups x endpoints), padded with ``mask == False``.
The counterpart of the JAX package's ``ops/weights.py``.
"""
from __future__ import annotations

import torch

MAX_WEIGHT = 255.0


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """Numerically stable softmax over valid (mask=True) entries.

    Invalid entries get probability 0; an all-invalid row returns zeros
    (not NaN), which matters for padded groups.
    """
    neg = torch.finfo(scores.dtype).min
    masked = torch.where(mask, scores, neg)
    m = masked.amax(dim=dim, keepdim=True)
    # guard the all-masked row: max is `neg`, subtracting would overflow
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.where(mask, torch.exp(masked - m), 0.0)
    denom = e.sum(dim=dim, keepdim=True)
    return torch.where(denom > 0, e / denom.clamp_min(1e-30), 0.0)


def plan_weights(scores: torch.Tensor, mask: torch.Tensor,
                 temperature: float = 1.0) -> torch.Tensor:
    """scores [G, E] float, mask [G, E] bool -> int32 weights [G, E].

    Valid endpoints share 255 proportionally to softmax(score/T); padded
    slots get 0.  Scores may be bfloat16: the softmax runs in float32,
    and rounding is half to even.
    """
    s = scores.float() / temperature
    p = masked_softmax(s, mask)
    w = torch.round(p * MAX_WEIGHT).to(torch.int32)
    return torch.where(mask, w, 0)
