"""The loss the model families share (the JAX package's
``models/common.py::masked_ce_loss``, ``:16-28``).

The optimizer and the train step wait for the training slice.
"""
from __future__ import annotations

import torch

from ..ops.weights import masked_softmax


def masked_ce_loss(scores: torch.Tensor, mask: torch.Tensor,
                   target: torch.Tensor) -> torch.Tensor:
    """Cross-entropy between masked_softmax(scores) and the target weight
    distribution, averaged over groups with >= 1 valid endpoint.

    scores and target are [..., G, E], mask [G, E] (or broadcast to
    them); leading dims are batch dims with one loss each, so [G, E]
    inputs give a scalar and [T, G, E] inputs the per-step losses [T].
    """
    p = masked_softmax(scores, mask)
    ce = -torch.where(mask, target * torch.log(p + 1e-9), 0.0).sum(dim=-1)
    valid = mask.any(dim=-1).expand_as(ce)
    return (torch.where(valid, ce, 0.0).sum(dim=-1)
            / valid.sum(dim=-1).clamp_min(1))
