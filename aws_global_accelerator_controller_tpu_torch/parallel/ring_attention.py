"""The dense attention oracle of the JAX package's
``parallel/ring_attention.py``.

Only ``attention_reference`` (``:52-67``) is ported: the temporal model's
``attention="reference"`` path and the yardstick its flash path is held
to.  The ring itself, sharding the time axis over devices, waits for a
later slice.
"""
from __future__ import annotations

import torch

_NEG_INF = -1e30  # finite stand-in: exp(-1e30 - m) underflows to 0 cleanly


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Dense softmax attention: q, k, v [T, H, D] -> [T, H, D] float32,
    causal by global position when asked."""
    q, k, v = (x.float() for x in (q, k, v))
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("thd,shd->hts", q, k) * scale       # [H, T, S]
    if causal:
        t, srange = q.shape[0], k.shape[0]
        mask = (torch.arange(t, device=q.device)[:, None]
                >= torch.arange(srange, device=q.device)[None, :])
        s = torch.where(mask[None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hts,shd->thd", p, v)
