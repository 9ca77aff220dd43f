"""Kernel K2: the fused weight quantizer, and its plain version.

``plan_weights_cuda`` is the port of the JAX package's
``ops/pallas_weights.py::plan_weights_pallas`` (kernel ``_kernel``,
``:47``): masked softmax over E, the all-masked guard
``m > finfo.min / 2``, the 1e-30 denominator clamp, x255, round half to
even, int32, 0 where masked.  On a CUDA tensor it launches
``csrc/plan_weights.cu`` (see the bound and design notes there); on a
CPU tensor it runs :func:`plan_block`, the same math in PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels.build import Kernel, require_cuda
from .weights import MAX_WEIGHT

_PLAN = Kernel("plan_weights", "agac_plan_weights",
               [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int])


def plan_block(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked softmax + scale-to-255 + round on [G, E] (the plain
    version of kernel K2, ``pallas_weights.py::plan_block``).  The
    ``m > neg * 0.5`` guard zeroes the max of all-masked rows so ``exp``
    does not overflow, and the 1e-30 clamp keeps the division finite."""
    neg = torch.finfo(torch.float32).min
    masked = torch.where(mask, scores.float(), neg)
    m = masked.amax(dim=-1, keepdim=True)
    m = torch.where(m > neg * 0.5, m, 0.0)
    e = torch.where(mask, torch.exp(masked - m), 0.0)
    denom = e.sum(dim=-1, keepdim=True)
    p = torch.where(denom > 0, e / denom.clamp_min(1e-30), 0.0)
    return torch.where(mask, torch.round(p * MAX_WEIGHT),
                       0.0).to(torch.int32)


def plan_weights_cuda(scores: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """scores [G, E] float + mask [G, E] bool -> int32 weights [G, E]
    (temperature 1): kernel K2 on CUDA tensors, :func:`plan_block` on
    CPU tensors."""
    if scores.device.type == "cpu" and mask.device.type == "cpu":
        return plan_block(scores, mask)
    dev = require_cuda("plan_weights_cuda", scores, mask)
    if scores.dim() != 2 or scores.shape != mask.shape:
        raise ValueError(f"plan_weights_cuda: scores {tuple(scores.shape)} "
                         f"and mask {tuple(mask.shape)} must be one [G, E]")
    if mask.dtype != torch.bool:
        raise ValueError("plan_weights_cuda: mask must be bool")
    s = scores.to(torch.float32).contiguous()
    m = mask.contiguous()
    G, E = s.shape
    out = torch.empty((G, E), dtype=torch.int32, device=dev)
    if out.numel():
        _PLAN(dev, s, m, out, G, E)
    return out
