"""Kernel K6a: causal flash-attention forward, and its plain version.

``flash_attention`` is the port of the JAX package's
``ops/pallas_attention.py::flash_attention`` forward (kernel ``_kernel``,
``:287``, launched by ``_flash`` at ``:379``): q, k, v [T, H, D] ->
[T, H, D], exact softmax attention with the flash online recurrence, the
H axis being independent heads (the temporal model's endpoint streams).
On CUDA tensors it launches ``csrc/flash_attention.cu`` (see the bound and
design notes there); on CPU tensors it runs :func:`flash_attention_plain`
at the kernel's K block.

Arithmetic, shared by the kernel and the plain version (the contract of
``_prescale`` and ``_attend_step``, ``pallas_attention.py:197-270``,
``:346-353``):

- q is pre-scaled by D**-0.5 with one rounding to bf16;
- s = q'.k^T from bf16 operands with f32 sums; masked scores are -1e30
  (causal by global position, and keys past T);
- per K block: m_new = max(m, rowmax s) (m starts at -1e30),
  p = exp(s - m_new) in f32, l = l * exp(m - m_new) + sum(p), and
  acc = acc * exp(m - m_new) + bf16(p) . v with f32 sums;
- o = acc / l, rounded to bf16.

p is rounded against the running max, so the result depends on the K
block partition at the last-ulp level: the plain version takes
``block_k``, and a comparison with the kernel uses the kernel's
:data:`BLOCK_K`.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels.build import Kernel, require_cuda

#: rows of q and keys of k/v per tile of the kernel
BLOCK_K = 64
#: the largest head width the kernel takes (it pads D to 16, 32, 64 or
#: 128 in shared memory and registers)
MAX_HEAD_DIM = 128

_NEG_INF = -1e30

_P = ctypes.c_void_p
_FLASH = Kernel("flash_attention", "agac_flash_attention",
                [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_float, ctypes.c_int])


def _prescale(q: torch.Tensor) -> torch.Tensor:
    """Fold 1/sqrt(D) into q with one rounding to q's dtype."""
    return (q.float() * q.shape[-1] ** -0.5).to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          block_k: int = BLOCK_K) -> torch.Tensor:
    """The plain version of kernel K6a: [T, H, D] -> [T, H, D] in q's
    dtype, the online softmax folded over K blocks of ``block_k`` keys.

    Every query row folds every K block; a block wholly in a row's
    future has all its scores at -1e30, which leaves (m, l, acc) bit for
    bit unchanged, so this equals the kernel's skipping of such blocks.
    """
    T = q.shape[0]
    qh = _prescale(q).transpose(0, 1).float()        # [H, T, D]
    kh = k.transpose(0, 1).float()
    vh = v.transpose(0, 1).float()
    H, _, D = qh.shape
    m = torch.full((H, T, 1), _NEG_INF, device=q.device)
    l = torch.zeros((H, T, 1), device=q.device)
    acc = torch.zeros((H, T, D), device=q.device)
    q_pos = torch.arange(T, device=q.device)[:, None]
    for j0 in range(0, k.shape[0], block_k):
        kb, vb = kh[:, j0:j0 + block_k], vh[:, j0:j0 + block_k]
        s = qh @ kb.transpose(1, 2)                  # [H, T, bk] f32
        if causal:
            k_pos = torch.arange(j0, j0 + kb.shape[1], device=q.device)
            s = torch.where(q_pos >= k_pos[None, :], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vb
        m = m_new
    return (acc / l).to(q.dtype).transpose(0, 1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q, k, v [T, H, D] bfloat16 -> [T, H, D] bfloat16: kernel K6a on
    CUDA tensors (contiguous and 16-byte aligned, D <=
    :data:`MAX_HEAD_DIM` and a multiple of 8), :func:`flash_attention_plain`
    at :data:`BLOCK_K` on CPU tensors."""
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return flash_attention_plain(q, k, v, causal, BLOCK_K)
    dev = require_cuda("flash_attention", q, k, v)
    if not (q.shape == k.shape == v.shape) or q.dim() != 3:
        raise ValueError(f"flash_attention: q, k, v must be one [T, H, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if any(x.dtype != torch.bfloat16 for x in (q, k, v)):
        raise ValueError("flash_attention: the kernel takes bfloat16 q, k, v")
    if not all(x.is_contiguous() for x in (q, k, v)):
        raise ValueError("flash_attention: the kernel takes contiguous "
                         "q, k, v")
    T, H, D = q.shape
    if D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"flash_attention: the kernel takes D <= "
                         f"{MAX_HEAD_DIM}, a multiple of 8; got D={D}")
    if -(-T // BLOCK_K) > 65535:
        raise ValueError(f"flash_attention: T={T} exceeds the kernel's grid "
                         f"({65535 * BLOCK_K} rows)")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention: the kernel reads q, k, v in "
                         "16-byte vectors; their storage must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    if out.numel():
        _FLASH(dev, q, k, v, out, T, H, D, D ** -0.5, int(causal))
    return out
