"""The temporal model's fused score head: kernels K10 and K11, their
plain versions, and the autograd seam between them.

``score_head`` is the port of the JAX package's
``ops/pallas_head.py::score_head``: x [T, S, D] -> [T, S] float32 scores
``relu(x . w1 + b1) . w2 + b2`` without the [T, S, H] hidden ever
reaching memory.  Like the reference's ``jax.custom_vjp`` ``_head_diff``
(``:244-258``) it has two faces:

- with no gradient to take, the forward alone: kernel K10
  (``csrc/score_head.cu``, the reference's ``_fwd_kernel`` ``:72``);
- under autograd, :class:`ScoreHead`: the same forward, and in the
  backward kernel K11 (the reference's ``_bwd_kernel`` ``:90``), which
  recomputes the hidden and gives dx and the four weight gradients.

Both kernels have two routes, chosen inside the library by D and H
alone (:func:`tensor_core_route` asks it): tensor cores for D <= 128
and H <= 256, the CUDA-core kernels elsewhere; K10's scores and K11's
dx are the same bits on both.

On CUDA tensors each wrapper launches its kernel or raises; on CPU
tensors it runs its plain version.  The plain versions follow the
kernels' arithmetic (``pallas_head.py:21-29``, ``:72-128``), not dense
autograd's:

- each matmul takes bf16 operands with an f32 sum, rounded to bf16; b1
  is added in bf16, then relu; the same for w2 and b2; the scores are
  cast to f32;
- dw2 = h^T . bf16(ds) and db2 = sum ds, in f32; dh = bf16(h > 0 ?
  ds w2 : 0), the product in f32; db1 = sum dh and dw1 = x^T . dh, in
  f32; dx = bf16(dh . w1^T); the weight gradients are cast to the
  params' dtypes and dx to x's.

So the backward differs from differentiating the dense head: dh is
rounded to bf16, and relu's gradient at 0 is 0 (``torch.maximum``'s is
half the cotangent).

The kernels take any D and H.  D is padded with zero columns to a
multiple of 8 on the way in (the kernels read rows in 16-byte vectors),
which adds nothing to any product; dx's padded columns are dropped.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..kernels.build import Kernel, KernelLaunchError, library, require_cuda
from .cuda_mlp import bf16_linear, relu

_P = ctypes.c_void_p
_I = ctypes.c_int
_HEAD_FWD = Kernel("score_head_fwd", "agac_score_head_fwd",
                   [_P] * 6 + [_I, _I, _I])
_HEAD_BWD = Kernel("score_head_bwd", "agac_score_head_bwd",
                   [_P] * 8 + [_I, _I, _I, _I])

#: the kernels read rows of x in 16-byte vectors: D in multiples of 8
WIDTH_MULTIPLE = 8

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor]


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16-valued operands in full f32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return a.float() @ b.float()


def _hidden(x2: torch.Tensor, w1: torch.Tensor,
            b1: torch.Tensor) -> torch.Tensor:
    """h = relu(bf16(bf16(x . w1) + b1)) [N, H] bf16 of rows [N, D]."""
    return relu(bf16_linear(x2.to(torch.bfloat16), w1, b1))


def score_head_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The plain version of kernel K10: [..., D] -> [...] float32."""
    h = _hidden(x, w1, b1)
    return bf16_linear(h, w2, b2)[..., 0].float()


def score_head_bwd_plain(x: torch.Tensor, w1: torch.Tensor,
                         b1: torch.Tensor, w2: torch.Tensor,
                         b2: torch.Tensor, ds: torch.Tensor) -> Grads:
    """The plain version of kernel K11: (dx in x's dtype and shape, dw1,
    db1, dw2, db2 in the params' dtypes) from the f32 cotangent ``ds`` of
    the scores (x's shape without D)."""
    D = x.shape[-1]
    x2 = x.reshape(-1, D).to(torch.bfloat16)
    h = _hidden(x2, w1, b1)                                  # [N, H]
    dsf = ds.reshape(-1, 1).float()                          # [N, 1]
    dw2 = _f32_matmul(h.t(), dsf.to(torch.bfloat16))         # [H, 1]
    db2 = dsf.sum(dim=0)                                     # [1]
    dh = torch.where(h > 0, dsf * w2.float().t(),
                     0.0).to(torch.bfloat16)                 # [N, H]
    db1 = dh.float().sum(dim=0)
    dw1 = _f32_matmul(x2.t(), dh)                            # [D, H]
    dx = _f32_matmul(dh, w1.t()).to(x.dtype).reshape(x.shape)
    return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2.dtype))


def _gate_uncertain(x2, w1, b1) -> torch.Tensor:
    """True on every unit whose relu gate another f32 order of x . w1
    could flip: its pre-activation lies within the order's error bound
    (D ulps of f32 of sum |x w1|) plus one bf16 ulp of zero."""
    acc = _f32_matmul(x2, w1)
    err = x2.shape[-1] * 2.0 ** -24 * _f32_matmul(x2.abs(), w1.abs())
    ulp = torch.exp2(torch.floor(torch.log2(
        acc.abs().clamp_min(2.0 ** -126))) - 7)
    return (acc + b1.float()).abs() <= 2 * err + ulp


def score_head_magnitude(x: torch.Tensor, w1: torch.Tensor,
                         b1: torch.Tensor, w2: torch.Tensor,
                         b2: torch.Tensor) -> torch.Tensor:
    """What each score sums, in absolute value, f32 [...]: |h| . |w2| +
    |b2|.  Another f32 order of x . w1 rounds an h one bf16 ulp the
    other way at most, so kernel and plain version are compared in bf16
    ulps of this (``parity.scores_close``)."""
    h = _hidden(x, w1, b1)
    return (_f32_matmul(h.abs(), w2.abs())[..., 0]
            + b2.float().abs())


def score_head_dx_magnitude(x: torch.Tensor, w1: torch.Tensor,
                            b1: torch.Tensor, w2: torch.Tensor,
                            b2: torch.Tensor,
                            ds: torch.Tensor) -> torch.Tensor:
    """What each element of dx sums over the hidden units, in absolute
    value, f32 in x's shape: |dh| . |w1|^T, with |dh| = |ds w2| on every
    unit the relu passes.  A relu gate that another f32 order of x . w1
    can flip moves dx by the unit's whole term, so such a unit counts
    2**7 times here, and two bf16 ulps of the magnitude cover it
    (``parity.scores_close`` with this as ``scale``)."""
    D = x.shape[-1]
    x2 = x.reshape(-1, D).to(torch.bfloat16)
    h = _hidden(x2, w1, b1)
    weight = torch.where(_gate_uncertain(x2, w1, b1), 2.0 ** 7,
                         (h > 0).float())
    dh = weight * (ds.reshape(-1, 1).float() * w2.float().t()).abs()
    return _f32_matmul(dh, w1.abs().t()).reshape(x.shape)


#: K11's weight gradients against their plain version: the shares of the
#: root sum of squares and of the absolute sum of each gradient's terms
#: that :func:`score_head_weight_grad_limits` allows
RSS_SHARE = 2.0 ** -6
ORDER_SHARE = 2.0 ** -14


def score_head_weight_grad_limits(
        x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
        w2: torch.Tensor, b2: torch.Tensor, ds: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """How far each weight gradient of the head (dw1, db1, dw2, db2, f32
    in their shapes) may lie from its plain version's, before the cast
    to the params' dtype (:func:`weight_grad_error` adds one ulp of
    that).

    Each sums one term a row: x dh, dh, h bf16(ds) and ds.  Over many
    rows of random sign such a sum cancels to about the root sum of
    squares (rss) of its terms, far below their absolute sum, so a limit
    in ulps of the absolute sum would pass a kernel that lost most of
    its rows.  The limit is instead the sum of:

    - ``RSS_SHARE`` (2**-6) of the rss: another f32 order of x . w1
      rounds an h one bf16 ulp (2**-8) the other way, with a random
      sign, on a share of the rows;
    - ``ORDER_SHARE`` (2**-14) of the absolute sum: the worst f32 error
      of adding the terms in another order, for chains of up to 1024
      additions;
    - for dw1 and db1, the absolute sum of the terms of every unit whose
      relu gate another order can flip (such a flip adds or drops the
      whole term).

    Losing half of the rows moves a cancelling sum by about 0.7 of its
    rss and a sum that does not cancel by half of its absolute sum; the
    limit is a few hundredths of the rss at these shapes."""
    D = x.shape[-1]
    x2 = x.reshape(-1, D).to(torch.bfloat16)
    xf = x2.float()
    h = _hidden(x2, w1, b1).float()
    dsf = ds.reshape(-1, 1).float()
    ds_b = dsf.to(torch.bfloat16).float()
    g = (dsf * w2.float().t()).to(torch.bfloat16).float().abs()   # [N, H]
    dh = torch.where(h > 0, g, 0.0)
    flip = torch.where(_gate_uncertain(x2, w1, b1), g, 0.0)

    def limit(sq, total, flipped=0.0):
        return RSS_SHARE * sq.sqrt() + ORDER_SHARE * total + flipped

    xa = xf.abs()
    return (limit(_f32_matmul(xf.square().t(), dh.square()),
                  _f32_matmul(xa.t(), dh), _f32_matmul(xa.t(), flip)),
            limit(dh.square().sum(dim=0), dh.sum(dim=0), flip.sum(dim=0)),
            limit(_f32_matmul(h.square().t(), ds_b.square()),
                  _f32_matmul(h.t(), ds_b.abs())),
            limit(dsf.square().sum(dim=0), dsf.abs().sum(dim=0)))


def weight_grad_error(got: torch.Tensor, want: torch.Tensor,
                      limit: torch.Tensor) -> float:
    """max |got - want| / (limit + one ulp of got's dtype at |want|): a
    weight gradient passes at <= 1 (``limit`` from
    :func:`score_head_weight_grad_limits`; the ulp covers a sum that
    another order puts on the other side of the cast's rounding)."""
    eps = torch.finfo(got.dtype).eps
    got, want = got.double().cpu(), want.double().cpu()
    ulp = torch.exp2(torch.floor(torch.log2(
        want.abs().clamp_min(2.0 ** -126)))) * eps
    return float(((got - want).abs() / (limit.double().cpu() + ulp)).max())


def _layout(name: str, x: torch.Tensor, w1, b1, w2, b2):
    """(x as contiguous bf16 [N, Dp], w1 as contiguous [Dp, H], b1, w2,
    b2 contiguous, N, D, H) for the kernels, D zero-padded to Dp, a
    multiple of :data:`WIDTH_MULTIPLE`; or ValueError.  x and w1 are
    taken as they are (views, no copy) where they need no padding, cast
    or realignment."""
    D = x.shape[-1]
    H = w1.shape[-1] if w1.dim() == 2 else -1
    want = {"w1": (D, H), "b1": (H,), "w2": (H, 1), "b2": (1,)}
    for k, p in zip(want, (w1, b1, w2, b2)):
        if p.dtype != torch.bfloat16 or tuple(p.shape) != want[k] or H < 1:
            raise ValueError(f"{name}: {k} must be bfloat16 {want[k]} with "
                             f"H >= 1, got {p.dtype} {tuple(p.shape)}")
    pad = -D % WIDTH_MULTIPLE
    x2 = x.reshape(-1, D).to(torch.bfloat16)
    if pad or not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = torch.nn.functional.pad(x2, (0, pad)).contiguous()
    w1p = (torch.nn.functional.pad(w1, (0, 0, 0, pad)) if pad
           else w1).contiguous()
    N = x2.shape[0]
    if N >= 2 ** 31 - 64 or x2.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes fewer than 2**31 rows, "
                         f"16-byte aligned")
    return (x2, w1p, b1.contiguous(), w2.contiguous(), b2.contiguous(), N,
            D, H)


def _operands(name: str, x: torch.Tensor, w1, b1, w2, b2):
    """(device, then :func:`_layout`'s operands) of tensors that lie on
    one CUDA device; or ValueError."""
    dev = require_cuda(name, x, w1, b1, w2, b2)
    return (dev, *_layout(name, x, w1, b1, w2, b2))


def score_head_forward(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                       w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x [..., D] -> [...] float32 scores: kernel K10 on CUDA tensors,
    :func:`score_head_plain` on CPU tensors."""
    if all(t.device.type == "cpu" for t in (x, w1, b1, w2, b2)):
        return score_head_plain(x, w1, b1, w2, b2)
    dev, x2, w1p, b1c, w2c, b2c, N, D, H = _operands(
        "score_head", x, w1, b1, w2, b2)
    out = torch.empty(N, dtype=torch.float32, device=dev)
    if N:
        _HEAD_FWD(dev, x2, w1p, b1c, w2c, b2c, out, N, x2.shape[1], H)
    return out.reshape(x.shape[:-1])


def score_head_bwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor,
                   ds: torch.Tensor) -> Grads:
    """(dx, dw1, db1, dw2, db2) of the head from the f32 cotangent ``ds``
    of its scores: kernel K11 on CUDA tensors, :func:`score_head_bwd_plain`
    on CPU tensors."""
    if all(t.device.type == "cpu" for t in (x, w1, b1, w2, b2, ds)):
        return score_head_bwd_plain(x, w1, b1, w2, b2, ds)
    dev, x2, w1p, b1c, w2c, _, N, D, H = _operands(
        "score_head_bwd", x, w1, b1, w2, b2)
    require_cuda("score_head_bwd", x2, ds)
    if tuple(ds.shape) != tuple(x.shape[:-1]):
        raise ValueError(f"score_head_bwd: ds {tuple(ds.shape)} must be "
                         f"{tuple(x.shape[:-1])}")
    Dp = x2.shape[1]
    n = Dp * H + 2 * H + 1
    dx = torch.empty_like(x2)
    sums = torch.zeros(n, dtype=torch.float32, device=dev)
    if N:
        ctas = _bwd_ctas(dev, N, Dp, H)
        partials = torch.empty((ctas, n), dtype=torch.float32, device=dev)
        _HEAD_BWD(dev, x2, ds.float().contiguous(), w1p, b1c, w2c, dx,
                  partials, sums, N, Dp, H, ctas)
    dw1 = sums[:Dp * H].reshape(Dp, H)[:D]
    db1, dw2, db2 = sums[Dp * H:Dp * H + H], sums[Dp * H + H:-1], sums[-1:]
    return (dx[:, :D].to(x.dtype).reshape(x.shape), dw1.to(w1.dtype),
            db1.to(b1.dtype), dw2.reshape(H, 1).to(w2.dtype),
            db2.to(b2.dtype))


def tensor_core_route(D: int, H: int) -> bool:
    """Whether K10 and K11 take their tensor-core route for rows of width
    D (padded by the wrapper to a multiple of 8) and H hidden units.  The
    library alone decides (``agac_score_head_tc_route``); this asks it, so
    it builds the kernels and needs the CUDA toolkit."""
    fn = library().agac_score_head_tc_route
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return bool(fn(D + -D % WIDTH_MULTIPLE, H))


def _bwd_ctas(dev: torch.device, N: int, Dp: int, H: int) -> int:
    """The CTAs of K11's persistent grid for these sizes on ``dev`` (as
    many as the card holds at once, fewer for few rows), so the rows of
    per-CTA partials to allocate."""
    fn = library().agac_score_head_bwd_ctas
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        ctas = fn(N, Dp, H)
    if ctas <= 0:
        raise KernelLaunchError(
            f"agac_score_head_bwd_ctas failed: CUDA error {-ctas}")
    return ctas


class ScoreHead(torch.autograd.Function):
    """The head's VJP (the reference's ``_head_diff_fwd`` /
    ``_head_diff_bwd``): the forward saves x and the params, the
    backward recomputes the hidden (K11) and returns dx and the weight
    gradients in their own dtypes."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return score_head_forward(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, ds):
        return score_head_bwd(*ctx.saved_tensors, ds.float().contiguous())


def score_head(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x [..., D] -> [...] float32 fused-head scores: :class:`ScoreHead`
    (K10, then K11 in the backward) when autograd records and an input
    requires a gradient, else the forward alone (K10); on CPU tensors,
    their plain versions."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        return ScoreHead.apply(x, w1, b1, w2, b2)
    return score_head_forward(x, w1, b1, w2, b2)
