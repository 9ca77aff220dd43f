"""Kernel K3: the fused traffic MLP, and its plain versions.

``forward_cuda`` is the port of the JAX package's
``ops/pallas_mlp.py::forward_pallas`` (kernel ``_kernel``, ``:49``):
three matmuls, two ReLUs and the weight quantizer in one kernel, so only
the int32 weights leave the chip.  ``score_rows_cuda`` runs the same
MLP on packed rows and returns the scores, for the fleet planner.  Both
launch ``csrc/mlp.cu`` on CUDA tensors (see the bound and design notes
there) and run their plain versions, :func:`forward_reference` and
:func:`dense_scores`, on CPU tensors.  The kernel takes any feature
width F and hidden width H (it tiles both): F <= 16 with H in 64, 128,
192 or 256 on the tensor cores (``wgmma``), every other width on the
CUDA cores, and both routes give the same values (the tensor cores'
sums that lie near a bf16 rounding point are summed again in the CUDA
cores' order).

Arithmetic order, shared by kernel and plain version: bf16 operands,
f32 accumulation, each matmul rounded to bf16, the bf16 bias added with
one more rounding to bf16, then ReLU (``pallas_mlp.py:40-58``; XLA's
dense bf16 path rounds the same way).  The kernel sums in another order
than a GEMM, so the two agree within a bf16 ulp of the scores and +-1
on a small fraction of the weights, as the JAX package's kernel and its
XLA path do (``pallas_mlp.py:19-25``).

Params are the model's dict: ``w1`` [F, H], ``b1`` [H], ``w2`` [H, H],
``b2`` [H], ``w3`` [H, 1], ``b3`` [1], all bfloat16.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..kernels.build import Kernel, library, require_cuda
from .cuda_weights import plan_block

Params = Dict[str, torch.Tensor]

_P = ctypes.c_void_p
_MLP_PLAN = Kernel("fused_mlp_plan", "agac_mlp_plan",
                   [_P] * 9 + [ctypes.c_longlong, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int])
_MLP_SCORES = Kernel("fused_mlp_scores", "agac_mlp_scores",
                     [_P] * 8 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int])

_PARAM_NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


def bf16_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` as XLA's bf16 dot computes it: exact bf16 products summed
    in full f32 (TF32 off), rounded to bf16.  Its gradient is the same
    dot's: the bf16 cotangent, f32 sums, rounded to bf16."""
    # f32 GEMMs on the card, forward and backward, must not drop to TF32
    # (10-bit mantissa): the products are exact only in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    return (x.float() @ w.float()).to(torch.bfloat16)


#: XLA's CPU backend splits a reduction over a dimension longer than this
#: into windows of this size (its tree reduction rewriter)
XLA_CPU_REDUCE_WINDOW = 32


def _sequential_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """Sum the first ``k`` axes of ``x`` (bf16) one element after another
    in row-major order, each f32 add rounded to bf16, over all the other
    positions at once."""
    x = x.reshape(-1, *x.shape[k:])
    acc = torch.zeros(x.shape[1:], dtype=torch.bfloat16, device=x.device)
    for part in x:
        acc = (acc.float() + part.float()).to(torch.bfloat16)
    return acc


def xla_cpu_bf16_sum(x: torch.Tensor, dims) -> torch.Tensor:
    """``reduce_sum`` of bf16 ``x`` over ``dims`` in the order XLA's CPU
    backend takes it.  While a reduced dimension exceeds 32, every
    reduced dimension is zero-padded to a multiple of 32 (evenly, the
    low side the smaller) and summed in windows of 32 per dimension,
    each window row-major; a last pass sums what is left row-major.
    Every add is an f32 add rounded to bf16."""
    dims = sorted(d % x.dim() for d in dims)
    keep = [d for d in range(x.dim()) if d not in dims]
    x = x.to(torch.bfloat16).permute(*dims, *keep)
    r, win = len(dims), XLA_CPU_REDUCE_WINDOW
    while any(n > win for n in x.shape[:r]):
        pads = []
        for n in reversed(x.shape[:r]):
            extra = -n % win
            pads += [extra // 2, extra - extra // 2]
        x = torch.nn.functional.pad(x.movedim(tuple(range(r)),
                                              tuple(range(-r, 0))), pads)
        x = x.movedim(tuple(range(-r, 0)), tuple(range(r)))
        counts = [n // win for n in x.shape[:r]]
        x = x.reshape(*[v for n in counts for v in (n, win)],
                      *x.shape[r:])
        # window axes first (row-major within a window), then the counts
        x = x.permute(*range(1, 2 * r, 2), *range(0, 2 * r, 2),
                      *range(2 * r, x.dim()))
        x = _sequential_sum(x, r)
    return _sequential_sum(x, r)


class _BiasAdd(torch.autograd.Function):
    """``h + b`` for a bias ``b`` [H] along ``h``'s last axis.  Its bias
    gradient on CPU tensors is :func:`xla_cpu_bf16_sum` (the order of the
    reference's bf16 ``reduce_sum`` on the CPU); on CUDA tensors it is
    autograd's sum, f32 accumulation rounded once: another order, stated
    and held to the card-vs-CPU tolerance."""

    @staticmethod
    def forward(ctx, h, b):
        ctx.dtypes = (h.dtype, b.dtype)
        return h + b

    @staticmethod
    def backward(ctx, g):
        h_dtype, b_dtype = ctx.dtypes
        lead = tuple(range(g.dim() - 1))
        if g.device.type == "cpu" and g.dtype == torch.bfloat16:
            gb = xla_cpu_bf16_sum(g, lead)
        else:
            gb = g.sum(lead)
        return g.to(h_dtype), gb.to(b_dtype)


def bf16_linear(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` in bf16: the product rounded, then the bf16 bias
    added with one more rounding (bias gradient: :class:`_BiasAdd`)."""
    return _BiasAdd.apply(bf16_matmul(x, w), b)


def relu(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0)``: the same values as ``torch.relu``, and the
    same gradient, which at x == 0 is half the cotangent."""
    return torch.maximum(x, x.new_zeros(()))


def dense_scores(params: Params, x: torch.Tensor) -> torch.Tensor:
    """[..., F] -> [...] float32 scores through three dense matmuls (the
    plain version of the kernel's MLP)."""
    x = x.to(torch.bfloat16)
    h = relu(bf16_linear(x, params["w1"], params["b1"]))
    h = relu(bf16_linear(h, params["w2"], params["b2"]))
    s = bf16_linear(h, params["w3"], params["b3"])
    return s[..., 0].float()


def forward_reference(params: Params, features: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """The plain version of kernel K3: [G, E, F] + mask -> int32 [G, E]."""
    return plan_block(dense_scores(params, features), mask)


def _kernel_params(name: str, params: Params, dev: torch.device):
    ps = [params[k] for k in _PARAM_NAMES]
    require_cuda(name, *ps)
    if ps[0].device != dev:
        raise ValueError(f"{name}: params on {ps[0].device}, inputs on "
                         f"{dev}")
    F, H = ps[0].shape
    want = {"w1": (F, H), "b1": (H,), "w2": (H, H), "b2": (H,),
            "w3": (H, 1), "b3": (1,)}
    for k, p in zip(_PARAM_NAMES, ps):
        if p.dtype != torch.bfloat16 or tuple(p.shape) != want[k]:
            raise ValueError(f"{name}: {k} must be bfloat16 {want[k]}, got "
                             f"{p.dtype} {tuple(p.shape)}")
    return [p.contiguous() for p in ps], F, H


def forward_cuda(params: Params, features: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """[G, E, F] features + [G, E] bool mask -> int32 weights [G, E]:
    kernel K3 on CUDA tensors, :func:`forward_reference` on CPU
    tensors."""
    if features.device.type == "cpu" and mask.device.type == "cpu":
        return forward_reference(params, features, mask)
    dev = require_cuda("forward_cuda", features, mask)
    ps, F, H = _kernel_params("forward_cuda", params, dev)
    if features.dim() != 3 or features.shape[2] != F \
            or tuple(mask.shape) != tuple(features.shape[:2]) \
            or mask.dtype != torch.bool:
        raise ValueError(f"forward_cuda: features {tuple(features.shape)} "
                         f"must be [G, E, {F}] with a bool [G, E] mask, got "
                         f"mask {mask.dtype} {tuple(mask.shape)}")
    G, E, _ = features.shape
    x = features.to(torch.bfloat16).contiguous()
    out = torch.empty((G, E), dtype=torch.int32, device=dev)
    if out.numel():
        _MLP_PLAN(dev, x, mask.contiguous(), *ps, out, G, E, F, H)
    return out


def plan_tensor_core_route(E: int, F: int, H: int) -> bool:
    """Whether :func:`forward_cuda` plans groups of E rows of F features
    and H hidden units on the tensor cores; a group too large for their
    shared memory takes the CUDA cores, with the same values.  The
    library alone decides (``agac_mlp_plan_tc_route``); this asks it, so
    it builds the kernels and needs the CUDA toolkit."""
    fn = library().agac_mlp_plan_tc_route
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return bool(fn(E, F, H))


def score_rows_cuda(params: Params, rows: torch.Tensor) -> torch.Tensor:
    """[N, F] packed rows -> [N] float32 scores: the kernel's MLP on CUDA
    tensors (every row through the same code, so a row's score does not
    depend on N), :func:`dense_scores` on CPU tensors."""
    if rows.device.type == "cpu":
        return dense_scores(params, rows)
    dev = require_cuda("score_rows_cuda", rows)
    ps, F, H = _kernel_params("score_rows_cuda", params, dev)
    if rows.dim() != 2 or rows.shape[1] != F:
        raise ValueError(f"score_rows_cuda: rows {tuple(rows.shape)} must "
                         f"be [N, {F}]")
    N = rows.shape[0]
    x = rows.to(torch.bfloat16).contiguous()
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    if N:
        _MLP_SCORES(dev, x, *ps, out, N, F, H)
    return out
