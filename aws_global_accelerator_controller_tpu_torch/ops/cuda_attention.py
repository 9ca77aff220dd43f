"""Causal flash attention, forward and backward: kernels K6a, K6b, K7 and
K8, their plain versions, and the autograd seam between them.

``flash_attention`` is the port of the JAX package's
``ops/pallas_attention.py::flash_attention`` (``:406-433``): q, k, v
[T, H, D] -> [T, H, D], exact softmax attention with the flash online
recurrence, the H axis being independent heads (the temporal model's
endpoint streams).  Like the reference's ``jax.custom_vjp`` (``:1038-
1068``) it has two faces:

- with no gradient to take, the forward alone: kernel K6a
  (``csrc/flash_attention.cu``, the reference's ``_kernel`` ``:287``);
- under autograd, :class:`FlashAttention`: its forward is kernel K6b
  (:func:`flash_attention_stats`, the reference's ``_stats_kernel``
  ``:301`` with ``normalize=True``), which also saves the per-row softmax
  stats m and l; its backward (:func:`flash_attention_bwd`) computes
  dvec = rowsum(do * o) with plain torch ops and takes the reference's
  route (``_flash_bwd_padded`` ``:885``), decided by the port's copy of
  its gate (:func:`fused_bwd_route`): the fused one-sweep backward,
  kernel K9 (:func:`flash_bwd_dqkv`, ``_dqkv_kernel`` ``:585``, in
  ``csrc/flash_attention_dqkv.cu``), when a head's f32 dq fits the
  reference's 2 MiB and the call has at most 32 heads; else the
  two-sweep backward, kernels K7 (:func:`flash_bwd_dq`, ``_dq_kernel``
  ``:455``) and K8 (:func:`flash_bwd_dkv`, ``_dkv_kernel`` ``:707``) in
  ``csrc/flash_attention_bwd.cu``.

:func:`flash_attention_stats_ring` is the counterpart of the reference's
public ``flash_attention_stats`` (``:1081``, ``_stats_kernel`` with
``normalize=False``): kernel K6b-ring (``csrc/flash_attention_ring.cu``),
one block pair of ring attention on head-major [H, T, D] blocks, f32 q
against bf16 k and v, returning an unnormalised f32 o with f32 m and l.

On CUDA tensors each wrapper launches its kernel or raises; on CPU
tensors it runs its plain version at the kernels' block, :data:`BLOCK_K`.
The kernels take every head width D: a width that is not a multiple of
8 is padded with zero columns on the way in (:func:`_pad_width`), which
adds nothing to q.k^T or do.v^T, keeps the scale of the true D, and
whose output columns are dropped; a width above 128 runs in 128-column
chunks inside the kernels.

Arithmetic, shared by the kernels and the plain versions (``_prescale``
``:346``, ``_attend_step`` ``:197``, the backward bodies ``:480-514``,
``:736-760``):

- q is pre-scaled by D**-0.5 with one rounding to bf16 (q');
- s = q'.k^T from bf16 operands with f32 sums; masked scores are -1e30
  (causal by global position, and keys past T);
- forward, per K block: m_new = max(m, rowmax s) (m starts at -1e30),
  p = exp(s - m_new) in f32, l = l * exp(m - m_new) + sum(p), and
  acc = acc * exp(m - m_new) + bf16(p) . v with f32 sums; o = acc / l
  (K6b: / max(l, 1), the same number, since l >= 1), rounded to bf16;
- backward: p = exp(s - m) / max(l, 1) from the saved stats, dp = do.v^T,
  ds = p * (dp - dvec); dq = bf16(sum bf16(ds).k * D**-0.5), dk =
  bf16(sum bf16(ds)^T.q'), dv = bf16(sum bf16(p)^T.do), f32 sums, dq
  over K blocks and dk, dv over q blocks in ascending order on both
  routes (K9 computes s, p, dp and ds once per live block pair for all
  three, K7 and K8 once each).

p is rounded against the running max, so the forward depends on the K
block partition at the last-ulp level (o and l): the plain versions take
``block_k`` (and the backward ``block_q`` for its sums' order), and a
comparison with a kernel uses the kernel's :data:`BLOCK_K`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..kernels.build import Kernel, library, require_cuda

#: rows of q and keys of k/v per tile of the kernels
BLOCK_K = 64
#: the kernels read rows in 16-byte vectors: D in multiples of 8
HEAD_DIM_MULTIPLE = 8

_NEG_INF = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIZES = [_I, _I, _I, ctypes.c_float, _I]      # T, S, D, scale, causal
_FLASH = Kernel("flash_attention", "agac_flash_attention", [_P] * 4 + _SIZES)
_FLASH_STATS = Kernel("flash_attention_stats", "agac_flash_attention_stats",
                      [_P] * 6 + _SIZES)
_FLASH_DQ = Kernel("flash_bwd_dq", "agac_flash_bwd_dq", [_P] * 8 + _SIZES)
_FLASH_DKV = Kernel("flash_bwd_dkv", "agac_flash_bwd_dkv", [_P] * 9 + _SIZES)
_FLASH_DQKV = Kernel("flash_bwd_dqkv", "agac_flash_bwd_dqkv",
                     [_P] * 11 + _SIZES)
#: Tq, Tk, H, D, scale, causal
_FLASH_RING = Kernel("flash_attention_stats_ring", "agac_flash_attention_ring",
                     [_P] * 6 + [_I, _I, _I, _I, ctypes.c_float, _I])

# The reference's route for the backward (``ops/pallas_attention.py``),
# copied: its block rule (``_auto_block`` ``:116``, ``_resolve_blocks``
# ``:129`` with no explicit blocks, over the one band of its committed
# ``ops/flash_blocks.json``) and the fused backward's gate
# (``:528-558``).  The blocks here decide the route only: the port's
# kernels tile by :data:`BLOCK_K`.
_LANE = 128
_SUBLANE = 16
#: (t_max, block_q, block_k) bands of the reference's block table
_TUNED_BANDS = ((2048, 1024, 1024),)
#: a head's f32 dq (padded length x lane-padded width x 4) at most this
_FUSED_BWD_DQ_BYTES = 2 * 2 ** 20
#: and at most this many heads a call
_FUSED_BWD_MAX_HEADS = 32


def _auto_block(t: int) -> int:
    """The reference's heuristic block: T rounded up to the sublane
    tile, at most 1024."""
    return min(1024, -(-t // _SUBLANE) * _SUBLANE)


def _reference_blocks(t: int) -> Tuple[int, int]:
    """The reference's (block_q, block_k) for attention over T: its
    table's band, each side capped by the heuristic; past the table,
    the heuristic."""
    for t_max, bq, bk in _TUNED_BANDS:
        if t <= t_max:
            return min(bq, _auto_block(t)), min(bk, _auto_block(t))
    return _auto_block(t), _auto_block(t)


def _fused_bwd_eligible(tp_q: int, tp_k: int, dp: int, h: int) -> bool:
    """The reference's gate of its fused one-sweep backward, on its
    padded lengths ``tp_q``, ``tp_k``, lane-padded width ``dp`` and head
    count ``h``."""
    return (tp_q * dp * 4 <= _FUSED_BWD_DQ_BYTES and tp_q == tp_k
            and h <= _FUSED_BWD_MAX_HEADS)


def fused_bwd_route(t: int, h: int, d: int) -> bool:
    """Whether the backward of flash attention over [t, h, d] takes the
    fused one-sweep kernel K9 (else K7 and K8): the reference's choice
    at its own blocks, with d the true head width."""
    if t == 0:
        return False
    block_q, block_k = _reference_blocks(t)
    return _fused_bwd_eligible(-(-t // block_q) * block_q,
                               -(-t // block_k) * block_k,
                               -(-d // _LANE) * _LANE, h)


def backward_hw_matmul_factor(t: int, h: int, d: int) -> float:
    """Matmul passes of forward + backward over the forward's two, for
    the route these shapes take (the reference's ``:561-582``): 3.5 on
    the fused backward (s^T, dv, dp, dk, dq), 4.5 on the two sweeps (s,
    dp, dq; s^T, dp^T, dv, dk)."""
    return 3.5 if fused_bwd_route(t, h, d) else 4.5


def _scale(x: torch.Tensor, scale: Optional[float]) -> float:
    """The softmax scale: ``scale``, or 1/sqrt(D) of ``x``'s width."""
    return x.shape[-1] ** -0.5 if scale is None else scale


def _prescale(q: torch.Tensor, scale: Optional[float] = None
              ) -> torch.Tensor:
    """Fold the scale (1/sqrt(D) by default) into q with one rounding to
    q's dtype."""
    return (q.float() * _scale(q, scale)).to(q.dtype)


def _heads(x: torch.Tensor) -> torch.Tensor:
    """[T, H, D] -> head-major [H, T, D] float32."""
    return x.transpose(0, 1).float()


def _scores(qh: torch.Tensor, kh: torch.Tensor, q_pos: torch.Tensor,
            k_pos: torch.Tensor, causal: bool) -> torch.Tensor:
    """s = q'.k^T [H, rows, keys] f32, -1e30 where the mask drops it."""
    s = qh @ kh.transpose(1, 2)
    if causal:
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, _NEG_INF)
    return s


def flash_attention_stats_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, causal: bool = True,
                                block_k: int = BLOCK_K,
                                scale: Optional[float] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The plain version of kernels K6a and K6b: (o [T, H, D] in q's
    dtype, m [H, T] f32, l [H, T] f32), the online softmax folded over K
    blocks of ``block_k`` keys, o divided by max(l, 1); ``scale``
    defaults to 1/sqrt(D).

    Every query row folds every K block; a block wholly in a row's
    future has all its scores at -1e30, which leaves (m, l, acc) bit for
    bit unchanged, so this equals the kernels' skipping of such blocks.
    """
    T = q.shape[0]
    qh, kh, vh = _heads(_prescale(q, scale)), _heads(k), _heads(v)
    H, _, D = qh.shape
    m = torch.full((H, T, 1), _NEG_INF, device=q.device)
    l = torch.zeros((H, T, 1), device=q.device)
    acc = torch.zeros((H, T, D), device=q.device)
    q_pos = torch.arange(T, device=q.device)
    for j0 in range(0, k.shape[0], block_k):
        kb, vb = kh[:, j0:j0 + block_k], vh[:, j0:j0 + block_k]
        s = _scores(qh, kb, q_pos, q_pos[j0:j0 + block_k], causal)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vb
        m = m_new
    o = (acc / l.clamp_min(1.0)).to(q.dtype).transpose(0, 1)
    return o, m[..., 0], l[..., 0]


def flash_attention_stats_ring_plain(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, causal: bool = False,
                                     block_k: int = BLOCK_K
                                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """The plain version of kernel K6b-ring: q [H, Tq, D], k, v [H, Tk, D]
    -> (o [H, Tq, D] f32 unnormalised, m [H, Tq] f32, l [H, Tq] f32), the
    online softmax folded over K blocks of ``block_k`` keys.

    q is taken in f32 and scaled by D**-0.5 in f32, never rounded to
    bf16; s = q'.k^T is an f32 product (full precision, with TF32 off);
    ``causal`` masks key index > query index (the ring's diagonal block);
    p is rounded to v's dtype before p.v; o is not divided by l.  A K
    block wholly masked for a row leaves its (m, l, acc) bit for bit
    unchanged, as in :func:`flash_attention_stats_plain`."""
    H, Tq, D = q.shape
    qh = q.float() * D ** -0.5
    m = torch.full((H, Tq, 1), _NEG_INF, device=q.device)
    l = torch.zeros((H, Tq, 1), device=q.device)
    acc = torch.zeros((H, Tq, D), device=q.device)
    q_pos = torch.arange(Tq, device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    for j0 in range(0, k.shape[1], block_k):
        keys = slice(j0, j0 + block_k)
        s = _scores(qh, k[:, keys].float(), q_pos, k_pos[keys], causal)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ v[:, keys].float()
        m = m_new
    return acc, m[..., 0], l[..., 0]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, block_k: int = BLOCK_K,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The plain version of kernel K6a: [T, H, D] -> [T, H, D] in q's
    dtype (:func:`flash_attention_stats_plain` without the stats)."""
    return flash_attention_stats_plain(q, k, v, causal, block_k, scale)[0]


def attention_dvec(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """dvec = rowsum(f32(do) * f32(o)) [H, T] f32 from the bf16 o, as the
    reference computes it outside its kernels (``:905-909``)."""
    return (do.float() * o.float()).sum(dim=-1).transpose(0, 1).contiguous()


def _p_ds(qh, kh, vh, doh, m, l, dvec, rows, causal):
    """p and ds [H, len(rows), T] f32 of the q rows ``rows`` against
    every key, from the saved stats."""
    pos = torch.arange(kh.shape[1], device=qh.device)
    s = _scores(qh[:, rows], kh, pos[rows], pos, causal)
    p = torch.exp(s - m[:, rows, None]) / l[:, rows, None].clamp_min(1.0)
    dp = doh[:, rows] @ vh.transpose(1, 2)
    return p, p * (dp - dvec[:, rows, None])


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def flash_bwd_dq_plain(q, k, v, do, m, l, dvec, causal: bool = True,
                       block_q: int = BLOCK_K, block_k: int = BLOCK_K,
                       scale: Optional[float] = None) -> torch.Tensor:
    """The plain version of kernel K7: dq [T, H, D] in q's dtype,
    sum over K blocks of ``block_k`` of bf16(ds).k (f32), times the
    scale (D**-0.5 by default) once, rounded; q rows in blocks of
    ``block_q`` (no effect on the result, only on the memory it takes)."""
    T = q.shape[0]
    scale = _scale(q, scale)
    qh, kh, vh, doh = (_heads(_prescale(q, scale)), _heads(k), _heads(v),
                       _heads(do))
    dq = torch.zeros_like(qh)
    for i0 in range(0, T, block_q):
        rows = slice(i0, i0 + block_q)
        _, ds = _p_ds(qh, kh, vh, doh, m, l, dvec, rows, causal)
        ds = _bf16(ds)
        for j0 in range(0, T, block_k):
            dq[:, rows] += ds[..., j0:j0 + block_k] @ kh[:, j0:j0 + block_k]
    return (dq * scale).to(q.dtype).transpose(0, 1)


def flash_bwd_dkv_plain(q, k, v, do, m, l, dvec, causal: bool = True,
                        block_q: int = BLOCK_K,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernel K8: (dk, dv) [T, H, D] in k's and v's
    dtypes, sums over q blocks of ``block_q`` of bf16(ds)^T.q' and
    bf16(p)^T.do (f32), rounded."""
    T = q.shape[0]
    qh, kh, vh, doh = (_heads(_prescale(q, scale)), _heads(k), _heads(v),
                       _heads(do))
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for i0 in range(0, T, block_q):
        rows = slice(i0, i0 + block_q)
        p, ds = _p_ds(qh, kh, vh, doh, m, l, dvec, rows, causal)
        dk += _bf16(ds).transpose(1, 2) @ qh[:, rows]
        dv += _bf16(p).transpose(1, 2) @ doh[:, rows]
    return (dk.to(k.dtype).transpose(0, 1), dv.to(v.dtype).transpose(0, 1))


def flash_bwd_dqkv_plain(q, k, v, do, m, l, dvec, causal: bool = True,
                         block_q: int = BLOCK_K, block_k: int = BLOCK_K,
                         scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """The plain version of kernel K9: (dq, dk, dv) [T, H, D] in q's, k's
    and v's dtypes in one sweep, K blocks of ``block_k`` outer and the
    live q blocks of ``block_q`` inner; one score tile per pair feeds
    dv_j += bf16(p)^T.do_i, dk_j += bf16(ds)^T.q'_i and dq_i +=
    bf16(ds).k_j (f32), dq times the scale once at the end."""
    T = q.shape[0]
    scale = _scale(q, scale)
    qh, kh, vh, doh = (_heads(_prescale(q, scale)), _heads(k), _heads(v),
                       _heads(do))
    dq, dk, dv = (torch.zeros_like(x) for x in (qh, kh, vh))
    pos = torch.arange(T, device=q.device)
    for j0 in range(0, T, block_k):
        keys = slice(j0, j0 + block_k)
        for i0 in range(j0 // block_q * block_q if causal else 0, T,
                        block_q):
            rows = slice(i0, i0 + block_q)
            s = _scores(qh[:, rows], kh[:, keys], pos[rows], pos[keys],
                        causal)
            p = (torch.exp(s - m[:, rows, None])
                 / l[:, rows, None].clamp_min(1.0))
            dp = doh[:, rows] @ vh[:, keys].transpose(1, 2)
            ds = _bf16(p * (dp - dvec[:, rows, None]))
            dv[:, keys] += _bf16(p).transpose(1, 2) @ doh[:, rows]
            dk[:, keys] += ds.transpose(1, 2) @ qh[:, rows]
            dq[:, rows] += ds @ kh[:, keys]
    return ((dq * scale).to(q.dtype).transpose(0, 1),
            dk.to(k.dtype).transpose(0, 1), dv.to(v.dtype).transpose(0, 1))


def flash_attention_bwd_plain(q, k, v, o, do, m, l, causal: bool = True,
                              block_q: int = BLOCK_K, block_k: int = BLOCK_K,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The plain version of the two-sweep backward: (dq, dk, dv)
    [T, H, D] from q, k, v, the forward's bf16 o, the cotangent do and
    the stats m, l [H, T]."""
    dvec = attention_dvec(o, do)
    dq = flash_bwd_dq_plain(q, k, v, do, m, l, dvec, causal, block_q,
                            block_k, scale)
    return (dq, *flash_bwd_dkv_plain(q, k, v, do, m, l, dvec, causal,
                                     block_q, scale))


def flash_attention_bwd_magnitude(q, k, v, o, do, m, l, causal: bool = True
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """What each gradient sums, in absolute value, [T, H, D] f32: for dq
    D**-0.5 sum_j p (|dp| + |dvec|) |k_j|, for dk sum_i p (|dp| + |dvec|)
    |q'_i|, for dv sum_i p |do_i|.  Rounding p or ds (|ds| <= p (|dp| +
    |dvec|)) the other way, or another f32 order of dp and dvec, moves a
    gradient by at most about one bf16 ulp of this, whatever the
    cancellation in its sum, so comparisons of the backward are stated
    in ulps of it (``parity.attention_close``)."""
    T, _, D = q.shape
    qh, kh, vh, doh = _heads(_prescale(q)), _heads(k), _heads(v), _heads(do)
    dvec = attention_dvec(o, do)
    pos = torch.arange(T, device=q.device)
    s = _scores(qh, kh, pos, pos, causal)
    p = torch.exp(s - m[..., None]) / l[..., None].clamp_min(1.0)
    w = p * ((doh @ vh.transpose(1, 2)).abs() + dvec.abs()[..., None])
    return ((w @ kh.abs() * D ** -0.5).transpose(0, 1),
            (w.transpose(1, 2) @ qh.abs()).transpose(0, 1),
            (p.transpose(1, 2) @ doh.abs()).transpose(0, 1))


def _check(name: str, *xs: torch.Tensor) -> Tuple[torch.device, int, int,
                                                  int]:
    """(device, T, H, D) of bf16 [T, H, D] tensors the kernels take, or
    ValueError."""
    dev = require_cuda(name, *xs)
    if xs[0].dim() != 3 or any(x.shape != xs[0].shape for x in xs):
        raise ValueError(f"{name}: q, k, v must be one [T, H, D], got "
                         + ", ".join(str(tuple(x.shape)) for x in xs))
    if any(x.dtype != torch.bfloat16 for x in xs):
        raise ValueError(f"{name}: the kernel takes bfloat16 q, k, v")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError(f"{name}: the kernel takes contiguous q, k, v")
    T, H, D = xs[0].shape
    if D % HEAD_DIM_MULTIPLE:
        raise ValueError(f"{name}: the kernel takes D a multiple of "
                         f"{HEAD_DIM_MULTIPLE} (the wrappers pad it); got "
                         f"D={D}")
    if -(-T // BLOCK_K) > 65535:
        raise ValueError(f"{name}: T={T} exceeds the kernel's grid "
                         f"({65535 * BLOCK_K} rows)")
    if any(x.data_ptr() % 16 for x in xs):
        raise ValueError(f"{name}: the kernel reads q, k, v in 16-byte "
                         f"vectors; their storage must be 16-byte aligned")
    return dev, T, H, D


def _check_stats(name: str, dev: torch.device, T: int, H: int,
                 *stats: torch.Tensor) -> None:
    for x in stats:
        if (x.device != dev or x.dtype != torch.float32
                or tuple(x.shape) != (H, T) or not x.is_contiguous()):
            raise ValueError(f"{name}: the stats must be contiguous float32 "
                             f"[H, T] = {(H, T)} on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def _on_cpu(*xs: torch.Tensor) -> bool:
    return all(x.device.type == "cpu" for x in xs)


def _pad_width(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """[T, H, D] tensors with D zero-padded to a multiple of
    :data:`HEAD_DIM_MULTIPLE` (unchanged when it is one already)."""
    pad = -xs[0].shape[-1] % HEAD_DIM_MULTIPLE
    if pad == 0:
        return xs
    return tuple(torch.nn.functional.pad(x, (0, pad)) for x in xs)


def _unpad(x: torch.Tensor, D: int) -> torch.Tensor:
    """A kernel's [T, H, Dp] output cut back to the true width D."""
    return x if x.shape[-1] == D else x[..., :D].contiguous()


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True
                            ) -> torch.Tensor:
    """q, k, v [T, H, D] bfloat16 -> [T, H, D] bfloat16: kernel K6a on
    CUDA tensors (contiguous and 16-byte aligned, any D),
    :func:`flash_attention_plain` at :data:`BLOCK_K` on CPU tensors."""
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal, BLOCK_K)
    D = q.shape[-1]
    q, k, v = _pad_width(q, k, v)
    dev, T, H, Dp = _check("flash_attention", q, k, v)
    out = torch.empty_like(q)
    if out.numel():
        _FLASH(dev, q, k, v, out, T, H, Dp, D ** -0.5, int(causal))
    return _unpad(out, D)


def flash_attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """(o [T, H, D] bf16, m [H, T] f32, l [H, T] f32): kernel K6b on CUDA
    tensors (the checks of :func:`flash_attention_forward`),
    :func:`flash_attention_stats_plain` at :data:`BLOCK_K` on CPU
    tensors."""
    if _on_cpu(q, k, v):
        return flash_attention_stats_plain(q, k, v, causal, BLOCK_K)
    D = q.shape[-1]
    q, k, v = _pad_width(q, k, v)
    dev, T, H, Dp = _check("flash_attention_stats", q, k, v)
    out = torch.empty_like(q)
    m = torch.empty((H, T), dtype=torch.float32, device=dev)
    l = torch.empty((H, T), dtype=torch.float32, device=dev)
    if out.numel():
        _FLASH_STATS(dev, q, k, v, out, m, l, T, H, Dp, D ** -0.5,
                     int(causal))
    return _unpad(out, D), m, l


def flash_attention_stats_ring(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, causal: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """(o [H, Tq, D] f32 unnormalised, m [H, Tq] f32, l [H, Tq] f32) of f32
    q [H, Tq, D] against bf16 k, v [H, Tk, D]: kernel K6b-ring on CUDA
    tensors (contiguous, 16-byte aligned, any D, Tq and Tk),
    :func:`flash_attention_stats_ring_plain` at :data:`BLOCK_K` on CPU
    tensors."""
    name = "flash_attention_stats_ring"
    if _on_cpu(q, k, v):
        return flash_attention_stats_ring_plain(q, k, v, causal, BLOCK_K)
    dev = require_cuda(name, q, k, v)
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or (
            q.shape[0], q.shape[2]) != (k.shape[0], k.shape[2]):
        raise ValueError(f"{name}: q must be [H, Tq, D] and k, v one "
                         f"[H, Tk, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype != torch.float32 or k.dtype != torch.bfloat16 \
            or v.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel takes float32 q and bfloat16 "
                         f"k, v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not all(x.is_contiguous() for x in (q, k, v)):
        raise ValueError(f"{name}: the kernel takes contiguous q, k, v")
    H, Tq, D = q.shape
    q, k, v = _pad_width(q, k, v)
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(f"{name}: the kernel reads q, k, v in 16-byte "
                         f"vectors; their storage must be 16-byte aligned")
    if -(-Tq // BLOCK_K) > 65535:
        raise ValueError(f"{name}: Tq={Tq} exceeds the kernel's grid "
                         f"({65535 * BLOCK_K} rows)")
    Dp = q.shape[-1]
    o = torch.empty((H, Tq, Dp), dtype=torch.float32, device=dev)
    m = torch.empty((H, Tq), dtype=torch.float32, device=dev)
    l = torch.empty((H, Tq), dtype=torch.float32, device=dev)
    if H and Tq:
        _FLASH_RING(dev, q, k, v, o, m, l, Tq, k.shape[1], H, Dp, D ** -0.5,
                    int(causal))
    return _unpad(o, D), m, l


def flash_bwd_dq(q, k, v, do, m, l, dvec, causal: bool = True
                 ) -> torch.Tensor:
    """dq [T, H, D] bf16: kernel K7 on CUDA tensors (q, k, v, do as
    :func:`flash_attention_forward` takes them; m, l, dvec contiguous f32
    [H, T]), :func:`flash_bwd_dq_plain` at :data:`BLOCK_K` on CPU
    tensors."""
    if _on_cpu(q, k, v, do, m, l, dvec):
        return flash_bwd_dq_plain(q, k, v, do, m, l, dvec, causal)
    D = q.shape[-1]
    q, k, v, do = _pad_width(q, k, v, do)
    dev, T, H, Dp = _check("flash_bwd_dq", q, k, v, do)
    _check_stats("flash_bwd_dq", dev, T, H, m, l, dvec)
    dq = torch.empty_like(q)
    if dq.numel():
        _FLASH_DQ(dev, q, k, v, do, m, l, dvec, dq, T, H, Dp, D ** -0.5,
                  int(causal))
    return _unpad(dq, D)


def flash_bwd_dkv(q, k, v, do, m, l, dvec, causal: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [T, H, D] bf16: kernel K8 on CUDA tensors (the checks of
    :func:`flash_bwd_dq`), :func:`flash_bwd_dkv_plain` at :data:`BLOCK_K`
    on CPU tensors."""
    if _on_cpu(q, k, v, do, m, l, dvec):
        return flash_bwd_dkv_plain(q, k, v, do, m, l, dvec, causal)
    D = q.shape[-1]
    q, k, v, do = _pad_width(q, k, v, do)
    dev, T, H, Dp = _check("flash_bwd_dkv", q, k, v, do)
    _check_stats("flash_bwd_dkv", dev, T, H, m, l, dvec)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel():
        _FLASH_DKV(dev, q, k, v, do, m, l, dvec, dk, dv, T, H, Dp,
                   D ** -0.5, int(causal))
    return _unpad(dk, D), _unpad(dv, D)


def flash_bwd_dqkv(q, k, v, do, m, l, dvec, causal: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) [T, H, D] bf16: kernel K9 on CUDA tensors (the checks
    of :func:`flash_bwd_dq`; an f32 workspace for the heads' dq
    accumulators),
    :func:`flash_bwd_dqkv_plain` at :data:`BLOCK_K` on CPU tensors."""
    if _on_cpu(q, k, v, do, m, l, dvec):
        return flash_bwd_dqkv_plain(q, k, v, do, m, l, dvec, causal)
    D = q.shape[-1]
    q, k, v, do = _pad_width(q, k, v, do)
    dev, T, H, Dp = _check("flash_bwd_dqkv", q, k, v, do)
    _check_stats("flash_bwd_dqkv", dev, T, H, m, l, dvec)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if dq.numel():
        ws = torch.empty(_dqkv_workspace_floats(T, H, Dp),
                         dtype=torch.float32, device=dev)
        _FLASH_DQKV(dev, q, k, v, do, m, l, dvec, dq, dk, dv, ws, T, H, Dp,
                    D ** -0.5, int(causal))
    return _unpad(dq, D), _unpad(dk, D), _unpad(dv, D)


@functools.lru_cache(maxsize=None)
def _dqkv_workspace_fn():
    fn = library().agac_flash_bwd_dqkv_workspace
    fn.argtypes = [_I, _I, _I]
    fn.restype = ctypes.c_longlong
    return fn


def _dqkv_workspace_floats(T: int, H: int, Dp: int) -> int:
    """Floats of K9's dq workspace at these sizes,
    as the kernel's source computes them."""
    return _dqkv_workspace_fn()(T, H, Dp)


def flash_attention_bwd(q, k, v, o, do, m, l, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """(dq, dk, dv) of the flash attention whose forward gave o, m, l:
    dvec with plain torch ops, then the reference's route
    (:func:`fused_bwd_route`): K9, or K7 and K8 (their plain versions on
    CPU tensors)."""
    dvec = attention_dvec(o, do)
    T, H, D = q.shape
    if fused_bwd_route(T, H, D):
        return flash_bwd_dqkv(q, k, v, do, m, l, dvec, causal)
    return (flash_bwd_dq(q, k, v, do, m, l, dvec, causal),
            *flash_bwd_dkv(q, k, v, do, m, l, dvec, causal))


class FlashAttention(torch.autograd.Function):
    """The flash VJP (the reference's ``_flash_diff_fwd`` /
    ``_flash_diff_bwd``, ``:1043-1068``): the forward saves q, k, v, the
    bf16 o and the f32 stats (q' is recomputed by the kernels, as
    ``_prescale`` is deterministic); the backward takes the cotangent
    contiguous (the head's reshapes and a chunk's slices hand it over
    strided) and returns dq, dk, dv in bf16."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, m, l = flash_attention_stats(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o,
                                         do.to(o.dtype).contiguous(), m, l,
                                         ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q, k, v [T, H, D] bfloat16 -> [T, H, D] bfloat16 causal flash
    attention: :class:`FlashAttention` (K6b, then K9, or K7 and K8, in
    the backward) when autograd records and an input requires a gradient,
    else the forward alone (K6a); on CPU tensors, their plain versions."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)
    return flash_attention_forward(q, k, v, causal)
