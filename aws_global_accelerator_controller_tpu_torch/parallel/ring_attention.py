"""Ring attention: exact blockwise attention over a sequence-sharded ring
of ranks, the counterpart of the JAX package's
``parallel/ring_attention.py``.

- ``attention_reference`` (``:52-67``): the dense oracle, the temporal
  model's ``attention="reference"`` path and the yardstick its flash
  path is held to.
- :func:`make_ring_attention` (``:109-335``), contiguous layout: each rank
  of the mesh's ``seq`` axis holds one block of the time axis, keeps its
  q block resident and attends the K/V block it holds at each of n steps,
  folding the partial softmax into a running (o, m, l); K/V then move one
  hop to the right neighbour (``Group.shift``, over ``torch.distributed``),
  the last hop skipped.  Blocks wholly in a rank's future are skipped.
  The per-block attend is ``local="einsum"`` (f32 einsums over the whole
  block) or ``local="flash"``, kernel K6b-ring
  (``ops.cuda_attention.flash_attention_stats_ring``, causal only on the
  diagonal block), merged with :func:`_merge_block_stats`.  Its gradient
  is the reference's ring VJP (:class:`_RingAttention`): a second ring
  pass in f32 einsums (the reference has no kernel there) in which q, dO,
  lse and dvec stay resident and (k, v, dK, dV) rotate, dK and dV taking
  a last hop home.  The zigzag layout waits for a later slice.
- :func:`make_last_attention` (``:547-587``): the serving path's final
  query row, each rank's (o, m, l) over its block merged after an
  all-gather over the ``seq`` group; differentiable, the gather's
  backward summing every rank's gradient into the owner's slice.

Inputs are each rank's blocks: q, k, v [T/n, H, D] (the heads being the
rank's share of the endpoint streams), and for the last row q_last
[H, D] with k, v [T/n, H, D].
"""
from __future__ import annotations

from typing import Callable

import torch

from ..ops.cuda_attention import flash_attention_stats_ring
from .distributed import Group
from .mesh import Mesh

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


def _merge_block_stats(o, m, l, o_b, m_b, l_b):
    """Fold a disjoint-key block's unnormalised softmax stats (o_b, m_b,
    l_b) into the running (o, m, l): the flash recurrence."""
    m_new = torch.maximum(m, m_b)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(m_b - m_new)
    return (o * alpha[..., None] + o_b * beta[..., None], m_new,
            l * alpha + l_b * beta)


def _block_mask(group: Group, src: int, t_b: int, device) -> torch.Tensor:
    """[T_b, T_b]: resident query position >= the held block's key
    position (global positions of the contiguous layout)."""
    pos = torch.arange(t_b, device=device)
    return (group.index * t_b + pos)[:, None] >= (src * t_b + pos)[None, :]


def _ring_forward(group: Group, causal: bool, local: str, q, k, v):
    """(o [T_b, H, D] in q's dtype, lse [H, T_b] f32) of the resident q
    block against every rank's K/V block."""
    t_b, h, d = q.shape
    n, my = group.size, group.index
    scale = d ** -0.5
    qf = q.float()
    qh = qf.transpose(0, 1).contiguous()               # [H, T_b, D]
    o = torch.zeros((h, t_b, d), device=q.device)
    m = torch.full((h, t_b), _NEG_INF, device=q.device)
    l = torch.zeros((h, t_b), device=q.device)
    kb, vb = k, v
    for step in range(n):
        src = (my - step) % n                          # whose block we hold
        if not causal or src <= my:
            if local == "flash":
                o_b, m_b, l_b = flash_attention_stats_ring(
                    qh, kb.transpose(0, 1).contiguous(),
                    vb.transpose(0, 1).contiguous(),
                    causal=causal and src == my)
                o, m, l = _merge_block_stats(o, m, l, o_b, m_b, l_b)
            else:
                s = torch.einsum("thd,shd->hts", qf, kb.float()) * scale
                if causal:
                    s = torch.where(_block_mask(group, src, t_b, q.device),
                                    s, _NEG_INF)
                m_new = torch.maximum(m, s.amax(dim=-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(dim=-1)
                o = o * alpha[..., None] + torch.einsum(
                    "hts,shd->htd", p, vb.float())
                m = m_new
        if step < n - 1:
            kb, vb = group.shift(kb, vb)
    # causal: every query attends at least itself on the diagonal, l > 0
    o_norm = (o / l[..., None]).transpose(0, 1).to(q.dtype)
    return o_norm, m + torch.log(l)


def _ring_backward(group: Group, causal: bool, q, k, v, o, lse, do):
    """(dq, dk, dv) [T_b, H, D] in q's, k's and v's dtypes: the reference's
    second ring pass, f32 einsums."""
    t_b, h, d = q.shape
    n, my = group.size, group.index
    scale = d ** -0.5
    qf = q.float().transpose(0, 1)                      # [H, T_b, D]
    dof = do.float().transpose(0, 1)
    dvec = (dof * o.float().transpose(0, 1)).sum(dim=-1)   # [H, T_b]
    dq = torch.zeros((h, t_b, d), device=q.device)
    kb, vb = k, v
    dkb = torch.zeros((h, t_b, d), device=q.device)
    dvb = torch.zeros((h, t_b, d), device=q.device)
    for step in range(n):
        src = (my - step) % n
        if not causal or src <= my:
            kf = kb.float().transpose(0, 1)
            vf = vb.float().transpose(0, 1)
            s = torch.einsum("htd,hsd->hts", qf, kf) * scale
            if causal:
                s = torch.where(_block_mask(group, src, t_b, q.device), s,
                                _NEG_INF)
            p = torch.exp(s - lse[..., None])
            dp = torch.einsum("htd,hsd->hts", dof, vf)
            ds = p * (dp - dvec[..., None]) * scale
            dq = dq + torch.einsum("hts,hsd->htd", ds, kf)
            dkb = dkb + torch.einsum("hts,htd->hsd", ds, qf)
            dvb = dvb + torch.einsum("hts,htd->hsd", p, dof)
        if step < n - 1:
            # dK/dV ride the same ring as K/V, so the partials stay with
            # the block they belong to
            kb, vb, dkb, dvb = group.shift(kb, vb, dkb, dvb)
    # the last hop: only dK/dV travel home
    dk, dv = group.shift(dkb, dvb)
    return (dq.transpose(0, 1).to(q.dtype), dk.transpose(0, 1).to(k.dtype),
            dv.transpose(0, 1).to(v.dtype))


class _RingAttention(torch.autograd.Function):
    """The ring VJP (the reference's ``ring_fwd`` / ``ring_bwd``): the
    forward saves q, k, v, the normalised o and lse; the backward runs
    the second ring pass.  Every rank of the group must run both
    passes together."""

    @staticmethod
    def forward(ctx, q, k, v, group: Group, causal: bool, local: str):
        o, lse = _ring_forward(group, causal, local, q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal = group, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*_ring_backward(ctx.group, ctx.causal, q, k, v, o, lse, do),
                None, None, None)


def make_ring_attention(mesh: Mesh, axis: str = "seq", causal: bool = False,
                        local: str = "einsum", layout: str = "contiguous"
                        ) -> Callable[[torch.Tensor, torch.Tensor,
                                       torch.Tensor], torch.Tensor]:
    """fn(q, k, v: this rank's [T/n, H, D] blocks of the contiguous layout
    along ``axis``) -> its [T/n, H, D] block of the exact attention (in q's
    dtype), equal to :func:`attention_reference` on the gathered inputs;
    differentiable through the ring VJP.  ``local``: ``"einsum"`` or
    ``"flash"`` (kernel K6b-ring)."""
    if local not in ("einsum", "flash"):
        raise ValueError(f"unknown local attend {local!r}")
    if layout == "zigzag":
        raise NotImplementedError(
            "layout='zigzag' is not yet ported: the port's ring has the "
            "contiguous layout only")
    if layout != "contiguous":
        raise ValueError(f"unknown layout {layout!r}")
    group = mesh.groups[axis]

    def ring(q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
        return _RingAttention.apply(q, k, v, group, causal, local)

    return ring


class _AllGather(torch.autograd.Function):
    """[n, *x.shape]: every rank's x in group order.  Each rank receives
    the same stacked rows, so the gradient of a rank's slice is the sum of
    every rank's gradient of it: the backward all-reduces the stacked
    gradient and keeps this rank's slice (the transpose of the
    reference's ``all_gather``, a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group: Group):
        ctx.group = group
        return group.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous())[ctx.group.index], None


def make_last_attention(mesh: Mesh, axis: str = "seq"
                        ) -> Callable[[torch.Tensor, torch.Tensor,
                                       torch.Tensor], torch.Tensor]:
    """fn(q_last [S, D], k, v [T/n, S, D] this rank's blocks along
    ``axis``) -> [S, D] f32: the final row of causal attention over the
    whole time axis, identical on every rank of the ``axis`` group.  Each
    rank's partial softmax stats (o, m, l) for the one query row are
    all-gathered and merged with the flash recurrence."""
    group = mesh.groups[axis]

    def last(q_l: torch.Tensor, k_l: torch.Tensor,
             v_l: torch.Tensor) -> torch.Tensor:
        qf, kf, vf = q_l.float(), k_l.float(), v_l.float()
        scale = qf.shape[-1] ** -0.5
        s = torch.einsum("sd,tsd->st", qf, kf) * scale     # [S_l, T_b]
        m = s.amax(dim=-1)                                 # [S_l]
        p = torch.exp(s - m[:, None])
        el = p.sum(dim=-1)                                 # [S_l]
        o = torch.einsum("st,tsd->sd", p, vf)              # [S_l, D]
        # one gather of [S_l, D + 2] rows: o, m and l side by side
        rows = _AllGather.apply(
            torch.cat((o, m[:, None], el[:, None]), dim=1), group)
        d = o.shape[1]
        os_, ms, ls = rows[..., :d], rows[..., d], rows[..., d + 1]
        mm = ms.amax(dim=0)                                # [S_l]
        w = torch.exp(ms - mm[None])
        denom = (ls * w).sum(dim=0)
        num = (os_ * w[..., None]).sum(dim=0)
        return num / denom[:, None]

    return last

