"""Temporal traffic model: attention over telemetry history -> weights.

The counterpart of the JAX package's ``models/temporal.py``.  The model
reads a telemetry window [T, G, E, F]; every endpoint attends causally
over its own history, so the S = G * E endpoint streams are the
attention heads: q = k = v = [T, S, D].

- ``forward`` (serving, the ``plan`` command) plans from the last step
  through ``scores_last``: O(T) last-query attention, no kernel, as in
  the reference.
- ``scores_seq`` (sequence supervision, ``eval`` and ``train
  --supervision sequence``) attends every step through
  ``ops.cuda_attention.flash_attention`` when T >= ``FLASH_MIN_WINDOW``,
  else the dense reference: kernel K6a for a forward alone; under
  autograd (``train_step``) kernel K6b, and in the backward the route
  the reference takes: the fused one-sweep K9 for a call of at most 32
  heads whose f32 dq fits its budget, else K7 and K8.  ``train
  --attention-chunk`` splits the streams into such calls.

- ``head="fused"`` / ``"fused_always"`` scores a [T, S, D]
  representation through ``ops.cuda_head.score_head``: kernel K10, and
  K11 in the backward (``_use_fused_head``).

Matmuls take bf16 operands with f32 sums and round to bf16, as XLA's
bf16 dots do, and differentiate as those dots do.  ``scores``,
``scores_seq``, ``scores_last`` and ``loss`` take the reference's seams
(``attend``, ``attend_last``), through which
``parallel.plan.ShardedTemporalPlanner`` runs the ring.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import Device, resolve_device
from ..ops.cuda_attention import flash_attention
from ..ops.cuda_head import score_head, score_head_plain
from ..ops.cuda_mlp import bf16_matmul
from ..ops.weights import plan_weights
from ..parallel.ring_attention import attention_reference
from .common import TrainableModel, make_optimizer, masked_ce_loss
from .traffic import Batch

Params = Dict[str, torch.Tensor]
#: fn(q, k, v [T, S, D]) -> [T, S, D]
Attend = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
#: fn(q_last [S, D], k, v [T, S, D]) -> [S, D]
AttendLast = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                      torch.Tensor]

#: windows this long or longer take the flash kernel (the JAX package's
#: TPU crossover, ``temporal.py:38``; not yet re-derived on the H100)
FLASH_MIN_WINDOW = 64


class TemporalTrafficModel(TrainableModel):
    """Causal self-attention per endpoint stream + MLP head.

    Arguments as in the JAX model.  ``attention``: ``flash`` and
    ``flash_always`` both take the flash kernels for T >=
    ``FLASH_MIN_WINDOW`` (on CPU tensors their plain versions; the card
    is this port's kernel device, so there is no backend gate),
    ``reference`` the dense oracle.  ``supervision``: ``last`` scores the
    final step, ``sequence`` every step.  ``head``: ``reference`` (the
    default) is the dense head; ``fused_always`` scores every [T, S, D]
    representation through the fused head (kernels K10 and K11 on the
    card, their plain versions on the CPU), and ``fused`` does so when the
    representation lies on a CUDA device, as the reference's ``fused``
    does on its TPU rung; 2-D representations (``scores``,
    ``scores_last``) always take the dense head.  ``remat`` recomputes
    the dense head in the backward of a sequence loss
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``):
    the same numbers, less memory; a fused head recomputes its hidden in
    its own backward, so remat skips it.
    ``attention_chunk`` > 0 splits the streams into chunks of at most
    that many heads, one kernel call each (exact: heads are
    independent); chunks of at most 32 heads take the fused one-sweep
    backward K9 in training, as in the reference.  ``optimizer``:
    ``adam`` or ``flat_adam`` (``models.common.make_optimizer``).
    """

    def __init__(self, feature_dim: int = 8, embed_dim: int = 32,
                 hidden_dim: int = 64, learning_rate: float = 1e-3,
                 attention: str = "flash", supervision: str = "last",
                 remat: bool = False, head: str = "reference",
                 attention_chunk: int = 0, optimizer: str = "adam"):
        if attention not in ("flash", "flash_always", "reference"):
            raise ValueError(f"unknown attention impl {attention!r}")
        if supervision not in ("last", "sequence"):
            raise ValueError(f"unknown supervision {supervision!r}")
        if head not in ("reference", "fused", "fused_always"):
            raise ValueError(f"unknown head impl {head!r}")
        if attention_chunk < 0:
            raise ValueError("attention_chunk must be >= 0")
        self.feature_dim = feature_dim
        self.embed_dim = embed_dim
        self.hidden_dim = hidden_dim
        self.attention = attention
        self.supervision = supervision
        self.remat = remat
        self.head = head
        self.attention_chunk = attention_chunk
        self.optimizer = make_optimizer(optimizer, learning_rate)

    def init_params(self, generator: torch.Generator,
                    device: Device = "cuda") -> Params:
        """Normal weights scaled by 1/sqrt(fan_in), zero biases, bfloat16
        (the shapes and scales of the JAX model's init, drawn from
        ``generator`` in its order)."""
        dev = resolve_device(device)
        f, d, h = self.feature_dim, self.embed_dim, self.hidden_dim

        def init(shape, fan_in):
            w = torch.randn(shape, generator=generator) / math.sqrt(fan_in)
            return w.to(torch.bfloat16).to(dev)

        return {
            "embed": init((f, d), f),
            "wq": init((d, d), d),
            "wk": init((d, d), d),
            "wv": init((d, d), d),
            "w1": init((d, h), d),
            "b1": torch.zeros((h,), dtype=torch.bfloat16, device=dev),
            "w2": init((h, 1), h),
            "b2": torch.zeros((1,), dtype=torch.bfloat16, device=dev),
        }

    # -- forward --------------------------------------------------------

    def _attend(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        """q, k, v [T, S, D] -> [T, S, D] causal attention (see
        ``attention``)."""
        if self.attention == "reference" or q.shape[0] < FLASH_MIN_WINDOW:
            return attention_reference(q, k, v, causal=True)
        s, chunk = q.shape[1], self.attention_chunk
        if chunk and s > chunk:
            return torch.cat(
                [flash_attention(*(x[:, c:c + chunk].contiguous()
                                   for x in (q, k, v)), causal=True)
                 for c in range(0, s, chunk)], dim=1)
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True)

    def _embed_kv(self, params: Params, window: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[T, G, E, F] -> (k, v [T, S, D]) through one composed [F, 2D]
        matrix ``embed @ [wk | wv]``, as the JAX model does."""
        t, g, e, f = window.shape
        x = window.to(torch.bfloat16).reshape(t, g * e, f)
        d = params["embed"].shape[-1]
        wkv = bf16_matmul(params["embed"],
                          torch.cat((params["wk"], params["wv"]), dim=1))
        kv = bf16_matmul(x, wkv)                       # [T, S, 2D]
        return kv[..., :d], kv[..., d:]

    def _embed_qkv(self, params: Params, window: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """[T, G, E, F] -> (q, k, v [T, S, D]) through one composed
        [F, 3D] matrix ``embed @ [wq | wk | wv]``."""
        t, g, e, f = window.shape
        x = window.to(torch.bfloat16).reshape(t, g * e, f)
        d = params["embed"].shape[-1]
        wqkv = bf16_matmul(params["embed"], torch.cat(
            (params["wq"], params["wk"], params["wv"]), dim=1))
        qkv = bf16_matmul(x, wqkv)                     # [T, S, 3D]
        return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]

    def _use_fused_head(self, rep: torch.Tensor) -> bool:
        """One predicate for the head dispatch and ``scores_seq``'s remat
        decision (the reference's ``_use_fused_head``): 3-D
        representations only, always under ``fused_always``, and under
        ``fused`` on a CUDA device (the port's counterpart of the
        reference's TPU-rung test)."""
        return (rep.dim() == 3
                and (self.head == "fused_always"
                     or (self.head == "fused"
                         and rep.device.type == "cuda")))

    def _head(self, params: Params, rep: torch.Tensor) -> torch.Tensor:
        """[..., D] attended representation -> [...] float32 score: the
        fused head where ``_use_fused_head`` says so, else the dense head
        (the fused head's plain version under plain autograd)."""
        head = (score_head if self._use_fused_head(rep)
                else score_head_plain)
        return head(rep, params["w1"], params["b1"], params["w2"],
                    params["b2"])

    def scores(self, params: Params, window: torch.Tensor,
               attend: Optional[Attend] = None) -> torch.Tensor:
        """[T, G, E, F] -> [G, E] float32 scores via the full causal
        attention (its last row through the head).  ``attend`` replaces
        the attention with fn(q, k, v [T, S, D]) -> [T, S, D]."""
        t, g, e, f = window.shape
        q, k, v = self._embed_qkv(params, window)
        attended = (attend or self._attend)(q, k, v)
        return self._head(params, attended[-1]).reshape(g, e)

    def scores_last(self, params: Params, window: torch.Tensor,
                    attend_last: Optional[AttendLast] = None,
                    last_step: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """[T, G, E, F] -> [G, E] scores in O(T): only the final query row
        is formed (causality is vacuous for it).  ``attend_last`` replaces
        the last-row attention with fn(q_last [S, D], k, v [T, S, D]) ->
        [S, D] (the sharded planner's seam); ``last_step`` [G, E, F] gives
        the query step's telemetry in place of ``window[-1]``, where
        ``window`` is one rank's block of the time axis that does not hold
        it."""
        t, g, e, f = window.shape
        k, v = self._embed_kv(params, window)
        x = window[-1] if last_step is None else last_step
        x_last = x.to(torch.bfloat16).reshape(g * e, f)
        q_last = bf16_matmul(x_last, bf16_matmul(params["embed"],
                                                 params["wq"]))
        rep = (attend_last or attention_last_reference)(q_last, k, v)
        return self._head(params, rep).reshape(g, e)

    def scores_seq(self, params: Params, window: torch.Tensor,
                   attend: Optional[Attend] = None) -> torch.Tensor:
        """[T, G, E, F] -> [T, G, E] per-step scores: every step's causal
        attended representation through the head.  ``attend`` replaces
        the attention with fn(q, k, v [T, S, D]) -> [T, S, D] (the sharded
        planner's ring)."""
        t, g, e, f = window.shape
        q, k, v = self._embed_qkv(params, window)
        attended = (attend or self._attend)(q, k, v)
        if (self.remat and torch.is_grad_enabled()
                and not self._use_fused_head(attended)):
            # the [T, S, H] hidden is recomputed in the backward instead
            # of kept (the reference's jax.checkpoint of the dense head)
            scores = checkpoint(self._head, params, attended,
                                use_reentrant=False)
        else:
            scores = self._head(params, attended)
        return scores.reshape(t, g, e)

    def forward(self, params: Params, window: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """[T, G, E, F] + [G, E] mask -> int32 GA weights [G, E], planned
        from the latest telemetry through the O(T) path."""
        return plan_weights(self.scores_last(params, window), mask)

    def loss(self, params: Params, window: torch.Tensor,
             batch: Batch, attend: Optional[Attend] = None) -> torch.Tensor:
        """``last``: masked CE on the final step's scores (O(T) path; the
        full attention ``attend`` when one is given).  ``sequence``:
        masked CE per step against ``batch.target`` [T, G, E], averaged
        over steps (``attend`` replacing the attention)."""
        if self.supervision == "sequence":
            seq = self.scores_seq(params, window, attend)   # [T, G, E]
            return masked_ce_loss(seq, batch.mask, batch.target).mean()
        if attend is not None:
            return masked_ce_loss(self.scores(params, window, attend),
                                  batch.mask, batch.target)
        return masked_ce_loss(self.scores_last(params, window), batch.mask,
                              batch.target)


def attention_last_reference(q_last: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """Last-query attention: q_last [S, D], k/v [T, S, D] -> [S, D]
    float32, the final row of causal attention without the other T-1."""
    qf, kf, vf = q_last.float(), k.float(), v.float()
    scale = qf.shape[-1] ** -0.5
    s = torch.einsum("sd,tsd->st", qf, kf) * scale      # [S, T]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("st,tsd->sd", p, vf)


def synthetic_window(rng: np.random.Generator, steps: int = 8,
                     groups: int = 16, endpoints: int = 8,
                     feature_dim: int = 8, per_step: bool = False,
                     device: Device = "cuda") -> Tuple[torch.Tensor, Batch]:
    """Random telemetry window [T, G, E, F] float32 + a target favouring
    endpoints whose capacity signal (feature 0) trends up, drawn from
    numpy's ``rng`` (the JAX model's law: 85% valid endpoints).

    ``per_step=True`` gives the sequence-supervision target [T, G, E],
    step t's following the trend up to t (step 0's is uniform over the
    mask)."""
    dev = resolve_device(device)
    window = rng.standard_normal((steps, groups, endpoints, feature_dim),
                                 dtype=np.float32)
    mask = rng.random((groups, endpoints)) < 0.85

    def target_for(trend):
        raw = np.where(mask, np.exp(trend), np.float32(0.0))
        denom = raw.sum(axis=-1, keepdims=True)
        return np.where(denom > 0, raw / np.maximum(denom, np.float32(1e-9)),
                        np.float32(0.0))

    if per_step:
        target = target_for(window[..., 0] - window[0, ..., 0])
    else:
        target = target_for(window[-1, ..., 0] - window[0, ..., 0])
    w = torch.from_numpy(window).to(dev)
    return w, Batch(features=w[-1].to(torch.bfloat16),
                    mask=torch.from_numpy(mask).to(dev),
                    target=torch.from_numpy(
                        target.astype(np.float32)).to(dev))
