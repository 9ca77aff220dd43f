"""Sequence-sharded training and planning of the temporal model: the
port's counterpart of the JAX package's ``parallel/plan.py::
ShardedTemporalPlanner`` (``:88-263``), contiguous layout.

Mesh axes: ``data`` splits the G endpoint groups (and with them the G * E
attention streams), ``seq`` splits the window's time axis.  Each rank
holds its [T / n_seq, G / n_data, ...] block of the one global window
(:meth:`shard_window`, :meth:`shard_batch`) and the whole, replicated
params; ring attention over its ``seq`` group carries the time axis.

The reference's step is one SPMD program whose loss is the global loss;
here each rank computes its share of that loss and its gradient, and the
shares are summed over the world:

- ``sequence`` supervision trains through the ring: a rank's share is
  the cross-entropy summed over its steps and groups, divided by the
  valid-group count of the WHOLE batch (one all-reduce over the data
  group) and by the global T, so the shares add up to the reference's
  mean over steps of per-step means (a mean of per-rank means would be
  another loss wherever the ranks' valid counts differ);
- ``last`` supervision trains through the O(T) last-query path
  (``make_last_attention``): every rank of a data group computes the
  same scores for the group's streams, so each counts its data group's
  loss 1 / n_seq times, and the all-gather's backward sums the ranks'
  gradients into each owner's stats;
- the gradients and the loss are summed over the world in f32 (one
  all-reduce) and every rank applies the same update, so params and
  optimizer state stay identical on every rank.

Serving (:meth:`forward`) plans from the last step through the
last-query merge, then ``plan_weights`` on each rank's groups; the
weights are gathered over the data group.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.common import masked_ce_sum, value_and_grad
from ..models.temporal import FLASH_MIN_WINDOW, TemporalTrafficModel
from ..models.traffic import Batch
from ..ops.weights import plan_weights
from .distributed import Group
from .mesh import Mesh
from .ring_attention import make_last_attention, make_ring_attention


class WindowShard(NamedTuple):
    """One rank's share of a telemetry window: ``block`` [T / n_seq,
    G / n_data, E, F], and ``last`` [G / n_data, E, F], the window's final
    step for the rank's groups (the query step of serving and of ``last``
    supervision, held by the last seq rank's block only)."""
    block: torch.Tensor
    last: torch.Tensor


def flash_local(model: TemporalTrafficModel, window: Optional[int],
                n_seq: int) -> str:
    """The ring's per-block attend, by the reference's gate (``:138-147``):
    ``"flash"`` where the model's attention asks for it and a rank's block
    (``window // n_seq``) reaches ``FLASH_MIN_WINDOW``, else ``"einsum"``.
    The port's ``attention="flash"`` has no backend gate (kernel K6b-ring
    on the card, its plain version on the CPU), as in the model."""
    want_flash = model.attention in ("flash", "flash_always")
    block = window // n_seq if window else 0
    return "flash" if want_flash and block >= FLASH_MIN_WINDOW else "einsum"


class ShardedTemporalPlanner:
    """data x seq training and planning of ``model`` on ``mesh``, the
    window's T divisible by the seq axis and its G by the data axis.
    ``local`` forces the ring's per-block attend; by default
    :func:`flash_local` picks it from ``window`` (without ``window`` it
    stays on einsum, as in the reference)."""

    def __init__(self, model: TemporalTrafficModel, mesh: Mesh,
                 data_axis: str = "data", seq_axis: str = "seq",
                 local: Optional[str] = None, window: Optional[int] = None,
                 layout: str = "contiguous"):
        if layout == "zigzag":
            raise NotImplementedError(
                "layout='zigzag' is not yet ported: the port's sharded "
                "planner runs the contiguous ring only")
        if layout != "contiguous":
            raise ValueError(f"unknown layout {layout!r}")
        rank = mesh.world.rank
        self.model = model
        self.mesh = mesh
        self.seq = mesh.groups[seq_axis]
        self.data = mesh.groups.get(data_axis) or Group((rank,), rank)
        self.n_seq, self.n_data = self.seq.size, self.data.size
        self.local = local or flash_local(model, window, self.n_seq)
        self._attend = make_ring_attention(mesh, seq_axis, causal=True,
                                           local=self.local)
        self._last_attend = make_last_attention(mesh, seq_axis)

    # -- placement -------------------------------------------------------

    def _rows(self, t: int) -> slice:
        if t % self.n_seq:
            raise ValueError(f"the window's {t} steps do not divide into "
                             f"the seq axis ({self.n_seq})")
        b = t // self.n_seq
        return slice(self.seq.index * b, (self.seq.index + 1) * b)

    def _groups(self, g: int) -> slice:
        if g % self.n_data:
            raise ValueError(f"the {g} groups do not divide into the data "
                             f"axis ({self.n_data})")
        b = g // self.n_data
        return slice(self.data.index * b, (self.data.index + 1) * b)

    def shard_window(self, window: torch.Tensor) -> WindowShard:
        """This rank's share of the global window [T, G, E, F], on the
        rank's device."""
        dev = self.mesh.world.device
        groups = self._groups(window.shape[1])
        return WindowShard(
            window[self._rows(window.shape[0]), groups].to(dev),
            window[-1, groups].to(dev))

    def shard_batch(self, batch: Batch) -> Batch:
        """This rank's groups of a batch; a per-step target [T, G, E] also
        its steps."""
        dev = self.mesh.world.device
        groups = self._groups(batch.mask.shape[0])
        target = batch.target
        target = (target[self._rows(target.shape[0]), groups]
                  if self.model.supervision == "sequence"
                  else target[groups])
        return Batch(features=batch.features[groups].to(dev),
                     mask=batch.mask[groups].to(dev), target=target.to(dev))

    # -- serving ---------------------------------------------------------

    def scores(self, params, window: WindowShard) -> torch.Tensor:
        """[G / n_data, E] f32: the last step's scores of this rank's
        groups, through the last-query merge over the seq group."""
        return self.model.scores_last(params, window.block,
                                      attend_last=self._last_attend,
                                      last_step=window.last)

    def forward(self, params, window: WindowShard,
                mask: torch.Tensor) -> torch.Tensor:
        """int32 weights [G, E] of the whole fleet, on every rank: each
        rank plans its groups (``mask`` is its [G / n_data, E] share),
        and the data group gathers them."""
        with torch.no_grad():
            w = plan_weights(self.scores(params, window), mask)
        return self.data.all_gather(w).reshape(-1, w.shape[-1])

    # -- training --------------------------------------------------------

    def _valid_groups(self, valid: torch.Tensor) -> torch.Tensor:
        """The valid-group count of the whole batch from this rank's."""
        return self.data.all_reduce(valid).clamp_min(1)

    def _sequence_loss(self, params, window: WindowShard,
                       batch: Batch) -> torch.Tensor:
        seq = self.model.scores_seq(params, window.block,
                                    attend=self._attend)   # [T_b, G_l, E]
        total, valid = masked_ce_sum(seq, batch.mask, batch.target)
        steps = total.new_full((), seq.shape[0] * self.n_seq)
        return (total / self._valid_groups(valid[:1])).sum() / steps

    def _last_loss(self, params, window: WindowShard,
                   batch: Batch) -> torch.Tensor:
        total, valid = masked_ce_sum(self.scores(params, window), batch.mask,
                                     batch.target)
        return (total / self._valid_groups(valid)
                / total.new_full((), self.n_seq))

    def _sum_over_world(self, loss: torch.Tensor, grads):
        """(loss, grads) summed over every rank of the mesh, in f32, the
        grads back in their dtypes."""
        names = sorted(grads)
        flat = torch.cat([grads[k].float().reshape(-1) for k in names]
                         + [loss.float().reshape(1)])
        flat = self.mesh.all.all_reduce(flat)
        out, i = {}, 0
        for k in names:
            n = grads[k].numel()
            out[k] = flat[i:i + n].reshape(grads[k].shape).to(grads[k].dtype)
            i += n
        return flat[-1], {k: out[k] for k in grads}

    def _loss_fn(self):
        return (self._sequence_loss if self.model.supervision == "sequence"
                else self._last_loss)

    def loss_and_grads(self, params, window: WindowShard, batch: Batch):
        """(the global loss, its gradient), each summed over every rank of
        the mesh; every rank calls it together."""
        return self._sum_over_world(*value_and_grad(
            self._loss_fn(), params, window, batch))

    def train_step(self, params, opt_state, window: WindowShard,
                   batch: Batch):
        """(params, optimizer state, the global loss) after one step on
        this rank's shares; every rank of the mesh calls it together."""
        return self.model.train_step_with(self._loss_fn(), params, opt_state,
                                          window, batch,
                                          reduce=self._sum_over_world)
