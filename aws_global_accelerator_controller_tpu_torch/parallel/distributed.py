"""Ranks, their devices and the collectives between them, over
``torch.distributed``: the port's counterpart of the JAX package's
``parallel/distributed.py``, cut to what the sequence-sharded temporal
path uses.

- **Joining the world** (:func:`join_world`).  A process group already
  set up by the caller is used as it is; otherwise ``torchrun``'s
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) joins one; with none of it set, the world is this one
  process and no process group is made (the reference's mesh over the
  one visible device is 1 x 1).
- **Devices** (:func:`rank_device`).  ``cuda`` gives each rank the card
  ``cuda:LOCAL_RANK`` and raises when that card does not exist;
  ``cuda:N`` puts every rank on card N, the one way to run several ranks
  on one card; ``cpu`` runs on the CPU.  Nothing falls back.
- **Backend.**  gloo, on every device: NCCL refuses two ranks on one
  card, and several ranks on one card is how a machine with one card
  runs a mesh.  Gloo's point-to-point ops take host memory, so every hop
  and collective of a CUDA tensor is staged through a host copy, here
  and nowhere else (:func:`_to_wire`, :func:`_from_wire`); the bytes
  staged (both ways) are counted (:func:`staged_bytes`).  The compute
  stays on each rank's device.
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import Device, DeviceError, resolve_device

BACKEND = "gloo"

_staged = [0]


def staged_bytes() -> int:
    """Bytes this process copied between a device and the host for
    collectives, both directions."""
    return _staged[0]


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """A new contiguous host tensor holding ``t``, as gloo takes it (the
    copy of a CUDA tensor waits for the work that wrote it, and counts
    as staged)."""
    if t.device.type != "cpu":
        _staged[0] += t.numel() * t.element_size()
    return t.detach().to("cpu", memory_format=torch.contiguous_format,
                         copy=True)


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """What gloo wrote into ``w``, on ``like``'s device."""
    if like.device.type == "cpu":
        return w
    _staged[0] += w.numel() * w.element_size()
    return w.to(like.device)


@dataclass(frozen=True)
class World:
    """This process's place among the ranks: its rank, the rank count, its
    device, and the process group's backend (None for a world of one,
    which has no process group)."""
    rank: int
    size: int
    device: torch.device
    backend: Optional[str]


def rank_device(device: Device, local_rank: int) -> torch.device:
    """The device of the rank with host index ``local_rank``: ``cuda`` ->
    ``cuda:LOCAL_RANK``, which must exist; ``cuda:N`` -> card N for every
    rank; ``cpu`` -> the CPU (see :func:`device.resolve_device`)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if torch.cuda.is_available() and \
                local_rank >= torch.cuda.device_count():
            raise DeviceError(
                f"local rank {local_rank} runs on cuda:{local_rank}, but "
                f"{torch.cuda.device_count()} CUDA device(s) are visible; "
                f"pass --device cuda:N to run several ranks on card N")
        dev = torch.device("cuda", local_rank)
    return resolve_device(dev)


@contextlib.contextmanager
def join_world(device: Device = "cuda") -> Iterator[World]:
    """Join (or find) the process group and resolve this rank's device (a
    CUDA device becomes the rank's current device); a process group
    joined here is left on exit."""
    joined = False
    if dist.is_initialized():
        backend = dist.get_backend()
    elif "WORLD_SIZE" in os.environ:
        dist.init_process_group(BACKEND, init_method="env://")
        backend, joined = BACKEND, True
    else:
        backend = None
    try:
        if backend is not None and backend != BACKEND:
            raise ValueError(f"the sharded path runs over {BACKEND!r}, not "
                             f"{backend!r}")
        rank = dist.get_rank() if backend else 0
        size = dist.get_world_size() if backend else 1
        dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        yield World(rank, size, dev, backend)
    finally:
        if joined:
            dist.destroy_process_group()


class Group:
    """An ordered set of ranks (one line of a mesh axis) and the
    collectives the sharded path runs over it.  ``index`` is this rank's
    place in ``ranks``; a group of one rank needs no process group and
    every collective over it is the identity."""

    def __init__(self, ranks: Sequence[int], rank: int, pg=None):
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(rank)
        self.pg = pg

    def shift(self, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Send each tensor one hop to the right (index i to i + 1 mod
        n) and return what arrived from the left, on the same devices."""
        if self.size == 1:
            return tensors
        right = self.ranks[(self.index + 1) % self.size]
        left = self.ranks[(self.index - 1) % self.size]
        out = [_to_wire(t) for t in tensors]
        got = [torch.empty_like(w) for w in out]
        ops = ([dist.P2POp(dist.isend, w, right, group=self.pg) for w in out]
               + [dist.P2POp(dist.irecv, g, left, group=self.pg)
                  for g in got])
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return tuple(_from_wire(g, t) for g, t in zip(got, tensors))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the group (a new tensor)."""
        if self.size == 1:
            return t.clone()
        w = _to_wire(t)
        dist.all_reduce(w, group=self.pg)
        return _from_wire(w, t)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[n, *t.shape]: every rank's ``t`` in group order."""
        if self.size == 1:
            return t.unsqueeze(0).clone()
        w = _to_wire(t)
        got = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(got, w, group=self.pg)
        return _from_wire(torch.stack(got), t)

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank of the group."""
        if self.size == 1:
            return flag
        w = torch.tensor([int(flag)])
        dist.all_reduce(w, op=dist.ReduceOp.MAX, group=self.pg)
        return bool(w.item())

    def gather_objects(self, obj) -> list:
        """Every rank's picklable ``obj``, in group order."""
        if self.size == 1:
            return [obj]
        got = [None] * self.size
        dist.all_gather_object(got, obj, group=self.pg)
        return got
