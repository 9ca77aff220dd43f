"""Kernel K5: the fleet stats ring, and its plain version.

The port of the JAX package's ``parallel/fleet_plan.py::_make_stats_ring``
(hop kernel ``_hop.kernel``, ``:130``): over a group of n ranks, n - 1
hops each pass a block one rank to the right and add what arrived into
the sum, so every rank ends with the sum over ranks, added in the
reference's order (own block, then the left neighbour's, then the one
beyond).

- :func:`stats_ring_plain` (CPU tensors): the n - 1 hops through
  ``Group.shift`` (gloo), the adds in that order.
- :func:`stats_ring_cuda` (CUDA tensors): ``csrc/stats_ring.cu``.  Each
  hop is one launch that stores the block into the right neighbour's
  receive slot through a pointer mapped from its IPC handle
  (:class:`PeerSlots`), then a stream synchronise and a host barrier over
  the group; a closing launch adds the last block to arrive: n launches
  a pass.  It launches the kernel or raises; nothing is staged through
  the host, and no gloo ring stands in for it.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch

from ..kernels.build import Kernel, KernelLaunchError, library, require_cuda
from ..parallel.distributed import count_peer_bytes

_P = ctypes.c_void_p
_STEP = Kernel("stats_ring", "agac_stats_ring_step",
               [_P, _P, _P, ctypes.c_int, ctypes.c_int])

#: floats a receive slot holds: the fleet's 5 stats, padded to one
#: 32-byte sector
SLOT_FLOATS = 8


def launches_per_pass(n: int) -> int:
    """K5 launches of one reduce over n ranks: n - 1 hops and the closing
    add (none for a group of one)."""
    return n if n > 1 else 0


def stats_ring_plain(group, stats: torch.Tensor) -> torch.Tensor:
    """The plain version of the ring: n - 1 ``shift`` hops, each block
    added into the sum as it arrives."""
    acc = blk = stats.to(torch.float32)
    for _ in range(group.size - 1):
        (blk,) = group.shift(blk)
        acc = acc + blk
    return acc


def _call(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        msg = library().agac_error_string(err).decode()
        raise KernelLaunchError(
            f"{fn.__name__} failed: CUDA error {err} ({msg})")


class PeerSlots:
    """This rank's two receive slots (device memory of its own), and its
    right neighbour's, mapped from that rank's IPC handle.  Made
    collectively by every rank of ``group`` and kept until
    :func:`close_peer_slots` (:func:`peer_slots`).  ``hops`` counts the
    hops made, whose parity picks the slot of the next one, across
    passes."""

    def __init__(self, group, device: torch.device):
        if group.size < 2:
            raise ValueError("a ring of one rank has no neighbour to map")
        lib = library()
        for name, argtypes in (
                ("agac_ring_alloc", [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.POINTER(_P)]),
                ("agac_ring_export", [_P, ctypes.c_char_p]),
                ("agac_ring_map", [ctypes.c_int, ctypes.c_char_p,
                                   ctypes.POINTER(_P)]),
                ("agac_ring_close", [_P, _P])):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        self._lib = lib
        self.group, self.device = group, device
        own, peer = _P(), _P()
        _call(lib.agac_ring_alloc, device.index, 2 * SLOT_FLOATS * 4,
              ctypes.byref(own))
        self.own = own.value
        handle = ctypes.create_string_buffer(lib.agac_ring_handle_bytes())
        _call(lib.agac_ring_export, self.own, handle)
        handles = group.gather_objects(handle.raw)
        right = handles[(group.index + 1) % group.size]
        _call(lib.agac_ring_map, device.index, right, ctypes.byref(peer))
        self.peer = peer.value
        self.hops = 0

    def own_slot(self, parity: int) -> int:
        return self.own + (parity % 2) * SLOT_FLOATS * 4

    def peer_slot(self, parity: int) -> int:
        return self.peer + (parity % 2) * SLOT_FLOATS * 4

    def close(self) -> None:
        """Unmap the neighbour's slots and free this rank's; every rank of
        the group must be done with the ring."""
        _call(self._lib.agac_ring_close, self.peer, self.own)


_lock = threading.Lock()
_slots: Dict[Tuple[Tuple[int, ...], int], PeerSlots] = {}


def peer_slots(group, device: torch.device) -> PeerSlots:
    """The :class:`PeerSlots` of ``group`` on ``device``, made on first use
    (collectively: every rank of the group calls this together) and kept
    until :func:`close_peer_slots`."""
    key = (group.ranks, device.index)
    with _lock:
        if key not in _slots:
            _slots[key] = PeerSlots(group, device)
        return _slots[key]


def close_peer_slots() -> None:
    """Close every ring's slots of this process (:meth:`PeerSlots.close`);
    a ring made after this maps anew, one made before must not run
    again.  Every rank of each group must be done with its ring, and
    call this together."""
    with _lock:
        while _slots:
            _slots.popitem()[1].close()


def stats_ring_hop(src, peer, acc: torch.Tensor, k: int,
                   accumulate: bool) -> None:
    """One launch of kernel K5 on ``acc``'s device: ``peer[:k] = src[:k]``
    (unless ``peer`` is None) and ``acc[:k] (+)= src[:k]``; ``src`` and
    ``peer`` are device pointers (ints) or tensors."""
    _STEP(acc.device, src, peer, acc, k, int(accumulate))


def stats_ring_cuda(slots: PeerSlots, stats: torch.Tensor) -> torch.Tensor:
    """The ring's sum of a [k] f32 vector over ``slots.group``: kernel K5
    (n - 1 hop launches, each followed by a stream synchronise and a
    host barrier, then the closing add)."""
    dev = require_cuda("stats_ring_cuda", stats)
    if dev != slots.device:
        raise ValueError(f"stats_ring_cuda: stats on {dev}, the ring's "
                         f"slots on {slots.device}")
    if stats.dim() != 1 or stats.numel() > SLOT_FLOATS:
        raise ValueError(f"stats_ring_cuda: a vector of at most "
                         f"{SLOT_FLOATS} values, got {tuple(stats.shape)}")
    x = stats.to(torch.float32).contiguous()
    k = x.numel()
    acc = torch.empty_like(x)
    group, stream = slots.group, torch.cuda.current_stream(dev)
    for h in range(group.size - 1):
        g = slots.hops
        src = x if h == 0 else slots.own_slot(g - 1)
        stats_ring_hop(src, slots.peer_slot(g), acc, k, h > 0)
        count_peer_bytes(k * 4)
        stream.synchronize()
        group.barrier()
        slots.hops = g + 1
    stats_ring_hop(slots.own_slot(slots.hops - 1), None, acc, k, True)
    return acc
