"""Kernel K5: the fleet stats all-reduce, and its plain version.

The port of the JAX package's ``parallel/fleet_plan.py::_make_stats_ring``
(hop kernel ``_hop.kernel``, ``:130``): over a group of n ranks every
rank ends with the sum over ranks, added in the reference's order (own
block, then the left neighbour's, then the one beyond), the order in
which its ring's n - 1 hops bring the blocks.

- :func:`stats_ring_plain` (CPU tensors): the n - 1 hops through
  ``Group.shift`` (gloo), the adds in that order.
- :func:`stats_ring_cuda` (CUDA tensors): ``csrc/stats_ring.cu``.  A pass
  is one exchange: a launch that stores this rank's block into every
  peer's inbox, in the slot of its ring distance (:func:`inbox_slot`),
  through pointers mapped from the peers' IPC handles
  (:class:`PeerSlots`); one host barrier over the group; a launch that
  adds the inbox's slots in the reference's order
  (:func:`slot_senders`).  The two launches are ordered across ranks by
  interprocess CUDA events, waited on by the streams, not the host: two
  launches a pass, no stream synchronise.  It launches the kernels or
  raises; nothing is staged through the host, and no gloo collective
  stands in for it.  The header of ``csrc/stats_ring.cu`` gives the
  events' parity rule and why no wait lands on a stale record.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Sequence, Tuple

import torch

from ..kernels.build import Kernel, KernelLaunchError, library, require_cuda
from ..parallel.distributed import count_peer_bytes

_P = ctypes.c_void_p
_I = ctypes.c_int
# both count as K5's launches
_SEND = Kernel("stats_ring", "agac_stats_ring_send",
               [_P, _P, _I, _I, _P, _I, _P])
_SUM = Kernel("stats_ring", "agac_stats_ring_sum",
              [_P, _P, _I, _P, _I, _I, _P, _I, _P])

#: floats a slot holds: the fleet's 5 stats, padded to one 32-byte sector
SLOT_FLOATS = 8
_SLOT_BYTES = SLOT_FLOATS * 4
#: the inboxes' parities: pass p uses parity p mod 2
PARITIES = 2


def launches_per_pass(n: int) -> int:
    """K5 launches of one reduce over n ranks: the send and the sum (none
    for a group of one)."""
    return 2 if n > 1 else 0


def inbox_slot(sender: int, receiver: int, n: int) -> int:
    """The slot of ``receiver``'s inbox that holds ``sender``'s block: its
    ring distance, the hop at which the reference's ring brings it."""
    return (receiver - sender) % n


def slot_senders(receiver: int, n: int) -> List[int]:
    """The senders whose blocks ``receiver``'s sum adds, in its order:
    slot 0 (its own), then slots 1 .. n - 1 (the left neighbour's, then
    the one beyond); ``inbox_slot(slot_senders(r, n)[s], r, n) == s``."""
    return [(receiver - s) % n for s in range(n)]


def send_targets(inboxes: Sequence[int], sender: int, parity: int
                 ) -> List[int]:
    """The addresses ``sender``'s send stores into at ``parity``: for each
    receiver at ring distance 1 .. n - 1, in that order, the slot
    :func:`inbox_slot` gives in its inbox (``inboxes[j]``, receiver j's
    inbox as mapped here; an inbox is ``PARITIES`` x n slots)."""
    n = len(inboxes)
    out = []
    for d in range(1, n):
        j = (sender + d) % n
        out.append(inboxes[j] + (parity * n + inbox_slot(sender, j, n))
                   * _SLOT_BYTES)
    return out


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


def _array(ptrs: Sequence[int]) -> ctypes.Array:
    return (_P * len(ptrs))(*ptrs)


_HOST_ENTRIES = (
    ("agac_ring_alloc", [_I, ctypes.c_longlong, ctypes.POINTER(_P)]),
    ("agac_ring_export", [_P, ctypes.c_char_p]),
    ("agac_ring_map", [_I, ctypes.c_char_p, ctypes.POINTER(_P)]),
    ("agac_ring_unmap", [_P]),
    ("agac_ring_free", [_P]),
    ("agac_ring_event_create", [_I, ctypes.POINTER(_P), ctypes.c_char_p]),
    ("agac_ring_event_open", [_I, ctypes.c_char_p, ctypes.POINTER(_P)]),
    ("agac_ring_event_destroy", [_P]),
)


class PeerSlots:
    """This rank's inbox (device memory of its own: ``PARITIES`` x n slots
    of ``SLOT_FLOATS`` floats) and every peer's, mapped from its IPC
    handle; this rank's events ``sent[q]`` and ``read[q]`` and every
    peer's, opened from theirs.  Made collectively by every rank of
    ``group`` and kept until :func:`close_peer_slots` (:func:`peer_slots`).
    ``passes`` counts the passes made, whose parity picks the slots and
    events of the next one."""

    def __init__(self, group, device: torch.device):
        lib = library()
        n, i = group.size, group.index
        if n < 2:
            raise ValueError("an exchange of one rank has no peer to map")
        if n > lib.agac_stats_ring_max_ranks():
            raise ValueError(f"the stats exchange takes at most "
                             f"{lib.agac_stats_ring_max_ranks()} ranks, "
                             f"got {n}")
        for name, argtypes in _HOST_ENTRIES:
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = _I
        self._lib = lib
        self.group, self.device = group, device
        self._mapped: List[int] = []
        self._opened: List[int] = []
        self._events: List[int] = []
        own = _P()
        _call(lib.agac_ring_alloc, device.index,
              PARITIES * n * _SLOT_BYTES, ctypes.byref(own))
        self.own = own.value
        handle = ctypes.create_string_buffer(lib.agac_ring_handle_bytes())
        _call(lib.agac_ring_export, self.own, handle)
        eh = lib.agac_ring_event_handle_bytes()
        mine, own_events = {"inbox": handle.raw}, {}
        for kind in ("sent", "read"):
            for q in range(PARITIES):
                ev, h = _P(), ctypes.create_string_buffer(eh)
                _call(lib.agac_ring_event_create, device.index,
                      ctypes.byref(ev), h)
                self._events.append(ev.value)
                own_events[kind, q], mine[kind, q] = ev.value, h.raw
        theirs = group.gather_objects(mine)
        inboxes = []
        peer_events: Dict[Tuple[str, int], List[int]] = {
            (kind, q): [] for kind in ("sent", "read")
            for q in range(PARITIES)}
        for j, t in enumerate(theirs):
            if j == i:
                inboxes.append(self.own)
                continue
            ptr = _P()
            _call(lib.agac_ring_map, device.index, t["inbox"],
                  ctypes.byref(ptr))
            self._mapped.append(ptr.value)
            inboxes.append(ptr.value)
            for key, evs in peer_events.items():
                ev = _P()
                _call(lib.agac_ring_event_open, device.index, t[key],
                      ctypes.byref(ev))
                self._opened.append(ev.value)
                evs.append(ev.value)
        #: this rank's events, by parity
        self.sent = [own_events["sent", q] for q in range(PARITIES)]
        self.read = [own_events["read", q] for q in range(PARITIES)]
        #: every peer's events, by parity, as the entries take them
        self.peer_sent = [_array(peer_events["sent", q])
                          for q in range(PARITIES)]
        self.peer_read = [_array(peer_events["read", q])
                          for q in range(PARITIES)]
        self.targets = [_array(send_targets(inboxes, i, q))
                        for q in range(PARITIES)]
        self.passes = 0

    def slots(self, parity: int) -> int:
        """The address of slot 0 of this rank's inbox at ``parity``."""
        return self.own + parity * self.group.size * _SLOT_BYTES

    def close(self) -> None:
        """Wait for this rank's work and every peer's, then close the
        peers' events and inboxes and free this rank's; every rank of the
        group calls this together."""
        torch.cuda.synchronize(self.device)
        self.group.barrier()
        lib = self._lib
        for ev in self._opened + self._events:
            _call(lib.agac_ring_event_destroy, ev)
        for ptr in self._mapped:
            _call(lib.agac_ring_unmap, ptr)
        _call(lib.agac_ring_free, self.own)


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
    """Close every exchange's slots of this process
    (:meth:`PeerSlots.close`); one made after this maps anew, one made
    before must not run again.  Every rank of each group calls this
    together."""
    with _lock:
        while _slots:
            _slots.popitem()[1].close()


def _waits(events) -> Tuple[object, int]:
    arr = events if isinstance(events, ctypes.Array) else _array(events)
    return (ctypes.addressof(arr) if len(arr) else None), len(arr)


def stats_ring_send(slots: PeerSlots, x: torch.Tensor, parity: int,
                    waits, record) -> None:
    """One launch of K5's send on ``x``'s device: wait on ``waits``
    (events; none if empty), store ``x`` (contiguous f32, at most
    ``SLOT_FLOATS``) into the slot of every peer's inbox at ``parity``,
    record ``record`` (an event, or None)."""
    w, nw = _waits(waits)
    targets = slots.targets[parity]
    _SEND(x.device, x, ctypes.addressof(targets), len(targets), x.numel(),
          w, nw, record)


def stats_ring_sum(slots: PeerSlots, x: torch.Tensor, parity: int,
                   waits, record) -> torch.Tensor:
    """One launch of K5's sum on ``x``'s device: wait on ``waits``, then
    ``x`` plus slots 1 .. n - 1 of this rank's inbox at ``parity``, in
    that order; record ``record``."""
    w, nw = _waits(waits)
    acc = torch.empty_like(x)
    _SUM(x.device, x, slots.slots(parity), slots.group.size, acc,
         x.numel(), SLOT_FLOATS, w, nw, record)
    return acc


def stats_ring_cuda(slots: PeerSlots, stats: torch.Tensor) -> torch.Tensor:
    """The sum of a [k] f32 vector over ``slots.group`` in the reference's
    order: kernel K5's send, the host barrier, its sum (two launches,
    ordered across ranks by the slots' events)."""
    dev = require_cuda("stats_ring_cuda", stats)
    if dev != slots.device:
        raise ValueError(f"stats_ring_cuda: stats on {dev}, the ring's "
                         f"slots on {slots.device}")
    if stats.dim() != 1 or stats.numel() > SLOT_FLOATS:
        raise ValueError(f"stats_ring_cuda: a vector of at most "
                         f"{SLOT_FLOATS} values, got {tuple(stats.shape)}")
    x = stats.to(torch.float32).contiguous()
    q = slots.passes % PARITIES
    stats_ring_send(slots, x, q, slots.peer_read[q], slots.sent[q])
    count_peer_bytes((slots.group.size - 1) * x.numel() * 4)
    slots.group.barrier()
    acc = stats_ring_sum(slots, x, q, slots.peer_sent[q], slots.read[q])
    slots.passes += 1
    return acc
