"""Resident device state of the incremental planner.

The port of the resident-state half of the JAX package's
``parallel/fleet.py`` (``DeviceGridRing``, ``make_row_splice``).  The
older mesh ``FleetPlanner`` waits for a later slice.

Kernel K4 (``csrc/row_splice.cu``) replaces the TPU's
``_dma_row_splice``: it writes a wave's dirty rows INTO the resident
grids, in place, as the TPU kernel does through its aliased output.  A
wave's rows for all six grids travel to the card in one copy
(:func:`pack_splice`, which proves their positions on the host) and land
in one launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.build import Kernel, require_cuda

_SPLICE = Kernel("row_splice", "agac_row_splice",
                 [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong])

#: the most grids one launch of K4 splices (``kMaxGrids`` of the source)
MAX_GRIDS = 8


class DeviceGridRing:
    """Residency of the fleet grids on the device, with the hand-off
    rule of the JAX package's double buffer.

    The planner's splice (kernel K4) and cache write-back update the
    resident tensors IN PLACE, so :meth:`advance` usually installs the
    same tensors it retires.  The hand-off rule still holds, for two
    reasons: the retired tuple stays referenced until
    :meth:`release_retired`, so the caching allocator cannot recycle a
    buffer that a caller still holds, and a wave copies its outputs to
    the host synchronously (``.cpu()``) before it returns, so no later
    splice can race that copy.
    """

    def __init__(self, device: torch.device):
        self.device = device
        # guarded-by: external: the owning planner's wave, never
        # concurrent
        self._front: Optional[Tuple[torch.Tensor, ...]] = None
        # guarded-by: external: as _front
        self._retired: Optional[Tuple[torch.Tensor, ...]] = None

    @property
    def front(self) -> Optional[Tuple[torch.Tensor, ...]]:
        return self._front

    def reset(self, arrays: Tuple[np.ndarray, ...]
              ) -> Tuple[torch.Tensor, ...]:
        """Full (re-)upload of host arrays (first wave, capacity
        growth); a retired tuple keeps its reference."""
        self._front = tuple(torch.tensor(np.asarray(a), device=self.device)
                            for a in arrays)
        return self._front

    def advance(self, arrays: Tuple[torch.Tensor, ...]
                ) -> Tuple[torch.Tensor, ...]:
        """Install the wave's grids; the previous front retires but
        stays referenced until :meth:`release_retired`."""
        self._retired = self._front
        self._front = tuple(arrays)
        return self._front

    def release_retired(self) -> None:
        self._retired = None

    def drop(self) -> None:
        """Invalidate residency outright (shape change)."""
        self._front = None
        self._retired = None


def row_splice_reference(dst: torch.Tensor, lin: torch.Tensor,
                         rows: torch.Tensor) -> torch.Tensor:
    """The plain version of kernel K4: ``dst[lin] = rows`` in place on
    ``dst`` [rows_total, W], returning ``dst``."""
    dst[lin.long()] = rows
    return dst


def _check_grid(name: str, dst: torch.Tensor, lin: torch.Tensor,
                rows: torch.Tensor) -> None:
    if dst.dim() != 2 or rows.dim() != 2 or lin.dim() != 1 \
            or rows.shape != (lin.shape[0], dst.shape[1]):
        raise ValueError(f"{name}: dst {tuple(dst.shape)}, lin "
                         f"{tuple(lin.shape)} and rows {tuple(rows.shape)} "
                         f"must be [R, W], [K] and [K, W]")


def _cuda_device(name: str, dsts: Sequence[torch.Tensor],
                 lin: torch.Tensor, rows: Sequence[torch.Tensor]
                 ) -> torch.device:
    """The one CUDA device of every tensor, each checked for the kernel."""
    dev = require_cuda(name, *dsts, lin, *rows)
    if any(t.dtype != torch.int32 for t in (*dsts, lin, *rows)):
        raise ValueError(f"{name}: dst, lin and rows must be int32")
    if not all(d.is_contiguous() for d in dsts):
        raise ValueError(f"{name} writes in place: dst must be contiguous")
    return dev


def _launch(dev: torch.device, dsts: Sequence[torch.Tensor],
            lin: torch.Tensor, rows: Sequence[torch.Tensor]) -> None:
    """Kernel K4 on checked CUDA tensors: one launch for every grid, the
    table of pointers and widths passed by value."""
    K, n = lin.shape[0], len(dsts)
    if not K:
        return
    rows = [r.contiguous() for r in rows]
    table = ctypes.c_longlong * n
    _SPLICE(dev, n, table(*(d.data_ptr() for d in dsts)),
            table(*(r.data_ptr() for r in rows)),
            table(*(d.shape[1] for d in dsts)), lin.contiguous(), K)


def row_splice(dst: torch.Tensor, lin: torch.Tensor,
               rows: torch.Tensor) -> torch.Tensor:
    """Write ``rows`` [K, W] into ``dst`` [rows_total, W] at rows
    ``lin`` [K], in place, and return ``dst``: kernel K4 on CUDA
    tensors (a table of one grid), :func:`row_splice_reference` on CPU
    tensors.  Rows that share a destination must be equal.

    Every ``lin`` must lie in ``[0, rows_total)``, or this raises
    :class:`IndexError` before anything is written; on CUDA tensors
    the check reads ``lin``'s range back to the host (one sync)."""
    _check_grid("row_splice", dst, lin, rows)
    on_cpu = dst.device.type == "cpu" and lin.device.type == "cpu" \
        and rows.device.type == "cpu"
    if not on_cpu:
        dev = _cuda_device("row_splice", [dst], lin, [rows])
    if rows.shape[0]:
        lo, hi = torch.stack(torch.aminmax(lin)).tolist()
        if lo < 0 or hi >= dst.shape[0]:
            raise IndexError(f"row_splice: row index in [{lo}, {hi}] "
                             f"outside [0, {dst.shape[0]})")
    if on_cpu:
        return row_splice_reference(dst, lin, rows)
    _launch(dev, [dst], lin, [rows])
    return dst


def _splice_grids(dsts: Sequence[torch.Tensor], lin: torch.Tensor,
                  rows: Sequence[torch.Tensor]) -> None:
    """Write ``rows[j]`` [K, W_j] into ``dsts[j]`` [R_j, W_j] at rows
    ``lin`` [K], in place, for 1 to :data:`MAX_GRIDS` grids: kernel K4
    in one launch on CUDA tensors, :func:`row_splice_reference` grid by
    grid on CPU tensors.  Rows that share a destination must be equal.

    ``lin`` is taken as given, so this stays private: every entry must
    lie in ``[0, R_j)`` of every grid, which :func:`make_row_splice`'s
    splice proves on the host (:func:`pack_splice`) before the upload.
    Nothing is read back, so no launch waits on the host."""
    if not 1 <= len(dsts) == len(rows) <= MAX_GRIDS:
        raise ValueError(f"_splice_grids: 1 to {MAX_GRIDS} grids, each "
                         f"with its rows; got {len(dsts)} grids and "
                         f"{len(rows)} row blocks")
    for dst, r in zip(dsts, rows):
        _check_grid("_splice_grids", dst, lin, r)
    if all(t.device.type == "cpu" for t in (*dsts, lin, *rows)):
        for dst, r in zip(dsts, rows):
            row_splice_reference(dst, lin, r)
        return
    _launch(_cuda_device("_splice_grids", dsts, lin, rows), dsts, lin, rows)


def _align4(n: int) -> int:
    return -(-n // 4) * 4


def pack_splice(shape: Tuple[int, int], ks: np.ndarray, kg: np.ndarray,
                blocks: Sequence[np.ndarray], device: torch.device
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """A wave's splice batch on ``device`` from one copy: ``lin`` [K]
    int32 (the flat rows ``ks * cap + kg`` of ``[S, cap]`` grids) and
    each block of ``blocks`` as [K, W] int32 (a [K] block as [K, 1]),
    views of one contiguous int32 buffer packed on the host, each
    segment starting at a 16-byte boundary.  Every block must be int32:
    no other dtype is cast.

    Every position is checked on the host first: ``ks`` in ``[0, S)`` and
    ``kg`` in ``[0, cap)``, so every ``lin`` lies in ``[0, S * cap)``;
    otherwise this raises :class:`IndexError` and copies nothing."""
    S, cap = shape
    ks = np.asarray(ks, np.int64)
    kg = np.asarray(kg, np.int64)
    if ks.shape != kg.shape or ks.ndim != 1:
        raise ValueError(f"pack_splice: ks {ks.shape} and kg {kg.shape} "
                         f"must be one [K] each")
    if ks.size and (ks.min() < 0 or ks.max() >= S or kg.min() < 0
                    or kg.max() >= cap):
        raise IndexError(f"row splice position outside the "
                         f"[{S}, {cap}] resident grid")
    if S * cap > np.iinfo(np.int32).max:
        raise ValueError(f"pack_splice: a [{S}, {cap}] grid has more "
                         f"rows than int32 indexes")
    K = ks.size
    blocks = [np.asarray(b) for b in blocks]
    if any(b.dtype != np.int32 for b in blocks):
        raise ValueError(f"pack_splice: every block must be int32, not "
                         f"{sorted({str(b.dtype) for b in blocks})}")
    if any(b.ndim not in (1, 2) or b.shape[0] != K for b in blocks):
        raise ValueError(f"pack_splice: every block must be [K] or "
                         f"[K, W] with K = {K}")
    blocks = [b.reshape(K, -1) for b in blocks]
    starts = [0]
    for size in (K, *(b.size for b in blocks)):
        starts.append(starts[-1] + _align4(size))
    buf = np.empty(starts[-1], np.int32)
    buf[:K] = ks * cap + kg
    for b, at in zip(blocks, starts[1:]):
        buf[at:at + b.size].reshape(b.shape)[...] = b
    flat = torch.from_numpy(buf).to(device)
    return flat[:K], tuple(flat[at:at + b.size].view(b.shape)
                           for b, at in zip(blocks, starts[1:]))


def make_row_splice(device: torch.device):
    """Splice ``(dsts, ks, kg, blocks) -> dsts`` writing ``blocks[j]`` at
    positions ``(ks[i], kg[i])`` of each resident ``[S, cap, E]`` grid or
    ``[S, cap]`` plane of ``dsts``, in place: one upload
    (:func:`pack_splice`, which checks every position on the host) and
    one launch of kernel K4.  ``ks``, ``kg`` and the blocks are
    host arrays of the wave's real rows: pad rows that repeat a real row
    at its own position would write nothing new."""

    def splice(dsts: Sequence[torch.Tensor], ks: np.ndarray,
               kg: np.ndarray, blocks: Sequence[np.ndarray]
               ) -> Sequence[torch.Tensor]:
        S, cap = dsts[0].shape[:2]
        if any(d.shape[:2] != (S, cap) for d in dsts):
            raise ValueError("make_row_splice: the grids must share "
                             "their [S, cap] positions")
        lin, rows = pack_splice((S, cap), ks, kg, blocks, device)
        _splice_grids([d.view(S * cap, d[0, 0].numel()) for d in dsts],
                     lin, rows)
        return dsts

    return splice
