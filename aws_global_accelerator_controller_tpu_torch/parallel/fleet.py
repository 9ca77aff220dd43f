"""Resident device state of the incremental planner.

The port of the resident-state half of the JAX package's
``parallel/fleet.py`` (``DeviceGridRing``, ``make_row_splice``).  The
older mesh ``FleetPlanner`` waits for a later slice.

Kernel K4 (``csrc/row_splice.cu``) replaces the TPU's
``_dma_row_splice``: it writes a wave's dirty rows INTO the resident
grids, in place, as the TPU kernel does through its aliased output.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.build import Kernel, require_cuda

_SPLICE = Kernel("row_splice", "agac_row_splice",
                 [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_longlong, ctypes.c_int])


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


def row_splice(dst: torch.Tensor, lin: torch.Tensor,
               rows: torch.Tensor) -> torch.Tensor:
    """Write ``rows`` [K, W] into ``dst`` [rows_total, W] at rows
    ``lin`` [K], in place, and return ``dst``: kernel K4 on CUDA
    tensors, :func:`row_splice_reference` on CPU tensors.  Rows that
    share a destination must be equal (the planner's pad rows are).

    Every ``lin`` must lie in ``[0, rows_total)``, or this raises
    :class:`IndexError` before anything is written; on CUDA tensors
    the check reads ``lin``'s range back to the host (one sync)."""
    if dst.dim() != 2 or rows.dim() != 2 or lin.dim() != 1 \
            or rows.shape != (lin.shape[0], dst.shape[1]):
        raise ValueError(f"row_splice: dst {tuple(dst.shape)}, lin "
                         f"{tuple(lin.shape)} and rows {tuple(rows.shape)} "
                         f"must be [R, W], [K] and [K, W]")
    on_cpu = dst.device.type == "cpu" and lin.device.type == "cpu" \
        and rows.device.type == "cpu"
    if not on_cpu:
        dev = require_cuda("row_splice", dst, lin, rows)
        if dst.dtype != torch.int32 or rows.dtype != torch.int32 \
                or lin.dtype != torch.int32:
            raise ValueError("row_splice: dst, lin and rows must be int32")
        if not dst.is_contiguous():
            raise ValueError("row_splice writes in place: dst must be "
                             "contiguous")
    K, W = rows.shape
    if K:
        lo, hi = torch.stack(torch.aminmax(lin)).tolist()
        if lo < 0 or hi >= dst.shape[0]:
            raise IndexError(f"row_splice: row index in [{lo}, {hi}] "
                             f"outside [0, {dst.shape[0]})")
    if on_cpu:
        return row_splice_reference(dst, lin, rows)
    if K:
        _SPLICE(dev, dst, lin.contiguous(), rows.contiguous(), K, W)
    return dst


def make_row_splice(device: torch.device):
    """Splice ``(dst, ks, kg, rows) -> dst`` writing ``rows`` at
    positions ``(ks[i], kg[i])`` of a resident ``[S, cap, E]`` grid or
    ``[S, cap]`` plane, in place.  ``ks``/``kg`` are host numpy arrays,
    each checked against its own axis here (a ``kg`` past ``cap`` can
    still land inside the flat grid, where :func:`row_splice` checks
    the flat row index)."""

    def splice(dst: torch.Tensor, ks: np.ndarray, kg: np.ndarray,
               rows: torch.Tensor) -> torch.Tensor:
        S, cap = dst.shape[:2]
        ks = np.asarray(ks, np.int64)
        kg = np.asarray(kg, np.int64)
        if ks.size and (ks.min() < 0 or ks.max() >= S or kg.min() < 0
                        or kg.max() >= cap):
            raise IndexError(f"row splice position outside the "
                             f"[{S}, {cap}] resident grid")
        lin = torch.from_numpy((ks * cap + kg).astype(np.int32)).to(device)
        W = dst[0, 0].numel()
        row_splice(dst.view(S * cap, W), lin, rows.reshape(-1, W))
        return dst

    return splice
