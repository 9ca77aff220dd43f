"""Batched endpoint-set membership diff (plain PyTorch).

The counterpart of the JAX package's ``ops/diff.py``: identifiers are
int32 tokens, rows are padded with ``EMPTY``, and whole fleets of
groups diff at once.
"""
from __future__ import annotations

import zlib
from typing import Iterable, Tuple

import torch

from ..device import Device, resolve_device

# padding slot (ids are non-negative)
EMPTY = -1


def membership_diff(desired: torch.Tensor, current: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """desired [G, E], current [G, E] int32 (EMPTY-padded) ->
    (to_add [G, E] bool over desired slots,
     to_remove [G, E] bool over current slots).

    Sorted search per row, O(E log E): a desired id absent from current
    must be added, a current id absent from desired removed.
    """
    def member(row: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        sorted_table = table.sort(dim=-1).values.contiguous()
        idx = torch.searchsorted(sorted_table, row.contiguous())
        idx = idx.clamp(0, table.shape[-1] - 1)
        found = sorted_table.gather(-1, idx) == row
        return found & (row != EMPTY)

    in_current = member(desired, current)
    in_desired = member(current, desired)
    to_add = ~in_current & (desired != EMPTY)
    to_remove = ~in_desired & (current != EMPTY)
    return to_add, to_remove


def plan_observed_diff(desired: torch.Tensor, current: torch.Tensor,
                       current_w: torch.Tensor):
    """Whole-fleet plan-vs-observed diff, weights included.

    ``desired``/``current``: [..., E] int32 ids (EMPTY-padded);
    ``current_w``: [..., E] int32 observed weights aligned with
    ``current``.  Returns ``to_add`` (desired slots whose id is absent
    from current), ``to_remove`` (current slots absent from desired),
    ``in_both`` (desired slots present in current) and ``observed_w``
    (over desired slots: the matching current slot's weight, ``EMPTY``
    where there is no match).  An O(E^2) broadcast compare, built for
    the planner's row widths (E <= ~32).
    """
    valid_d = desired != EMPTY
    valid_c = current != EMPTY
    eq = ((desired[..., :, None] == current[..., None, :])
          & valid_d[..., :, None] & valid_c[..., None, :])
    in_both = eq.any(dim=-1)
    in_desired = eq.any(dim=-2)
    to_add = valid_d & ~in_both
    to_remove = valid_c & ~in_desired
    observed_w = torch.where(eq, current_w[..., None, :],
                             EMPTY).amax(dim=-1)
    return to_add, to_remove, in_both, observed_w


def hash_ids(ids: Iterable[str], device: Device = "cuda") -> torch.Tensor:
    """Stable non-negative int32 hashes for ARN strings (31-bit CRC), on
    ``device`` (the card unless the caller asks for the CPU)."""
    return torch.tensor([zlib.crc32(s.encode()) & 0x7FFFFFFF for s in ids],
                        dtype=torch.int32, device=resolve_device(device))
