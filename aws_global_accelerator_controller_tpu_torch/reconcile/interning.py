"""Dense string interning for the planner's id grids.

The port's own copy of the JAX package's ``reconcile/interning.py``.
"""
from __future__ import annotations

from typing import Dict, List


class InternTable:
    """Dense string <-> int32 interning (append-only).

    Dense ids, not hashes, are the device-side tokens: equality on the
    device is exact (no 31-bit CRC collisions silently merging two ARNs
    into one endpoint) and decode is an O(1) list index.
    """

    def __init__(self):
        self._ids: Dict[str, int] = {}
        self._strings: List[str] = []

    def intern(self, s: str) -> int:
        got = self._ids.get(s)
        if got is not None:
            return got
        i = len(self._strings)
        self._ids[s] = i
        self._strings.append(s)
        return i

    def string_of(self, i: int) -> str:
        return self._strings[i]
