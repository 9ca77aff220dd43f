"""Resident columnar fleet state + per-shard dirty masks.

The port's own copy of the JAX package's ``reconcile/resident.py``
(host-side numpy, no device code).  Rebuilding the whole columnar
layout every wave is a Python loop over every group; steady state
mutates <1% of the fleet per wave.  This module keeps the packed arrays
RESIDENT between waves and tracks exactly what changed:

- **Host truth**: the same shard-major ``[S, cap, E]`` grids
  ``pack_fleet`` builds, plus per-slot metadata, mutated in place by
  :meth:`ResidentFleet.upsert` / :meth:`ResidentFleet.remove`.  The
  :class:`~.interning.InternTable` is append-only, so dense ids are
  stable for the fleet's lifetime.
- **Dirty masks**: every mutation marks its (shard, slot);
  :meth:`note_dirty` marks a key without a change.  A wave's planner
  drains :meth:`take_dirty` and replans ONLY the dirty shards
  (parallel/fleet_plan.py ``ResidentFleetPlanner``).
- **Capacity growth**: slot capacity doubles when a shard fills;
  growth bumps ``generation`` so the planner knows its device-resident
  copies are stale.
- **Oracle snapshot**: :meth:`snapshot_groups` reconstructs the
  :class:`~.columnar.GroupState` list for the full-repack path
  (``pack_fleet`` + ``WholeFleetPlanner``), which the incremental plan
  must bit-match.

Memory bound: ``max_groups`` LRU-evicts the least-recently-upserted
key (an evicted key re-inserts, and rescores, on its next wave).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..ops.diff import EMPTY
from .columnar import MODE_MODEL, MODE_NONE, MODE_SPEC, GroupState
from .interning import InternTable

#: upsert outcomes (returned so callers/tests can assert dirtiness
#: without reaching into the mask internals)
UPSERT_INSERTED = "inserted"
UPSERT_UPDATED = "updated"
UPSERT_MOVED = "moved"        # shard handoff: old AND new shard dirty
UPSERT_UNCHANGED = "unchanged"


@dataclass
class _Slot:
    """Per-slot host metadata the grids cannot carry (strings live on
    the host side of the interning boundary; features feed rescores)."""

    __slots__ = ("key", "group_arn", "nd", "no", "mode",
                 "client_ip_preservation", "spec_weight", "features")

    key: str
    group_arn: str
    nd: int                        # len(desired)
    no: int                        # len(observed)
    mode: int                      # MODE_* at upsert time
    client_ip_preservation: bool
    spec_weight: Optional[int]
    features: Optional[np.ndarray]  # [nd, F] float32 (MODE_MODEL)


class ResidentFleet:
    """Persistent columnar fleet arrays + per-shard dirty masks.

    NOT thread-safe by itself: the one consumer (the planner's wave)
    owns mutation; concurrent
    :meth:`note_dirty` from event handlers is safe under the GIL
    (set.add on an existing shard set).
    """

    def __init__(self, shards: int, endpoints_cap: int,
                 feature_dim: int = 8, groups_per_shard: int = 8,
                 max_groups: Optional[int] = None):
        if shards < 1:
            raise ValueError("shards must be >= 1")
        self.shards = shards
        self.endpoints_cap = endpoints_cap
        self.feature_dim = feature_dim
        self.cap = max(1, groups_per_shard)
        self.max_groups = max_groups
        self.arns = InternTable()
        #: bumps on capacity growth — device residency + compiled
        #: shapes keyed on it are stale when it moves
        self.generation = 0

        S, cap, E = shards, self.cap, endpoints_cap
        self.desired = np.full((S, cap, E), EMPTY, np.int32)
        self.observed = np.full((S, cap, E), EMPTY, np.int32)
        self.observed_w = np.full((S, cap, E), EMPTY, np.int32)
        self.cached_w = np.zeros((S, cap, E), np.int32)
        self.weight_mode = np.full((S, cap), MODE_NONE, np.int32)
        self.spec_w = np.full((S, cap), EMPTY, np.int32)
        self.fingerprints = np.zeros((S, cap), np.int64)
        #: cached_w row valid (False = model group needs a rescore)
        self.has_cache = np.zeros((S, cap), bool)

        # guarded-by: external: sweep-owner thread only — the fleet
        # is single-writer by contract (see class docstring)
        self._slots: List[List[Optional[_Slot]]] = [
            [None] * cap for _ in range(S)]
        # guarded-by: external: sweep-owner thread only
        self._free: List[List[int]] = [
            list(range(cap - 1, -1, -1)) for _ in range(S)]
        # guarded-by: external: sweep-owner thread only
        self._index: Dict[str, Tuple[int, int]] = {}
        # guarded-by: external: sweep-owner thread only
        self._lru: "OrderedDict[str, None]" = OrderedDict()
        # guarded-by: external: sweep owner clears; note_dirty()'s
        # cross-thread set.add is a single GIL-atomic op by design
        self._dirty: List[Set[int]] = [set() for _ in range(S)]

    # -- introspection --------------------------------------------------

    def location(self, key: str) -> Optional[Tuple[int, int]]:
        return self._index.get(key)

    def slot(self, s: int, gi: int) -> Optional[_Slot]:
        return self._slots[s][gi]

    def dirty_group_count(self) -> int:
        return sum(len(d) for d in self._dirty)

    # -- mutation (the dirty-mask feed) ---------------------------------

    def _id_row(self, what: str, key: str,
                ids: Sequence[str]) -> np.ndarray:
        E = self.endpoints_cap
        if len(ids) > E:
            raise ValueError(
                f"group {key!r} has {len(ids)} {what} endpoints, "
                f"exceeding endpoints_cap={E}; raise the cap (silent "
                f"truncation would strand endpoints)")
        row = np.full(E, EMPTY, np.int32)
        for j, a in enumerate(ids):
            row[j] = self.arns.intern(a)
        return row

    def _weight_row(self, weights: Sequence[Optional[int]],
                    n: int) -> np.ndarray:
        row = np.full(self.endpoints_cap, EMPTY, np.int32)
        for j, w in enumerate(weights):
            if j < n and w is not None:
                row[j] = int(w)
        return row

    def upsert(self, g: GroupState, force_rescore: bool = False) -> str:
        """Install/refresh one group's planning inputs; marks the
        owning shard dirty IFF something changed (an identical upsert
        is free — the steady-state fast path).

        ``g.features`` semantics: ``None`` on a MODE_MODEL group means
        "score inputs unchanged, reuse the resident cache" (the
        caller's fingerprint said so); provided features are compared
        and trigger a rescore when they moved.  ``g.cached_weights``
        is ignored — the resident ``cached_w`` grid IS the cache.
        """
        if not 0 <= g.shard < self.shards:
            raise ValueError(f"group {g.key!r} names shard {g.shard}, "
                             f"fleet has {self.shards}")
        moved = False
        prior_feats: Optional[np.ndarray] = None
        loc = self._index.get(g.key)
        if loc is not None and loc[0] != g.shard:
            # shard handoff: clear the old placement (old shard dirty),
            # then insert fresh on the new owner — carrying the stored
            # features across so an input-preserving move needs no
            # re-featurize from the caller
            old = self._slots[loc[0]][loc[1]]
            if old is not None:
                prior_feats = old.features
            self.remove(g.key)
            loc = None
            moved = True

        mode = g.mode()
        d_row = self._id_row("desired", g.key, g.desired)
        o_row = self._id_row("observed", g.key, g.observed)
        ow_row = self._weight_row(g.observed_weights, len(g.observed))
        sw = int(g.spec_weight) if mode == MODE_SPEC else EMPTY
        feats = (np.asarray(g.features, np.float32)
                 if g.features is not None else None)
        if feats is not None and feats.shape != (len(g.desired),
                                                 self.feature_dim):
            raise ValueError(
                f"group {g.key!r} features shape {feats.shape} != "
                f"({len(g.desired)}, {self.feature_dim})")

        if loc is None:
            s, gi = self._place(g.key, g.shard)
            verdict = UPSERT_MOVED if moved else UPSERT_INSERTED
            rescore = mode == MODE_MODEL
        else:
            s, gi = loc
            slot = self._slots[s][gi]
            desired_changed = not (
                np.array_equal(self.desired[s, gi], d_row))
            changed = (
                desired_changed
                or int(self.fingerprints[s, gi]) != int(g.fingerprint)
                or int(self.weight_mode[s, gi]) != mode
                or int(self.spec_w[s, gi]) != sw
                or slot.client_ip_preservation
                != g.client_ip_preservation
                or not np.array_equal(self.observed[s, gi], o_row)
                or not np.array_equal(self.observed_w[s, gi], ow_row))
            feats_changed = (
                feats is not None
                and (slot.features is None
                     or not np.array_equal(slot.features, feats)))
            if not changed and not feats_changed and not force_rescore:
                self._touch(g.key)
                return UPSERT_UNCHANGED
            verdict = UPSERT_UPDATED
            rescore = mode == MODE_MODEL and (
                desired_changed or feats_changed or force_rescore
                or not bool(self.has_cache[s, gi]))

        if mode == MODE_MODEL and feats is None:
            prior = self._slots[s][gi]
            if prior is not None and prior.features is not None:
                prior_feats = prior.features
            if (prior_feats is not None
                    and prior_feats.shape[0] == len(g.desired)):
                feats = prior_feats      # inputs intact, keep stored
            elif rescore:
                raise ValueError(
                    f"group {g.key!r} is model-planned and needs a "
                    f"rescore but carries no features")

        self.desired[s, gi] = d_row
        self.observed[s, gi] = o_row
        self.observed_w[s, gi] = ow_row
        self.weight_mode[s, gi] = mode
        self.spec_w[s, gi] = sw
        self.fingerprints[s, gi] = np.int64(g.fingerprint)
        if rescore:
            self.has_cache[s, gi] = False
        self._slots[s][gi] = _Slot(
            key=g.key, group_arn=g.group_arn, nd=len(g.desired),
            no=len(g.observed), mode=mode,
            client_ip_preservation=g.client_ip_preservation,
            spec_weight=g.spec_weight if mode == MODE_SPEC else None,
            features=feats if mode == MODE_MODEL else None)
        self._dirty[s].add(gi)
        self._touch(g.key)
        self._evict(keep=g.key)
        return verdict

    def remove(self, key: str) -> bool:
        """Drop a group: slot cleared to padding, shard dirty (the
        wave must replan the shard so the resident plan forgets it)."""
        loc = self._index.pop(key, None)
        if loc is None:
            return False
        s, gi = loc
        self.desired[s, gi] = EMPTY
        self.observed[s, gi] = EMPTY
        self.observed_w[s, gi] = EMPTY
        self.cached_w[s, gi] = 0
        self.weight_mode[s, gi] = MODE_NONE
        self.spec_w[s, gi] = EMPTY
        self.fingerprints[s, gi] = 0
        self.has_cache[s, gi] = False
        self._slots[s][gi] = None
        self._free[s].append(gi)
        self._dirty[s].add(gi)
        self._lru.pop(key, None)
        return True

    def note_dirty(self, key: str) -> bool:
        """Mark a key's shard dirty WITHOUT changing state — the
        informer watch-event feed: an update notification forces the
        next wave to replan the shard even though the describe hasn't
        happened yet (the wave's upsert then carries the real delta)."""
        loc = self._index.get(key)
        if loc is None:
            return False
        self._dirty[loc[0]].add(loc[1])
        return True

    def take_dirty(self) -> Dict[int, List[int]]:
        """Drain the dirty masks: {shard: sorted dirty slots}.  The
        caller (one wave) owns everything drained; a crash between
        take and splice re-dirties via the next upsert/describe."""
        out: Dict[int, List[int]] = {}
        for s in range(self.shards):
            if self._dirty[s]:
                out[s] = sorted(self._dirty[s])
                self._dirty[s] = set()
        return out

    def mark_scored(self, positions: Sequence[Tuple[int, int]]) -> None:
        """The wave planned these positions: model slots' caches are
        valid again (the planner wrote the fresh rows to cached_w)."""
        for s, gi in positions:
            if self.weight_mode[s, gi] == MODE_MODEL \
                    and self._slots[s][gi] is not None:
                self.has_cache[s, gi] = True

    # -- placement / growth ---------------------------------------------

    def _place(self, key: str, s: int) -> Tuple[int, int]:
        if not self._free[s]:
            self._grow()
        gi = self._free[s].pop()
        self._index[key] = (s, gi)
        return s, gi

    def _grow(self) -> None:
        """Double slot capacity fleet-wide.  Host arrays pad in place;
        ``generation`` bumps so the planner re-uploads device state
        and re-specialises its compiled shapes.  Dirty masks and the
        resident plan survive — only padding was added."""
        old, new = self.cap, max(2, self.cap * 2)
        grow = new - old

        def pad3(a, fill):
            return np.pad(a, ((0, 0), (0, grow), (0, 0)),
                          constant_values=fill)

        def pad2(a, fill):
            return np.pad(a, ((0, 0), (0, grow)), constant_values=fill)

        self.desired = pad3(self.desired, EMPTY)
        self.observed = pad3(self.observed, EMPTY)
        self.observed_w = pad3(self.observed_w, EMPTY)
        self.cached_w = pad3(self.cached_w, 0)
        self.weight_mode = pad2(self.weight_mode, MODE_NONE)
        self.spec_w = pad2(self.spec_w, EMPTY)
        self.fingerprints = pad2(self.fingerprints, 0)
        self.has_cache = pad2(self.has_cache, False)
        for s in range(self.shards):
            self._slots[s].extend([None] * grow)
            self._free[s].extend(range(new - 1, old - 1, -1))
        self.cap = new
        self.generation += 1

    def _touch(self, key: str) -> None:
        self._lru[key] = None
        self._lru.move_to_end(key)

    def _evict(self, keep: str) -> None:
        if self.max_groups is None:
            return
        while len(self._index) > self.max_groups:
            evicted, _ = self._lru.popitem(last=False)
            if evicted == keep:      # never evict the key just placed
                self._touch(keep)
                continue
            self.remove(evicted)

    # -- the oracle edge ------------------------------------------------

    def _state_at(self, s: int, gi: int) -> GroupState:
        slot = self._slots[s][gi]
        sof = self.arns.string_of
        desired = [sof(int(i)) for i in self.desired[s, gi][:slot.nd]]
        observed = [sof(int(i)) for i in self.observed[s, gi][:slot.no]]
        observed_w = [None if int(w) == EMPTY else int(w)
                      for w in self.observed_w[s, gi][:slot.no]]
        return GroupState(
            key=slot.key, group_arn=slot.group_arn, desired=desired,
            observed=observed, observed_weights=observed_w,
            features=slot.features,
            spec_weight=slot.spec_weight,
            model_planned=slot.mode == MODE_MODEL,
            client_ip_preservation=slot.client_ip_preservation,
            fingerprint=int(self.fingerprints[s, gi]), shard=s,
            cached_weights=None)

    def snapshot_groups(self) -> List[GroupState]:
        """Reconstruct every resident group for the FULL-REPACK ORACLE
        (``cached_weights=None`` throughout: the oracle rescores
        everything, and determinism makes rescored == cached bit-exact).  Shard-major order,
        matching ``pack_fleet``'s placement so oracle outputs align
        positionally with the resident arrays per shard."""
        out: List[GroupState] = []
        for s in range(self.shards):
            for gi in range(self.cap):
                if self._slots[s][gi] is not None:
                    out.append(self._state_at(s, gi))
        return out

    def occupied_positions(self) -> List[Tuple[int, int]]:
        """(shard, slot) of every resident group, shard-major — the
        order :meth:`snapshot_groups` emits, which is also the order
        ``pack_fleet`` re-places the snapshot in per shard."""
        return [(s, gi)
                for s in range(self.shards)
                for gi in range(self.cap)
                if self._slots[s][gi] is not None]
