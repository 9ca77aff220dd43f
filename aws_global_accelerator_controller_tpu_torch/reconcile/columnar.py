"""Columnar whole-fleet desired-state packing.

The port's own copy of the JAX package's ``reconcile/columnar.py``
(host-side numpy, no device code).  It packs the whole fleet's planning
inputs into dense arrays once per wave so one device pass
(parallel/fleet_plan.py) plans every endpoint group at once:

- **Intern tables** (:class:`InternTable`): every ARN is interned to a
  dense int32 id; ids are the comparable tokens on the device, strings
  never leave the host.
- **Id grids**: desired and observed endpoint memberships as
  ``[S, Gs, E]`` int32 grids (``EMPTY``-padded), observed weights as a
  parallel int32 grid, shard-major.
- **Packed score rows**: features pack as CSR-like rows ``[S, Ns, F]``,
  one row per valid (rescored, model-planned) endpoint, with
  ``row_seg``/``row_slot`` scatter coordinates; pad rows carry an
  out-of-bounds ``row_seg`` and are dropped by the planner.
- **Cached weights**: the last-planned weight grid rides along so a
  wave rescores only groups whose planning inputs changed.

Decode (:func:`decode_intents`) is the inverse edge: the planner's
nonzero diff rows come back as :class:`EndpointOp` mutation intents per
group, removes first, then adds (at the planned weight), then
re-weights.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.diff import EMPTY
from .interning import InternTable

# weight_mode column values: how a group's desired weights are decided
MODE_MODEL = 0   # spec.weight null -> model-planned 255-budget split
MODE_SPEC = 1    # explicit spec.weight broadcast to every endpoint
MODE_NONE = 2    # no target at all (static policy, null weight):
                 # membership still diffs, weights are left alone


@dataclass(frozen=True)
class EndpointOp:
    """One endpoint-group mutation intent (the port's copy of the JAX
    package's ``cloudprovider/aws/batcher.py::EndpointOp``): ``set``
    ensures a member with this weight, ``weight`` re-weights a member,
    ``remove`` drops it."""

    kind: str
    endpoint_id: str = ""
    weight: Optional[int] = None
    client_ip_preservation: bool = False


def op_set(endpoint_id: str, weight: Optional[int] = None,
           client_ip_preservation: bool = False) -> EndpointOp:
    return EndpointOp("set", endpoint_id, weight, client_ip_preservation)


def op_weight(endpoint_id: str, weight: Optional[int]) -> EndpointOp:
    return EndpointOp("weight", endpoint_id, weight)


def op_remove(endpoint_id: str) -> EndpointOp:
    return EndpointOp("remove", endpoint_id)


@dataclass
class GroupState:
    """One endpoint group's planning inputs (host-side, pre-pack)."""

    key: str                      # object key (ns/name)
    group_arn: str                # AWS-side container (routing key)
    desired: Sequence[str]        # desired endpoint ARNs
    observed: Sequence[str]       # observed endpoint ARNs
    #: observed weights aligned with ``observed``; None = unknown
    observed_weights: Sequence[Optional[int]] = ()
    #: [len(desired), F] float features; required for MODE_MODEL groups
    features: Optional[np.ndarray] = None
    #: explicit spec.weight (MODE_SPEC) or None
    spec_weight: Optional[int] = None
    #: False = static policy with null weight (MODE_NONE)
    model_planned: bool = True
    client_ip_preservation: bool = False
    #: stable planning-input fingerprint; drives incremental rescore
    fingerprint: int = 0
    #: owning shard (shard-major placement)
    shard: int = 0
    #: cached desired weights from the last plan, aligned with
    #: ``desired``; when the fingerprint still matches, the pass
    #: reuses these instead of rescoring
    cached_weights: Optional[Sequence[int]] = None

    def mode(self) -> int:
        if self.spec_weight is not None:
            return MODE_SPEC
        return MODE_MODEL if self.model_planned else MODE_NONE


@dataclass
class ColumnarFleet:
    """The packed fleet: shard-major grids + CSR score rows.

    Shapes: ``S`` shards x ``Gs`` groups per shard (padded) x ``E``
    endpoint slots; ``Ns`` packed score rows per shard (padded).
    Grids are numpy; the planner copies them to its device.
    """

    arns: InternTable
    groups: List[GroupState]          # real groups, shard-major order
    shards: int                       # S
    groups_per_shard: int             # Gs
    endpoints_cap: int                # E

    desired: np.ndarray               # [S, Gs, E] int32 intern ids
    observed: np.ndarray              # [S, Gs, E] int32 intern ids
    observed_w: np.ndarray            # [S, Gs, E] int32 (EMPTY=unknown)
    cached_w: np.ndarray              # [S, Gs, E] int32 last-planned
    weight_mode: np.ndarray           # [S, Gs] int32 MODE_*
    rescored: np.ndarray              # [S, Gs] bool
    fingerprints: np.ndarray          # [S, Gs] int64
    spec_w: np.ndarray                # [S, Gs] int32 (EMPTY if n/a)

    feat_rows: np.ndarray             # [S, Ns, F] float32
    row_seg: np.ndarray               # [S, Ns] int32 local group (Gs=pad)
    row_slot: np.ndarray              # [S, Ns] int32 endpoint slot

    #: (shard, local index) of each real group, aligned with ``groups``
    locations: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def total_groups(self) -> int:
        return len(self.groups)

    # -- flat views ------------------------------------------------------

    def flat_grids(self):
        """Grids flattened to [S*Gs, ...] for the flat layout."""
        S, Gs, E = self.desired.shape
        return (self.desired.reshape(S * Gs, E),
                self.observed.reshape(S * Gs, E),
                self.observed_w.reshape(S * Gs, E),
                self.cached_w.reshape(S * Gs, E),
                self.weight_mode.reshape(S * Gs),
                self.spec_w.reshape(S * Gs))

    def flat_rows(self):
        """CSR rows flattened with GLOBAL group indices; pad rows get
        seg == S*Gs, which the planner masks out of its scatter."""
        S, Ns, F = self.feat_rows.shape
        Gs = self.groups_per_shard
        seg = self.row_seg.astype(np.int64)
        shard_base = (np.arange(S, dtype=np.int64)[:, None]
                      * np.int64(Gs))
        global_seg = np.where(seg >= Gs, np.int64(S) * Gs,
                              seg + shard_base)
        return (self.feat_rows.reshape(S * Ns, F),
                global_seg.reshape(S * Ns).astype(np.int32),
                self.row_slot.reshape(S * Ns))


def _pad_rows_bucket(n: int, minimum: int = 8) -> int:
    """Round row counts up to a power-of-two bucket, so the shapes a
    wave hands the device repeat across waves (the JAX package's reason
    is its compile cache; here it keeps shapes stable for a later CUDA
    graph).  Outputs never depend on the bucket."""
    b = max(minimum, 1)
    while b < n:
        b *= 2
    return b


def pack_fleet(groups: Sequence[GroupState], endpoints_cap: int,
               shards: int = 1, feature_dim: int = 8) -> ColumnarFleet:
    """Pack per-group planning state into the columnar fleet layout.

    Groups are placed shard-major (``GroupState.shard``); each shard's
    group count pads to the fleet-wide maximum, each shard's packed
    score-row count pads to a shared power-of-two bucket.  A group
    whose endpoint lists exceed ``endpoints_cap`` raises — silent
    truncation would strand endpoints exactly like the FleetPlanner
    encode path refuses to.
    """
    if shards < 1:
        raise ValueError("shards must be >= 1")
    table = InternTable()
    per_shard: List[List[GroupState]] = [[] for _ in range(shards)]
    for g in groups:
        if not 0 <= g.shard < shards:
            raise ValueError(
                f"group {g.key!r} names shard {g.shard}, fleet has "
                f"{shards}")
        for what, ids in (("desired", g.desired),
                          ("observed", g.observed)):
            if len(ids) > endpoints_cap:
                raise ValueError(
                    f"group {g.key!r} has {len(ids)} {what} endpoints, "
                    f"exceeding endpoints_cap={endpoints_cap}; raise "
                    f"the cap (silent truncation would strand "
                    f"endpoints)")
        per_shard[g.shard].append(g)

    S, E = shards, endpoints_cap
    Gs = max(1, max(len(b) for b in per_shard))
    desired = np.full((S, Gs, E), EMPTY, np.int32)
    observed = np.full((S, Gs, E), EMPTY, np.int32)
    observed_w = np.full((S, Gs, E), EMPTY, np.int32)
    cached_w = np.zeros((S, Gs, E), np.int32)
    weight_mode = np.full((S, Gs), MODE_NONE, np.int32)
    rescored = np.zeros((S, Gs), bool)
    fingerprints = np.zeros((S, Gs), np.int64)
    spec_w = np.full((S, Gs), EMPTY, np.int32)

    rows: List[List[Tuple[np.ndarray, int, int]]] = [
        [] for _ in range(shards)]
    ordered: List[GroupState] = []
    locations: List[Tuple[int, int]] = []
    for s, bucket in enumerate(per_shard):
        for gi, g in enumerate(bucket):
            ordered.append(g)
            locations.append((s, gi))
            for j, arn in enumerate(g.desired):
                desired[s, gi, j] = table.intern(arn)
            obs_w = list(g.observed_weights)
            for j, arn in enumerate(g.observed):
                observed[s, gi, j] = table.intern(arn)
                if j < len(obs_w) and obs_w[j] is not None:
                    observed_w[s, gi, j] = int(obs_w[j])
            mode = g.mode()
            weight_mode[s, gi] = mode
            fingerprints[s, gi] = np.int64(g.fingerprint)
            if mode == MODE_SPEC:
                spec_w[s, gi] = int(g.spec_weight)
            if g.cached_weights is not None:
                for j, w in enumerate(g.cached_weights):
                    if j < E and w is not None:
                        cached_w[s, gi, j] = int(w)
            # a MODE_MODEL group with no usable cache packs one feature
            # row per desired endpoint; a cache hit packs nothing (the
            # incremental wave's whole point) — the caller clears
            # ``cached_weights`` when the fingerprint moved
            if mode == MODE_MODEL and g.cached_weights is None:
                if g.features is None:
                    raise ValueError(
                        f"group {g.key!r} is model-planned with no "
                        f"cached weights but carries no features")
                feats = np.asarray(g.features, np.float32)
                if feats.shape != (len(g.desired), feature_dim):
                    raise ValueError(
                        f"group {g.key!r} features shape "
                        f"{feats.shape} != "
                        f"({len(g.desired)}, {feature_dim})")
                rescored[s, gi] = True
                for j in range(len(g.desired)):
                    rows[s].append((feats[j], gi, j))

    Ns = _pad_rows_bucket(max((len(r) for r in rows), default=1))
    feat_rows = np.zeros((S, Ns, feature_dim), np.float32)
    row_seg = np.full((S, Ns), Gs, np.int32)   # Gs = out-of-bounds pad
    row_slot = np.zeros((S, Ns), np.int32)
    for s in range(S):
        for k, (f, gi, j) in enumerate(rows[s]):
            feat_rows[s, k] = f
            row_seg[s, k] = gi
            row_slot[s, k] = j

    return ColumnarFleet(
        arns=table, groups=ordered, shards=S, groups_per_shard=Gs,
        endpoints_cap=E, desired=desired, observed=observed,
        observed_w=observed_w, cached_w=cached_w,
        weight_mode=weight_mode, rescored=rescored,
        fingerprints=fingerprints, spec_w=spec_w, feat_rows=feat_rows,
        row_seg=row_seg, row_slot=row_slot, locations=locations)


@dataclass
class GroupIntent:
    """One group's decoded mutation intents.  An empty ``ops`` list is
    the planner's converged verdict for the group — the read-only
    sweep answer."""

    key: str
    group_arn: str
    ops: List[object]
    #: planned desired weights by endpoint ARN (the cache feed)
    weights: Dict[str, int]


def decode_group_intent(key: str, group_arn: str,
                        desired: Sequence[str],
                        observed: Sequence[str],
                        has_target: bool,
                        client_ip_preservation: bool,
                        desired_w_row: np.ndarray,
                        add_row: np.ndarray, remove_row: np.ndarray,
                        reweight_row: np.ndarray) -> GroupIntent:
    """Decode ONE group's planner output rows into a
    :class:`GroupIntent` — removes, then adds at the planned weight,
    then re-weights, mirroring the per-object reconcile order.  Shared
    by the full-repack decode below and the resident planner's
    dirty-position decode (parallel/fleet_plan.py) so the two paths
    cannot drift apart."""
    ops: List[object] = []
    for j, arn in enumerate(observed):
        if remove_row[j]:
            ops.append(op_remove(arn))
    weights: Dict[str, int] = {}
    for j, arn in enumerate(desired):
        w = int(desired_w_row[j])
        if has_target:
            weights[arn] = w
        if add_row[j]:
            ops.append(op_set(
                arn, weight=w if has_target else None,
                client_ip_preservation=client_ip_preservation))
        elif has_target and reweight_row[j]:
            ops.append(op_weight(arn, w))
    return GroupIntent(key=key, group_arn=group_arn, ops=ops,
                       weights=weights)


def decode_intents(fleet: ColumnarFleet, desired_w: np.ndarray,
                   to_add: np.ndarray, to_remove: np.ndarray,
                   to_reweight: np.ndarray) -> List[GroupIntent]:
    """Nonzero diff rows -> EndpointOp intents, per real group.

    Inputs are the planner outputs reshaped ``[S, Gs, E]`` (numpy, on
    the host).
    """
    out: List[GroupIntent] = []
    for g, (s, gi) in zip(fleet.groups, fleet.locations):
        out.append(decode_group_intent(
            g.key, g.group_arn, g.desired, g.observed,
            g.mode() != MODE_NONE, g.client_ip_preservation,
            desired_w[s, gi], to_add[s, gi], to_remove[s, gi],
            to_reweight[s, gi]))
    return out
