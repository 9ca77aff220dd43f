"""Device-resident whole-fleet planner (flat and sharded layouts).

The port of the JAX package's ``parallel/fleet_plan.py``.  One device
pass scores every rescored endpoint in the fleet (packed CSR rows, no
padding-lane matmuls), quantises scores into Global Accelerator weight
allocations, and diffs plan-vs-observed for EVERY group, memberships
and weights, in vectorized ops whose nonzero rows decode into
``EndpointOp`` mutation intents (reconcile/columnar.py).

On a CUDA device the pass runs the port's kernels: the fused MLP's
row-scoring entry (K3, ``ops/cuda_mlp.py``) for ``score_rows``, the
quantizer (K2, ``ops/cuda_weights.py``) and, in the incremental pass,
the in-place row splice (K4, ``parallel/fleet.py``).  With
``device="cpu"`` the same pass runs their plain versions.

:class:`ResidentFleetPlanner` keeps the packed grids RESIDENT on the
device between waves and replans only the shards a
:class:`~..reconcile.resident.ResidentFleet`'s dirty masks name.  The
full-repack :class:`WholeFleetPlanner` is its ORACLE: incremental
output must bit-match it (:meth:`ResidentFleetPlanner.verify_full_repack`).

The sharded layout runs over a mesh of ranks (``parallel/mesh.py``):
``WholeFleetPlanner(world=...)`` with ``1 < fleet.shards <= world.size``
lays the shards on a ``("data", "model")`` mesh with data = shards and
model = 1, as the reference's ``_mesh_for`` does; every rank of the
world calls :meth:`WholeFleetPlanner.plan` together, each rank of the
mesh plans its own shard, the stats cross the data axis through the
stats ring (kernel K5, ``ops/cuda_ring.py``), and the shards' plans are
gathered so that every rank returns the whole result.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import Device, resolve_device
from ..models.traffic import TrafficPolicyModel
from ..ops.cuda_ring import peer_slots, stats_ring_cuda, stats_ring_plain
from ..ops.cuda_weights import plan_weights_cuda
from ..ops.diff import EMPTY, plan_observed_diff
from ..reconcile.columnar import (
    MODE_MODEL,
    MODE_NONE,
    MODE_SPEC,
    ColumnarFleet,
    GroupIntent,
    GroupState,
    _pad_rows_bucket,
    decode_group_intent,
    decode_intents,
    pack_fleet,
)
from .distributed import Group, World
from .fleet import DeviceGridRing, make_row_splice
from .mesh import Mesh, make_mesh

#: stats vector layout (float32)
STAT_ADDS, STAT_REMOVES, STAT_REWEIGHTS, STAT_LIVE, STAT_RESCORED = \
    range(5)


def _device_plan_block(score_rows, quantize, params, rows, seg, slot,
                       desired, observed, observed_w, cached_w,
                       rescored, mode, spec_w):
    """One block's whole plan: scores -> weights -> diff -> stats.

    ``rows [N, F]`` packed features with scatter coords ``seg``/``slot``;
    a row whose ``seg`` is out of bounds (``>= G``) is a pad row and is
    dropped: it scatters into a spare row past the grid, which is cut
    off (the JAX pass drops it with ``mode="drop"``).  Grids ``[G, E]``.
    """
    G, E = desired.shape
    s = score_rows(params, rows)                       # [N] float32
    grid = torch.zeros((G + 1, E), dtype=torch.float32,
                       device=desired.device)
    keep_seg = torch.where((seg >= 0) & (seg < G), seg, G).long()
    grid.index_put_((keep_seg, slot.long()), s)
    grid = grid[:G]
    mask = desired != EMPTY
    planned = quantize(grid, mask)                     # [G, E] int32
    fresh = torch.where(rescored[:, None], planned, cached_w)
    spec_col = torch.where(mask, spec_w.clamp_min(0)[:, None], 0)
    desired_w = torch.where((mode == MODE_SPEC)[:, None], spec_col, fresh)
    to_add, to_remove, in_both, obs_w = plan_observed_diff(
        desired, observed, observed_w)
    has_target = (mode != MODE_NONE)[:, None]
    to_reweight = in_both & has_target & (desired_w != obs_w)
    stats = torch.stack([
        to_add.sum(), to_remove.sum(), to_reweight.sum(),
        mask.sum(), rescored.sum(),
    ]).to(torch.float32)
    return desired_w.to(torch.int32), to_add, to_remove, to_reweight, stats


def _make_stats_ring(group: Group, device: Device = "cuda"):
    """The cross-shard stats all-reduce over ``group`` (the reference's
    ``_make_stats_ring``): ``reduce(stats [k]) -> [k]``, every rank's sum
    in the ring's order, own stats first, then the left neighbour's.  On
    CUDA tensors it runs kernel K5's exchange, whose inboxes and events
    are mapped here, collectively over the group; on CPU tensors the
    plain ring's n - 1 hops over gloo.  A group of one reduces nothing."""
    dev = resolve_device(device)
    slots = (peer_slots(group, dev)
             if dev.type == "cuda" and group.size > 1 else None)

    def reduce(stats: torch.Tensor) -> torch.Tensor:
        if group.size == 1:
            return stats.to(torch.float32)
        if stats.device.type == "cpu":
            return stats_ring_plain(group, stats)
        if slots is None:
            raise ValueError(f"the stats ring was made for {dev}, not for "
                             f"{stats.device}")
        return stats_ring_cuda(slots, stats)

    return reduce


def make_fleet_pass(model, mesh: Optional[Mesh] = None):
    """The whole-fleet pass, on whatever device its inputs lie on.

    Without a mesh: the flat pass over ``[G, E]`` grids + global-seg
    rows.  With one: this rank's pass of the sharded program (the
    reference's shard_mapped ``_device_fleet_shard``) over its shard's
    ``[Gs, E]`` grids + local-seg ``[Ns]`` rows; its stats are averaged
    over the ``"model"`` axis (``pmean``), then summed over ``"data"``
    by the stats ring, so every rank of the mesh returns the fleet's."""
    block = partial(_device_plan_block, model.score_rows, plan_weights_cuda)
    if mesh is None:
        return block
    ring = _make_stats_ring(mesh.groups["data"], mesh.world.device)
    replicas = mesh.groups.get("model")

    def sharded(*args):
        desired_w, to_add, to_remove, to_reweight, stats = block(*args)
        if replicas is not None:
            stats = replicas.all_reduce(stats) / torch.tensor(
                float(replicas.size), device=stats.device)
        return desired_w, to_add, to_remove, to_reweight, ring(stats)

    return sharded


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


@dataclass
class FleetPlanResult:
    """Whole-fleet plan outputs (numpy, shard-major ``[S, Gs, E]``)."""

    fleet: ColumnarFleet
    device: str
    layout: str                       # "sharded" | "flat"
    desired_w: np.ndarray
    to_add: np.ndarray
    to_remove: np.ndarray
    to_reweight: np.ndarray
    stats: Dict[str, float]

    def intents(self) -> List[GroupIntent]:
        return decode_intents(self.fleet, self.desired_w, self.to_add,
                              self.to_remove, self.to_reweight)


def _default_params(model, params, seed: int, device: torch.device):
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        return model.init_params(gen, device=device)
    return {k: v.to(device) for k, v in params.items()}


class WholeFleetPlanner:
    """Host wrapper: packed fleets in, decoded mutation intents out.

    Always a FULL repack+replan, pure over its inputs; the ORACLE that
    the incremental planner must bit-match, and the one-shot path for
    callers without resident state.  Runs on ``device`` (default the
    world's, else the card; ``"cpu"`` only when asked).  ``world`` (of
    :func:`~.distributed.join_world`; default a world of one) gives the
    ranks a fleet of several shards is laid over: every rank of it calls
    :meth:`plan` together and gets the whole result.
    """

    def __init__(self, model=None, params=None, seed: int = 0,
                 device: Optional[Device] = None,
                 world: Optional[World] = None):
        if world is not None and device is not None \
                and resolve_device(device) != world.device:
            raise ValueError(f"device {device} is not the world's "
                             f"{world.device}")
        self.device = (world.device if world is not None
                       else resolve_device(device or "cuda"))
        self.world = world or World(0, 1, self.device, None)
        self.model = model or TrafficPolicyModel()
        self.params = _default_params(self.model, params, seed,
                                      self.device)
        self._fn = make_fleet_pass(self.model)
        self._meshes: Dict[int, Optional[Mesh]] = {}
        self._passes: Dict[int, object] = {}

    def _mesh_for(self, shards: int) -> Tuple[bool, Optional[Mesh]]:
        """(sharded, mesh): a ``("data" = shards, "model" = 1)`` mesh when
        the world has the ranks for it, else the flat layout; ``mesh`` is
        None on a rank outside it.  Made collectively on first use."""
        if shards <= 1 or shards > self.world.size:
            return False, None
        if shards not in self._meshes:
            self._meshes[shards] = make_mesh(
                self.world, ("data", "model"),
                shape={"data": shards, "model": 1})
        return True, self._meshes[shards]

    def prepare(self, fleet: ColumnarFleet):
        """The device pass and its argument tensors for ``fleet``:
        ``(fn, rows, rest)`` with the pass invoked as
        ``fn(params, rows, *rest)``; in the sharded layout, this rank's
        pass over its own shard."""
        sharded, mesh = self._mesh_for(fleet.shards)
        if not sharded:
            rows, seg, slot = fleet.flat_rows()
            grids = fleet.flat_grids()
            rescored, fn = fleet.rescored.reshape(-1), self._fn
        elif mesh is None:
            raise ValueError(f"rank {self.world.rank} lies outside the "
                             f"{fleet.shards}-shard mesh: no shard of its "
                             f"own to plan")
        else:
            r = mesh.coords["data"]
            rows, seg, slot = (fleet.feat_rows[r], fleet.row_seg[r],
                               fleet.row_slot[r])
            grids = tuple(a[r] for a in (
                fleet.desired, fleet.observed, fleet.observed_w,
                fleet.cached_w, fleet.weight_mode, fleet.spec_w))
            rescored = fleet.rescored[r]
            if fleet.shards not in self._passes:
                self._passes[fleet.shards] = make_fleet_pass(self.model,
                                                             mesh)
            fn = self._passes[fleet.shards]
        desired, observed, observed_w, cached_w, mode, spec_w = grids
        rest = tuple(_to_device(a, self.device) for a in (
            seg, slot, desired, observed, observed_w, cached_w, rescored,
            mode, spec_w))
        return fn, _to_device(rows, self.device), rest

    def plan(self, fleet: ColumnarFleet) -> FleetPlanResult:
        """One whole-fleet pass; outputs copied back to the host."""
        S, Gs, E = fleet.desired.shape
        sharded, mesh = self._mesh_for(fleet.shards)
        if not sharded:
            fn, rows, rest = self.prepare(fleet)
            desired_w, to_add, to_remove, to_reweight, stats = (
                t.cpu().numpy() for t in fn(self.params, rows, *rest))
            planes = (desired_w, to_add, to_remove, to_reweight)
        else:
            planes, stats = self._plan_sharded(fleet, mesh)
        desired_w, to_add, to_remove, to_reweight = (
            p.reshape(S, Gs, E) for p in planes)
        return FleetPlanResult(
            fleet=fleet, device=str(self.device),
            layout="sharded" if sharded else "flat",
            desired_w=desired_w, to_add=to_add, to_remove=to_remove,
            to_reweight=to_reweight,
            stats={
                "adds": float(stats[STAT_ADDS]),
                "removes": float(stats[STAT_REMOVES]),
                "reweights": float(stats[STAT_REWEIGHTS]),
                "live_endpoints": float(stats[STAT_LIVE]),
                "rescored_groups": float(stats[STAT_RESCORED]),
                "groups": float(fleet.total_groups),
            })

    def _plan_sharded(self, fleet: ColumnarFleet, mesh: Optional[Mesh]):
        """Each rank of the mesh plans its shard; the shards' planes are
        gathered over the data axis (staged through the host: the port's
        ``out_specs=P("data")``), and a world larger than the mesh gets
        them from rank 0.  Returns the numpy planes ``[S, Gs, E]`` (int32
        weights, bool masks) and the ring's stats."""
        S, Gs, E = fleet.desired.shape
        if mesh is not None:
            fn, rows, rest = self.prepare(fleet)
            *planes, stats = fn(self.params, rows, *rest)
            local = torch.stack([p.to(torch.int32) for p in planes])
            whole = mesh.groups["data"].all_gather(local)
        else:           # what rank 0 broadcasts: the shapes and types
            whole = torch.empty((S, 4, Gs, E), dtype=torch.int32,
                                device=self.device)
            stats = torch.empty(STAT_RESCORED + 1, dtype=torch.float32,
                                device=self.device)
        if S < self.world.size:
            everyone = Group(range(self.world.size), self.world.rank)
            whole, stats = everyone.broadcast(whole), everyone.broadcast(
                stats)
        planes = whole.transpose(0, 1).cpu().numpy()
        return ((planes[0], planes[1].astype(bool), planes[2].astype(bool),
                 planes[3].astype(bool)), stats.cpu().numpy())

    def plan_groups(self, groups: Sequence[GroupState],
                    endpoints_cap: int = 16,
                    shards: int = 1) -> FleetPlanResult:
        """Convenience: pack + plan in one call."""
        fleet = pack_fleet(groups, endpoints_cap=endpoints_cap,
                           shards=shards,
                           feature_dim=self.model.feature_dim)
        return self.plan(fleet)


# ---------------------------------------------------------------------------
# incremental resident planner
# ---------------------------------------------------------------------------


def make_incremental_pass(model, splice):
    """The dirty-shard pass: splice dirty rows into the resident grids
    (in place), replan the dirty shards, write fresh weight caches back
    (in place), all on the resident grids' device.

    Shapes: resident grids ``[S, cap, (E)]``; ``K`` spliced rows at
    host positions ``(ks, kg)``, the six grids' row blocks host arrays
    too (``splice`` uploads them in one copy and writes every grid in
    one launch, reading nothing back); ``Dbp`` gathered shards named by
    ``idx``, of which the first ``Db`` are real (the rest repeat
    ``idx[0]`` and are never written back); ``Np`` packed score rows
    with batch-global ``seg`` (``Dbp*cap`` = pad).  The planning math is
    :func:`_device_plan_block`, the block the oracle runs, so
    per-group-row independence makes incremental == full bit-exact.
    """
    block = partial(_device_plan_block, model.score_rows, plan_weights_cuda)

    def incremental(params, res, ks, kg, rows6, idx, db, srows, seg, slot,
                    rescored):
        res_d, res_o, res_ow, res_cw, res_m, res_sw = res
        # 1. splice the wave's dirty rows into the resident grids
        splice(res, ks, kg, rows6)
        # 2. gather the dirty shards and replan them as one block
        Dbp = idx.shape[0]
        S, cap, E = res_d.shape
        ix = idx.long()

        def flat(a):
            return a[ix].reshape(Dbp * cap, *a.shape[2:])

        desired_w, to_add, to_remove, to_reweight, _ = block(
            params, srows, seg, slot, flat(res_d), flat(res_o),
            flat(res_ow), flat(res_cw), rescored.reshape(-1),
            flat(res_m), flat(res_sw))
        # 3. write fresh caches back (rescored rows only), real shards
        #    only: the pad entries of idx are never written
        new_cw = torch.where(rescored.reshape(-1)[:, None], desired_w,
                             flat(res_cw)).reshape(Dbp, cap, E)
        res_cw[ix[:db]] = new_cw[:db]
        shape = (Dbp, cap, E)
        return ((res_d, res_o, res_ow, res_cw, res_m, res_sw),
                desired_w.reshape(shape), to_add.reshape(shape),
                to_remove.reshape(shape), to_reweight.reshape(shape))

    return incremental


@dataclass
class WaveResult:
    """One incremental wave's outcome."""

    device: str
    dirty_shards: int
    dirty_groups: int
    device_call: bool                 # False = zero-dirty fast path
    intents: List[GroupIntent]        # dirty positions only
    stats: Dict[str, float] = field(default_factory=dict)


class ResidentFleetPlanner:
    """Incremental planner over a :class:`~..reconcile.resident.
    ResidentFleet`: drains the dirty masks, replans ONLY the dirty
    shards on the device, and splices the results into a persistent
    host-side plan (``planned_w`` / ``to_add`` / ``to_remove`` /
    ``to_reweight``, ``[S, cap, E]``).

    The grids stay resident in a :class:`~.fleet.DeviceGridRing`; each
    wave splices its dirty rows into them in place.  A zero-dirty wave
    never touches the device.  :meth:`verify_full_repack` repacks the
    resident truth through the :class:`WholeFleetPlanner` ORACLE and
    demands bit-equality.
    """

    def __init__(self, fleet, model=None, params=None, seed: int = 0,
                 device: Device = "cuda"):
        self.device = resolve_device(device)
        self.fleet = fleet
        self.model = model or TrafficPolicyModel()
        self.params = _default_params(self.model, params, seed,
                                      self.device)
        self.ring = DeviceGridRing(self.device)
        self._pass = make_incremental_pass(
            self.model, make_row_splice(self.device))
        self._gen = fleet.generation
        self.device_calls = 0
        self.waves = 0
        S, cap, E = fleet.shards, fleet.cap, fleet.endpoints_cap
        self.planned_w = np.zeros((S, cap, E), np.int32)
        self.to_add = np.zeros((S, cap, E), bool)
        self.to_remove = np.zeros((S, cap, E), bool)
        self.to_reweight = np.zeros((S, cap, E), bool)

    # -- residency maintenance -----------------------------------------

    def _sync_generation(self) -> None:
        """Capacity growth invalidates device residency; the host plan
        just pads (old positions kept)."""
        if self._gen == self.fleet.generation:
            return
        cap = self.fleet.cap
        grow = cap - self.planned_w.shape[1]
        if grow > 0:
            pad = ((0, 0), (0, grow), (0, 0))
            self.planned_w = np.pad(self.planned_w, pad)
            self.to_add = np.pad(self.to_add, pad)
            self.to_remove = np.pad(self.to_remove, pad)
            self.to_reweight = np.pad(self.to_reweight, pad)
        self.ring.drop()
        self._gen = self.fleet.generation

    def _resident_front(self):
        """Current device-resident grids; the first wave (or one after
        growth) uploads the host truth wholesale."""
        front = self.ring.front
        if front is None:
            f = self.fleet
            front = self.ring.reset((
                f.desired, f.observed, f.observed_w, f.cached_w,
                f.weight_mode, f.spec_w))
        return front

    # -- the wave ------------------------------------------------------

    def plan_wave(self) -> WaveResult:
        """Drain the fleet's dirty masks and replan exactly those
        shards.  Zero dirt = zero device work (``device_calls`` stays
        put)."""
        self._sync_generation()
        f = self.fleet
        dirty = f.take_dirty()
        self.waves += 1
        if not dirty:
            return WaveResult(device=str(self.device), dirty_shards=0,
                              dirty_groups=0, device_call=False,
                              intents=[],
                              stats={"adds": 0.0, "removes": 0.0,
                                     "reweights": 0.0,
                                     "rescored_groups": 0.0})

        S, cap, E, F = f.shards, f.cap, f.endpoints_cap, f.feature_dim
        ds = sorted(dirty)
        Db = len(ds)
        positions = [(s, gi) for s in ds for gi in dirty[s]]
        K = len(positions)

        # dirty-row splice batch (row-granular host->device traffic:
        # the K real rows, not S*cap), packed with its positions into one
        # upload by the splice
        ks = np.fromiter((s for s, _ in positions), np.int32, K)
        kg = np.fromiter((gi for _, gi in positions), np.int32, K)
        pos_idx = (ks, kg)
        rows6 = (f.desired[pos_idx], f.observed[pos_idx],
                 f.observed_w[pos_idx], f.cached_w[pos_idx],
                 f.weight_mode[pos_idx], f.spec_w[pos_idx])

        # gathered dirty-shard batch + packed score rows for slots
        # needing a rescore
        Dbp = _pad_rows_bucket(Db, minimum=1)
        idx = np.full(Dbp, ds[0], np.int32)
        idx[:Db] = ds
        batch_of = {s: b for b, s in enumerate(ds)}
        rescored = np.zeros((Dbp, cap), bool)
        srow_list: List[Tuple[np.ndarray, int, int]] = []
        for s, gi in positions:
            slot = f.slot(s, gi)
            if (slot is None or slot.mode != MODE_MODEL
                    or f.has_cache[s, gi]):
                continue
            if slot.features is None:
                raise ValueError(
                    f"resident slot {slot.key!r} needs a rescore but "
                    f"holds no features")
            b = batch_of[s]
            rescored[b, gi] = True
            for j in range(slot.nd):
                srow_list.append((slot.features[j], b * cap + gi, j))
        Np = _pad_rows_bucket(len(srow_list))
        srows = np.zeros((Np, F), np.float32)
        seg = np.full(Np, Dbp * cap, np.int32)   # out of bounds = drop
        slot_col = np.zeros(Np, np.int32)
        for i, (row, sg, j) in enumerate(srow_list):
            srows[i], seg[i], slot_col[i] = row, sg, j

        dev = self.device
        res = self._resident_front()
        new_res, d_w, add, rm, rw = self._pass(
            self.params, res, ks, kg, rows6, _to_device(idx, dev), Db,
            _to_device(srows, dev), _to_device(seg, dev),
            _to_device(slot_col, dev),
            _to_device(rescored, dev))
        self.ring.advance(new_res)
        # synchronous copies: complete before the next wave's splice
        d_w, add, rm, rw = (t.cpu().numpy() for t in (d_w, add, rm, rw))
        self.device_calls += 1

        # splice the replanned shards into the persistent host plan +
        # refresh the host weight cache for rescored slots
        for b, s in enumerate(ds):
            self.planned_w[s] = d_w[b]
            self.to_add[s] = add[b]
            self.to_remove[s] = rm[b]
            self.to_reweight[s] = rw[b]
            resc = rescored[b]
            if resc.any():
                f.cached_w[s][resc] = d_w[b][resc]
        f.mark_scored([(s, gi) for s, gi in positions
                       if rescored[batch_of[s], gi]])

        live = int((f.desired[ds] != EMPTY).sum())
        stats = {"adds": float(add[:Db].sum()),
                 "removes": float(rm[:Db].sum()),
                 "reweights": float(rw[:Db].sum()),
                 "live_endpoints": float(live),
                 "rescored_groups": float(rescored[:Db].sum())}
        return WaveResult(
            device=str(dev), dirty_shards=Db, dirty_groups=K,
            device_call=True,
            intents=self._decode_positions(positions), stats=stats)

    # -- decode / flush edges ------------------------------------------

    def _decode_positions(self, positions) -> List[GroupIntent]:
        out: List[GroupIntent] = []
        for s, gi in positions:
            slot = self.fleet.slot(s, gi)
            if slot is None:          # removed this wave: no intent
                continue
            out.append(self._decode_one(slot, s, gi))
        return out

    def _decode_one(self, slot, s: int, gi: int) -> GroupIntent:
        f = self.fleet
        sof = f.arns.string_of
        desired = [sof(int(i)) for i in f.desired[s, gi][:slot.nd]]
        observed = [sof(int(i)) for i in f.observed[s, gi][:slot.no]]
        return decode_group_intent(
            slot.key, slot.group_arn, desired, observed,
            slot.mode != MODE_NONE, slot.client_ip_preservation,
            self.planned_w[s, gi], self.to_add[s, gi],
            self.to_remove[s, gi], self.to_reweight[s, gi])

    def intents_for(self, keys: Sequence[str]) -> List[GroupIntent]:
        """Decode the RESIDENT plan for given keys."""
        out: List[GroupIntent] = []
        for k in keys:
            loc = self.fleet.location(k)
            if loc is None:
                continue
            slot = self.fleet.slot(*loc)
            if slot is not None:
                out.append(self._decode_one(slot, *loc))
        return out

    def flush_complete(self) -> None:
        """The previous wave's intents were flushed: release the retired
        device buffer (the ring's hand-off rule)."""
        self.ring.release_retired()

    # -- the oracle edge -------------------------------------------------

    def verify_full_repack(self) -> Dict[str, object]:
        """Repack the resident truth from scratch and replan it with the
        :class:`WholeFleetPlanner` ORACLE on the same device; demand
        bit-equality against the resident plan, position by position.
        Call with the dirty masks drained."""
        f = self.fleet
        oracle = WholeFleetPlanner(model=self.model, params=self.params,
                                   device=self.device)
        res = oracle.plan_groups(f.snapshot_groups(),
                                 endpoints_cap=f.endpoints_cap,
                                 shards=f.shards)
        mismatches = 0
        first: Optional[str] = None
        pairs = zip(f.occupied_positions(), res.fleet.locations,
                    res.fleet.groups)
        for (s, gi), (s2, gp), g in pairs:
            ok = (s == s2
                  and np.array_equal(self.planned_w[s, gi],
                                     res.desired_w[s2, gp])
                  and np.array_equal(self.to_add[s, gi],
                                     res.to_add[s2, gp])
                  and np.array_equal(self.to_remove[s, gi],
                                     res.to_remove[s2, gp])
                  and np.array_equal(self.to_reweight[s, gi],
                                     res.to_reweight[s2, gp]))
            if not ok:
                mismatches += 1
                if first is None:
                    first = g.key
        return {"match": mismatches == 0, "groups": len(res.fleet.groups),
                "mismatches": mismatches, "first_mismatch": first,
                "oracle_device": res.device}
