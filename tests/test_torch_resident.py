"""The port's incremental resident planner: bit-exact against its own
full repack, and within tolerance of the JAX package's incremental
planner, over seeded mutation streams (the fuzzer family of
``tests/test_resident_planner.py``), on the CPU.

Against itself the port is exact: after every wave the resident plan
equals a from-scratch repack planned by the port's
``WholeFleetPlanner``, decoded intents included, and a wave with no
dirt makes no device call.  Against the JAX package (reference rung,
same params via ``params_from_jax``) memberships are exact and weights
+-1 on at most 0.5% of cells.
"""
import numpy as np
import pytest
import torch

from aws_global_accelerator_controller_tpu.compat import registry
from aws_global_accelerator_controller_tpu.parallel.fleet_plan import (
    ResidentFleetPlanner as JaxResidentFleetPlanner,
)
from aws_global_accelerator_controller_tpu.reconcile import (
    columnar as jcol,
)
from aws_global_accelerator_controller_tpu.reconcile.resident import (
    ResidentFleet as JaxResidentFleet,
)
from aws_global_accelerator_controller_tpu_torch import parity
from aws_global_accelerator_controller_tpu_torch.kernels import build
from aws_global_accelerator_controller_tpu_torch.models.convert import (
    params_from_jax,
)
from aws_global_accelerator_controller_tpu_torch.parallel.fleet import (
    DeviceGridRing,
)
from aws_global_accelerator_controller_tpu_torch.parallel.fleet_plan import (
    ResidentFleetPlanner,
    WholeFleetPlanner,
)
from aws_global_accelerator_controller_tpu_torch.reconcile import (
    columnar as tcol,
)
from aws_global_accelerator_controller_tpu_torch.reconcile.resident import (
    UPSERT_UNCHANGED,
    ResidentFleet,
)

CAP = 6
F = 8
SHARDS = 4


def arn(i):
    return f"arn:aws:elasticloadbalancing:us-east-1:1:lb/net/lb{i}/x"


def group_spec(rng, i, pool_base=0, shard=None):
    """Keyword arguments of one random GroupState (the generator of
    tests/test_resident_planner.py); ``pool_base`` shifts the ARN pool so
    later waves grow the interning table."""
    nd = int(rng.integers(0, CAP + 1))
    no = int(rng.integers(0, CAP + 1))
    pool = [arn(pool_base + i * 100 + j) for j in range(CAP * 2)]
    desired = list(rng.choice(pool, size=nd, replace=False))
    observed = list(rng.choice(pool, size=no, replace=False))
    observed_w = [int(w) if rng.random() > 0.2 else None
                  for w in rng.integers(0, 256, no)]
    mode = int(rng.integers(0, 3))
    features = (rng.standard_normal((nd, F)).astype(np.float32)
                if mode == tcol.MODE_MODEL else None)
    return dict(
        key=f"default/b{i}", group_arn=f"eg-{i}", desired=desired,
        observed=observed, observed_weights=observed_w, features=features,
        spec_weight=(int(rng.integers(0, 256))
                     if mode == tcol.MODE_SPEC else None),
        model_planned=(mode == tcol.MODE_MODEL),
        client_ip_preservation=bool(rng.integers(0, 2)),
        fingerprint=int(rng.integers(1, 2 ** 40)),
        shard=(int(rng.integers(0, SHARDS)) if shard is None else shard))


def mutation_stream(seed, waves=5):
    """Lists of ("upsert", spec) / ("remove", key) / ("touch", key),
    one list per wave, the first inserting 20 groups."""
    rng = np.random.default_rng(seed)
    live = {}
    first = []
    for i in range(20):
        live[i] = group_spec(rng, i)
        first.append(("upsert", live[i]))
    out = [first]
    for wave in range(waves):
        pool_base = (wave + 1) * 10_000
        ops = []
        for _ in range(4):
            roll = rng.random()
            if roll < 0.25 and live:
                k = int(rng.choice(list(live)))
                ops.append(("remove", f"default/b{k}"))
                del live[k]
            elif roll < 0.5 and live:
                k = int(rng.choice(list(live)))
                live[k] = group_spec(rng, k, pool_base=pool_base,
                                     shard=(live[k]["shard"] + 1) % SHARDS)
                ops.append(("upsert", live[k]))
            elif roll < 0.75:
                k = int(rng.integers(1000, 2000))
                live[k] = group_spec(rng, k, pool_base=pool_base)
                ops.append(("upsert", live[k]))
            elif live:
                k = int(rng.choice(list(live)))
                ops.append(("touch", f"default/b{k}"))
        out.append(ops)
    return out


def apply(fleet, make_state, ops):
    for kind, arg in ops:
        if kind == "upsert":
            fleet.upsert(make_state(**arg))
        elif kind == "remove":
            fleet.remove(arg)
        else:
            fleet.note_dirty(arg)


def make_port(seed=0, groups_per_shard=4, params=None):
    fleet = ResidentFleet(shards=SHARDS, endpoints_cap=CAP, feature_dim=F,
                          groups_per_shard=groups_per_shard)
    return fleet, ResidentFleetPlanner(fleet, params=params, seed=seed,
                                       device="cpu")


def op_triples(intent):
    return [(op.kind, op.endpoint_id, op.weight) for op in intent.ops]


def assert_matches_own_full_repack(planner):
    v = planner.verify_full_repack()
    assert v["match"], v
    fleet = planner.fleet
    keys = [fleet.slot(s, gi).key for s, gi in fleet.occupied_positions()]
    oracle = WholeFleetPlanner(model=planner.model, params=planner.params,
                               device="cpu")
    res = oracle.plan_groups(fleet.snapshot_groups(),
                             endpoints_cap=fleet.endpoints_cap,
                             shards=fleet.shards)
    want = {i.key: i for i in res.intents()}
    got = {i.key: i for i in planner.intents_for(keys)}
    assert set(got) == set(want)
    for k in want:
        assert op_triples(got[k]) == op_triples(want[k]), k
        assert got[k].weights == want[k].weights, k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_incremental_matches_own_full_repack(seed):
    fleet, planner = make_port(seed=seed)
    for ops in mutation_stream(seed):
        apply(fleet, tcol.GroupState, ops)
        planner.plan_wave()
        assert_matches_own_full_repack(planner)


def test_incremental_matches_jax_incremental(record_property):
    """One stream through both packages' resident planners."""
    registry.reset()
    registry.disable("pallas_tpu", "pallas_interpret")
    try:
        jfleet = JaxResidentFleet(shards=SHARDS, endpoints_cap=CAP,
                                  feature_dim=F, groups_per_shard=4)
        jplanner = JaxResidentFleetPlanner(jfleet, seed=0)
        params = params_from_jax(
            {k: np.asarray(v) for k, v in jplanner.params.items()},
            device="cpu")
        fleet, planner = make_port(params=params)
        got_w, want_w = [], []
        for ops in mutation_stream(4, waves=3):
            apply(jfleet, jcol.GroupState, ops)
            apply(fleet, tcol.GroupState, ops)
            jw, tw = jplanner.plan_wave(), planner.plan_wave()
            assert (tw.dirty_shards, tw.dirty_groups) == (jw.dirty_shards,
                                                          jw.dirty_groups)
            assert np.array_equal(planner.to_add, jplanner.to_add)
            assert np.array_equal(planner.to_remove, jplanner.to_remove)
            differ = planner.planned_w != jplanner.planned_w
            assert not (planner.to_reweight
                        != jplanner.to_reweight)[~differ].any()
            got_w.append(planner.planned_w.ravel())
            want_w.append(jplanner.planned_w.ravel())
        err, frac = parity.weight_mismatch(np.concatenate(got_w),
                                           np.concatenate(want_w))
        record_property("mismatch_frac", frac)
        assert err <= parity.MAX_WEIGHT_DIFF
        assert frac <= parity.MAX_MISMATCH_FRAC
    finally:
        registry.reset()


def test_zero_dirty_wave_never_touches_the_device():
    rng = np.random.default_rng(7)
    fleet, planner = make_port(seed=7)
    for i in range(12):
        fleet.upsert(tcol.GroupState(**group_spec(rng, i)))
    w1 = planner.plan_wave()
    assert w1.device_call and planner.device_calls == 1
    before = build.launch_counts()
    w2 = planner.plan_wave()
    assert not w2.device_call
    assert (w2.dirty_shards, w2.dirty_groups, w2.intents) == (0, 0, [])
    assert planner.device_calls == 1
    assert build.launch_counts() == before
    assert_matches_own_full_repack(planner)


def test_unchanged_upsert_stays_clean():
    rng = np.random.default_rng(3)
    fleet, planner = make_port(seed=3)
    g = tcol.GroupState(**group_spec(rng, 0))
    fleet.upsert(g)
    planner.plan_wave()
    assert fleet.upsert(g) == UPSERT_UNCHANGED
    assert fleet.dirty_group_count() == 0
    assert not planner.plan_wave().device_call


def test_capacity_growth_reuploads_and_bitmatches():
    rng = np.random.default_rng(11)
    fleet, planner = make_port(seed=11, groups_per_shard=2)
    for i in range(4):
        fleet.upsert(tcol.GroupState(**group_spec(rng, i, shard=i)))
    planner.plan_wave()
    front = planner.ring.front
    gen0 = fleet.generation
    for i in range(10, 22):                   # overflow shard 0
        fleet.upsert(tcol.GroupState(**group_spec(rng, i, shard=0)))
    assert fleet.generation > gen0
    planner.plan_wave()
    assert planner.ring.front[0].shape[1] == fleet.cap
    assert planner.ring.front[0] is not front[0]
    assert_matches_own_full_repack(planner)


def test_waves_splice_the_resident_grids_in_place():
    rng = np.random.default_rng(12)
    fleet, planner = make_port(seed=12)
    for i in range(10):
        fleet.upsert(tcol.GroupState(**group_spec(rng, i)))
    planner.plan_wave()
    front = planner.ring.front
    ptrs = [t.data_ptr() for t in front]
    for i in range(10, 14):
        fleet.upsert(tcol.GroupState(**group_spec(rng, i)))
    planner.plan_wave()
    assert [t.data_ptr() for t in planner.ring.front] == ptrs
    for host, dev in zip((fleet.desired, fleet.observed, fleet.observed_w,
                          fleet.cached_w, fleet.weight_mode, fleet.spec_w),
                         planner.ring.front):
        assert np.array_equal(dev.numpy(), host)
    assert_matches_own_full_repack(planner)


def test_max_groups_evicts_the_least_recently_upserted():
    rng = np.random.default_rng(9)
    fleet = ResidentFleet(shards=SHARDS, endpoints_cap=CAP, feature_dim=F,
                          groups_per_shard=4, max_groups=5)
    planner = ResidentFleetPlanner(fleet, seed=9, device="cpu")
    for i in range(8):
        fleet.upsert(tcol.GroupState(**group_spec(rng, i)))
    assert [fleet.location(f"default/b{i}") is not None
            for i in range(8)] == [False] * 3 + [True] * 5
    planner.plan_wave()
    assert_matches_own_full_repack(planner)


def test_device_grid_ring_handoff():
    ring = DeviceGridRing(torch.device("cpu"))
    assert ring.front is None
    a = ring.reset((np.arange(4, dtype=np.int32),))
    assert torch.equal(a[0], torch.arange(4, dtype=torch.int32))
    b = (torch.zeros(4, dtype=torch.int32),)
    ring.advance(b)
    assert ring.front == b and ring._retired == a
    ring.release_retired()
    assert ring._retired is None and ring.front == b
    ring.drop()
    assert ring.front is None
