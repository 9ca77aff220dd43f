"""The port's whole-fleet planner and row splice against the JAX
package's, on the CPU.

The fleets are the seeded random fleets of ``tests/test_fleet_plan.py``
(ragged groups, empty groups and shards, every weight mode), made once
and packed by both packages.  The JAX planner runs on its reference rung
(the oracle), the port's with ``device="cpu"`` and the same params
carried by ``params_from_jax``.  Memberships and splices are exact;
weights +-1 on at most 0.5% of cells (pooled over the fleets, recorded);
``to_reweight`` may differ only where the weights do.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_global_accelerator_controller_tpu.compat import (
    RUNG_REFERENCE,
    registry,
)
from aws_global_accelerator_controller_tpu.parallel.fleet import (
    make_row_splice as jax_make_row_splice,
)
from aws_global_accelerator_controller_tpu.parallel.fleet_plan import (
    ResidentFleetPlanner as JaxResidentFleetPlanner,
)
from aws_global_accelerator_controller_tpu.parallel.fleet_plan import (
    WholeFleetPlanner as JaxWholeFleetPlanner,
)
from aws_global_accelerator_controller_tpu.reconcile import (
    columnar as jcol,
)
from aws_global_accelerator_controller_tpu.reconcile.resident import (
    ResidentFleet as JaxResidentFleet,
)
from aws_global_accelerator_controller_tpu_torch import parity
from aws_global_accelerator_controller_tpu_torch.models.convert import (
    params_from_jax,
)
from aws_global_accelerator_controller_tpu_torch.parallel.distributed \
    import World
from aws_global_accelerator_controller_tpu_torch.parallel.fleet import (
    _splice_grids,
    make_row_splice,
    pack_splice,
    row_splice,
)
from aws_global_accelerator_controller_tpu_torch.parallel.fleet_plan import (
    STAT_ADDS,
    STAT_REMOVES,
    ResidentFleetPlanner,
    WholeFleetPlanner,
    make_fleet_pass,
)
from aws_global_accelerator_controller_tpu_torch.parallel.mesh import (
    make_mesh,
)
from aws_global_accelerator_controller_tpu_torch.reconcile import (
    columnar as tcol,
)
from aws_global_accelerator_controller_tpu_torch.reconcile.resident import (
    ResidentFleet,
)

CAP = 8
F = 8


def arn(i):
    return (f"arn:aws:elasticloadbalancing:us-east-1:1:loadbalancer/"
            f"net/lb{i}/x")


@pytest.fixture
def reference_rung():
    """The JAX planner's oracle rung (jnp reference, flat layout)."""
    registry.reset()
    registry.disable("pallas_tpu", "pallas_interpret")
    yield
    registry.reset()


@pytest.fixture(scope="module")
def planners():
    jax_planner = JaxWholeFleetPlanner()
    params = params_from_jax(
        {k: np.asarray(v) for k, v in jax_planner.params.items()},
        device="cpu")
    return jax_planner, WholeFleetPlanner(params=params, device="cpu")


def group_spec(rng, i, shards):
    """One random group (the generator of tests/test_fleet_plan.py) as
    keyword arguments, so each package builds its own GroupState."""
    nd = int(rng.integers(0, CAP + 1))
    no = int(rng.integers(0, CAP + 1))
    pool = [arn(i * 100 + j) for j in range(CAP * 2)]
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
        fingerprint=i, shard=int(rng.integers(0, shards)))


def op_sets(intent):
    return {kind: {o.endpoint_id for o in intent.ops if o.kind == kind}
            for kind in ("set", "remove")}


def test_whole_fleet_matches_jax_reference_rung(planners, reference_rung,
                                                record_property):
    jax_planner, planner = planners
    got_w, want_w = [], []
    for seed in range(20):
        rng = np.random.default_rng(seed)
        shards = int(rng.integers(1, 4))
        specs = [group_spec(rng, i, shards)
                 for i in range(int(rng.integers(0, 25)))]
        jres = jax_planner.plan_groups(
            [jcol.GroupState(**s) for s in specs], endpoints_cap=CAP,
            shards=shards)
        tres = planner.plan_groups(
            [tcol.GroupState(**s) for s in specs], endpoints_cap=CAP,
            shards=shards)
        assert tres.layout == "flat" and tres.device == "cpu"
        assert np.array_equal(tres.to_add, jres.to_add), seed
        assert np.array_equal(tres.to_remove, jres.to_remove), seed
        differ = tres.desired_w != jres.desired_w
        assert not (np.asarray(tres.to_reweight)
                    != np.asarray(jres.to_reweight))[~differ].any(), seed
        for k in ("adds", "removes", "live_endpoints", "rescored_groups",
                  "groups"):
            assert tres.stats[k] == jres.stats[k], (seed, k)
        for ti, ji in zip(tres.intents(), jres.intents()):
            assert ti.key == ji.key and op_sets(ti) == op_sets(ji)
        got_w.append(tres.desired_w.ravel())
        want_w.append(np.asarray(jres.desired_w).ravel())
    err, frac = parity.weight_mismatch(np.concatenate(got_w),
                                       np.concatenate(want_w))
    record_property("mismatch_frac", frac)
    assert err <= parity.MAX_WEIGHT_DIFF
    assert frac <= parity.MAX_MISMATCH_FRAC


def test_pad_rows_are_dropped():
    """Rows whose seg is out of bounds (pack_fleet's pads) never reach
    the grid, whatever they score."""
    planner = WholeFleetPlanner(seed=1, device="cpu")
    rng = np.random.default_rng(3)
    G, E, N = 6, 4, 10
    desired = torch.from_numpy(
        rng.integers(0, 50, (G, E)).astype(np.int32))
    rows = torch.from_numpy(rng.standard_normal((N, F)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, G, N).astype(np.int32))
    slot = torch.arange(N, dtype=torch.int32) % E
    observed = desired.clone()
    observed_w = torch.full((G, E), 7, dtype=torch.int32)
    cached = torch.zeros((G, E), dtype=torch.int32)
    rescored = torch.ones(G, dtype=torch.bool)
    mode = torch.zeros(G, dtype=torch.int32)
    spec_w = torch.full((G,), -1, dtype=torch.int32)
    fn = make_fleet_pass(planner.model)
    base = fn(planner.params, rows, seg, slot, desired, observed,
              observed_w, cached, rescored, mode, spec_w)
    pads = torch.from_numpy(rng.standard_normal((5, F)).astype(np.float32))
    padded = fn(planner.params, torch.cat([rows, pads * 100]),
                torch.cat([seg, torch.full((5,), G, dtype=torch.int32)]),
                torch.cat([slot, torch.zeros(5, dtype=torch.int32)]),
                desired, observed, observed_w, cached, rescored, mode,
                spec_w)
    for a, b in zip(base, padded):
        assert torch.equal(a, b)
    assert base[4][STAT_ADDS] == 0 and base[4][STAT_REMOVES] == 0
    # a mesh of one rank (data 1 x model 1): the sharded pass is the flat
    one = make_mesh(World(0, 1, torch.device("cpu"), None),
                    ("data", "model"), shape={"data": 1, "model": 1})
    sharded = make_fleet_pass(planner.model, mesh=one)(
        planner.params, rows, seg, slot, desired, observed, observed_w,
        cached, rescored, mode, spec_w)
    for a, b in zip(base, sharded):
        assert torch.equal(a, b)


def splice_case(seed, S=5, cap=7, E=4, K=6):
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 1000, (S, cap, E)).astype(np.int32)
    plane = rng.integers(0, 1000, (S, cap)).astype(np.int32)
    flat = rng.choice(S * cap, size=K, replace=False)
    ks = (flat // cap).astype(np.int32)
    kg = (flat % cap).astype(np.int32)
    rows = rng.integers(0, 1000, (K, E)).astype(np.int32)
    vals = rng.integers(0, 1000, K).astype(np.int32)
    # pad rows re-write row 0's position with row 0's value
    pad = 3
    ks = np.concatenate([ks, np.repeat(ks[:1], pad)])
    kg = np.concatenate([kg, np.repeat(kg[:1], pad)])
    rows = np.concatenate([rows, np.repeat(rows[:1], pad, axis=0)])
    vals = np.concatenate([vals, np.repeat(vals[:1], pad)])
    return grid, plane, ks, kg, rows, vals


def test_row_splice_matches_jax_scatter():
    jsplice = jax_make_row_splice(RUNG_REFERENCE)
    splice = make_row_splice(torch.device("cpu"))
    for seed in range(4):
        grid, plane, ks, kg, rows, vals = splice_case(seed)
        for dst, src in ((grid, rows), (plane, vals)):
            want = np.asarray(jsplice(jnp.asarray(dst), jnp.asarray(ks),
                                      jnp.asarray(kg), jnp.asarray(src)))
            t = torch.from_numpy(dst.copy())
            ptr = t.data_ptr()
            got = splice((t,), ks, kg, (src,))
            assert got[0] is t and t.data_ptr() == ptr     # in place
            assert np.array_equal(t.numpy(), want)


def test_row_splice_checks_bounds_and_shapes():
    splice = make_row_splice(torch.device("cpu"))
    grid = torch.zeros((2, 3, 4), dtype=torch.int32)
    rows = torch.ones((1, 4), dtype=torch.int32)
    for ks, kg in (([2], [0]), ([0], [3]), ([-1], [0])):
        with pytest.raises(IndexError):
            splice((grid,), np.array(ks), np.array(kg), (rows.numpy(),))
    for lin in ([6], [-1], [0, 6]):
        with pytest.raises(IndexError):
            row_splice(grid.view(6, 4), torch.tensor(lin, dtype=torch.int32),
                       rows.expand(len(lin), 4))
    assert not grid.any()
    with pytest.raises(ValueError):
        row_splice(grid.view(6, 4), torch.zeros(2, dtype=torch.int32),
                   rows)


#: a wave's grids in the batched splice: endpoint grids of widths 16, 8,
#: 4, 3 and 1, and one per-group plane
WAVE_SHAPES = ((16,), (8,), (4,), (3,), (1,), ())


def wave_case(seed, S=5, cap=7, K=9, dup=2, pad=4):
    """Six grids, K real rows (the last ``dup`` repeating the first ``dup``
    at the same positions, with equal rows) and ``pad`` pad rows past K
    that repeat row 0, as the planner's power-of-two bucket did."""
    rng = np.random.default_rng(seed)
    grids = [rng.integers(0, 1000, (S, cap, *w)).astype(np.int32)
             for w in WAVE_SHAPES]
    flat = rng.choice(S * cap, size=K - dup, replace=False)
    flat = np.concatenate([flat, flat[:dup], np.repeat(flat[:1], pad)])
    blocks = []
    for w in WAVE_SHAPES:
        b = rng.integers(0, 1000, (K + pad, *w)).astype(np.int32)
        b[K - dup:K] = b[:dup]
        b[K:] = b[0]
        blocks.append(b)
    return grids, flat // cap, flat % cap, blocks, K


@pytest.mark.parametrize("seed", range(4))
def test_batched_splice_of_six_grids_matches_jax_scatter(seed):
    """One call splices the K real rows into all six grids; the JAX
    package's scatter of every row, pads included, gives the same grids."""
    jsplice = jax_make_row_splice(RUNG_REFERENCE)
    splice = make_row_splice(torch.device("cpu"))
    grids, ks, kg, blocks, K = wave_case(seed)
    dsts = tuple(torch.from_numpy(g.copy()) for g in grids)
    assert splice(dsts, ks[:K], kg[:K], [b[:K] for b in blocks]) is dsts
    for g, d, b in zip(grids, dsts, blocks):
        want = jsplice(jnp.asarray(g), jnp.asarray(ks), jnp.asarray(kg),
                       jnp.asarray(b))
        assert np.array_equal(d.numpy(), np.asarray(want))


@pytest.mark.parametrize("at", ["first", "middle", "last"])
@pytest.mark.parametrize("axis,value", [("ks", 5), ("ks", -1), ("kg", 7),
                                        ("kg", -1)])
def test_batched_splice_refuses_positions_outside_the_grid(at, axis, value):
    """A shard or slot out of its own axis anywhere in the wave raises
    before any grid is written (a kg of cap would still land inside the
    flat grid, in the next shard's first slot)."""
    splice = make_row_splice(torch.device("cpu"))
    grids, ks, kg, blocks, K = wave_case(11)
    ks, kg = ks[:K].copy(), kg[:K].copy()
    (ks if axis == "ks" else kg)[{"first": 0, "middle": K // 2,
                                  "last": K - 1}[at]] = value
    dsts = tuple(torch.from_numpy(g.copy()) for g in grids)
    with pytest.raises(IndexError):
        splice(dsts, ks, kg, [b[:K] for b in blocks])
    for g, d in zip(grids, dsts):
        assert np.array_equal(d.numpy(), g)


def test_pack_splice_is_one_buffer_of_aligned_segments():
    """lin and the six row blocks are views of one int32 buffer, each
    starting on a 16-byte boundary of it, holding the real rows only."""
    grids, ks, kg, blocks, K = wave_case(5)
    lin, rows = pack_splice((5, 7), ks[:K], kg[:K], [b[:K] for b in blocks],
                            torch.device("cpu"))
    base = lin.untyped_storage().data_ptr()
    assert lin.dtype == torch.int32 and lin.tolist() == list(
        ks[:K] * 7 + kg[:K])
    for r, b in zip(rows, blocks):
        assert r.untyped_storage().data_ptr() == base
        assert r.storage_offset() % 4 == 0 and r.is_contiguous()
        assert np.array_equal(r.numpy(), b[:K].reshape(K, -1))
    with pytest.raises(ValueError):
        pack_splice((5, 7), ks[:K], kg[:K], [blocks[0][:K - 1]],
                    torch.device("cpu"))


@pytest.mark.parametrize("dtype", [np.int64, np.float32, np.uint32])
def test_pack_splice_refuses_blocks_that_are_not_int32(dtype):
    """A block of another dtype raises before the copy, as the one-grid
    splice refuses rows that are not int32: nothing is cast, so an int64
    past int32 cannot wrap and a float cannot be truncated."""
    grids, ks, kg, blocks, K = wave_case(7)
    bad = [b[:K] for b in blocks]
    bad[-1] = bad[-1].astype(dtype) + (1 << 31 if dtype == np.int64 else 0)
    with pytest.raises(ValueError, match="int32"):
        pack_splice((5, 7), ks[:K], kg[:K], bad, torch.device("cpu"))
    dsts = tuple(torch.from_numpy(g.copy()) for g in grids)
    with pytest.raises(ValueError, match="int32"):
        make_row_splice(torch.device("cpu"))(dsts, ks[:K], kg[:K], bad)
    for g, d in zip(grids, dsts):
        assert np.array_equal(d.numpy(), g)


def test_splice_grids_checks_its_table():
    grid = torch.zeros((6, 4), dtype=torch.int32)
    lin = torch.tensor([1, 4], dtype=torch.int32)
    rows = torch.ones((2, 4), dtype=torch.int32)
    _splice_grids([grid], lin, [rows])
    assert grid[[1, 4]].eq(1).all() and grid.sum() == 8
    for dsts, blocks in (([], []), ([grid], []), ([grid] * 9, [rows] * 9),
                         ([grid], [rows[:1]]), ([grid], [rows[:, :3]])):
        with pytest.raises(ValueError):
            _splice_grids(dsts, lin, blocks)


@pytest.mark.parametrize("churn", [1, 7, 9, 33])
def test_resident_waves_on_cpu_match_whole_fleet_planner(planners, churn):
    """After a wave of ``churn`` changed groups (a count that is not a
    power of two but 1, so the splice takes real rows only), the resident
    plan is the whole-fleet planner's plan of the same groups, position by
    position, weights and masks alike.  A changed group keeps its weight
    mode and desired endpoints (the sweep's churn: drift, weights,
    features, a shard move); a group that leaves the model mode keeps a
    stale cache in both packages (ROADMAP.md, C5)."""
    _, oracle = planners
    rng = np.random.default_rng(churn)
    fleet = ResidentFleet(shards=3, endpoints_cap=CAP, feature_dim=F,
                          groups_per_shard=16)
    planner = ResidentFleetPlanner(fleet, params=oracle.params,
                                   device="cpu")
    specs = [group_spec(rng, i, 3) for i in range(40)]
    for spec in specs:
        fleet.upsert(tcol.GroupState(**spec))
    planner.plan_wave()
    for i in rng.choice(40, churn, replace=False):
        other = group_spec(rng, int(i), 3)
        spec = dict(specs[i], fingerprint=1000 + int(i),
                    shard=other["shard"], observed=other["observed"],
                    observed_weights=other["observed_weights"])
        if spec["features"] is not None:
            spec["features"] = rng.standard_normal(
                spec["features"].shape).astype(np.float32)
        fleet.upsert(tcol.GroupState(**spec))
    wave = planner.plan_wave()
    assert wave.device_call and wave.dirty_groups >= churn
    want = oracle.plan_groups(fleet.snapshot_groups(), endpoints_cap=CAP,
                              shards=3)
    positions = fleet.occupied_positions()
    assert len(positions) == len(want.fleet.locations) == 40
    for (s, gi), (s2, gp) in zip(positions, want.fleet.locations):
        assert s == s2
        for got, ref in ((planner.planned_w, want.desired_w),
                         (planner.to_add, want.to_add),
                         (planner.to_remove, want.to_remove),
                         (planner.to_reweight, want.to_reweight)):
            assert np.array_equal(got[s, gi], ref[s2, gp]), (s, gi)


def test_a_group_leaving_the_model_mode_keeps_its_cache_as_in_the_reference(
        reference_rung):
    """ROADMAP.md, C5, in both packages: a model-planned group upserted
    with no target keeps its cached weights in the resident plan, where
    the full repack plans zeros.  The port keeps the reference's
    behaviour; this test fails once either package changes it."""
    got = {}
    for name, fleet_cls, planner_cls, state, kw in (
            ("torch", ResidentFleet, ResidentFleetPlanner, tcol.GroupState,
             {"device": "cpu"}),
            ("jax", JaxResidentFleet, JaxResidentFleetPlanner,
             jcol.GroupState, {})):
        fleet = fleet_cls(shards=1, endpoints_cap=2, feature_dim=F,
                          groups_per_shard=1)
        planner = planner_cls(fleet, seed=0, **kw)
        ids = [arn(0), arn(1)]
        for version, model in ((1, True), (2, False)):
            fleet.upsert(state(
                key="default/b0", group_arn="eg-0", desired=ids,
                observed=ids, observed_weights=[1, 2],
                features=np.ones((2, F), np.float32) if model else None,
                model_planned=model, fingerprint=version))
            planner.plan_wave()
        verdict = planner.verify_full_repack()
        assert verdict["match"] is False and verdict["mismatches"] == 1
        got[name] = planner.planned_w[0, 0].tolist()
    assert got["torch"] == got["jax"] and sum(got["torch"]) > 0
