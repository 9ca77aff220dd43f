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
    WholeFleetPlanner as JaxWholeFleetPlanner,
)
from aws_global_accelerator_controller_tpu.reconcile import (
    columnar as jcol,
)
from aws_global_accelerator_controller_tpu_torch import parity
from aws_global_accelerator_controller_tpu_torch.models.convert import (
    params_from_jax,
)
from aws_global_accelerator_controller_tpu_torch.parallel.distributed \
    import World
from aws_global_accelerator_controller_tpu_torch.parallel.fleet import (
    make_row_splice,
    row_splice,
)
from aws_global_accelerator_controller_tpu_torch.parallel.fleet_plan import (
    STAT_ADDS,
    STAT_REMOVES,
    WholeFleetPlanner,
    make_fleet_pass,
)
from aws_global_accelerator_controller_tpu_torch.parallel.mesh import (
    make_mesh,
)
from aws_global_accelerator_controller_tpu_torch.reconcile import (
    columnar as tcol,
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
            got = splice(t, ks, kg, torch.from_numpy(src))
            assert got is t                       # in place
            assert np.array_equal(t.numpy(), want)


def test_row_splice_checks_bounds_and_shapes():
    splice = make_row_splice(torch.device("cpu"))
    grid = torch.zeros((2, 3, 4), dtype=torch.int32)
    rows = torch.ones((1, 4), dtype=torch.int32)
    for ks, kg in (([2], [0]), ([0], [3]), ([-1], [0])):
        with pytest.raises(IndexError):
            splice(grid, np.array(ks), np.array(kg), rows)
    for lin in ([6], [-1], [0, 6]):
        with pytest.raises(IndexError):
            row_splice(grid.view(6, 4), torch.tensor(lin, dtype=torch.int32),
                       rows.expand(len(lin), 4))
    assert not grid.any()
    with pytest.raises(ValueError):
        row_splice(grid.view(6, 4), torch.zeros(2, dtype=torch.int32),
                   rows)
