"""The port's sharded whole-fleet layout and its stats ring against the
JAX package's, on gloo CPU ranks.

The ranks are processes of ``tests/torch_ranks.py`` (suite ``fleet``),
started once for the module on 4 ranks; they import no JAX.  The JAX
side runs here, on the conftest's 8 host devices: its
``WholeFleetPlanner`` lays a fleet of several shards over a
``("data", "model")`` mesh on the pallas-interpret rung (shard_map, the
stats summed by ``psum``), and on the reference rung plans flat.

- The stats ring's plain version (kernel K5's) on data axes of 2, 3
  and 4 ranks: every rank's sum equals, bit for bit, a numpy f32 sum in
  the reference's hop order (own tile, then the left neighbour's, then
  the one beyond) of arbitrary tiles, and a ring one hop short fails
  that comparison.
- Kernel K5's exchange, emulated in numpy: each sender's block stored
  where ``send_targets`` points (the slot ``inbox_slot`` gives in every
  peer's inbox) and each inbox summed in slot order (``slot_senders``),
  as the card's send and sum do, equals the hop order bit for bit on 2,
  3 and 4 ranks, at both parities.
- The sharded pass on the fleets of ``tests/test_fleet_plan.py``:
  ``random_group`` fleets (10 seeds, shards 2 and 4), the fleet of
  ``test_sharded_layout_agrees_with_reference`` (shards 4, and its
  generator over 2 shards, which the 2 x 2 mesh plans too), groups
  pinned to shard 0 of 4, and the empty fleet over 2 shards.  On every
  rank, the arrays and the stats equal the JAX sharded layout's, the JAX
  flat layout's and the port's flat layout's exactly.
- A data 2 x model 2 mesh (``pmean`` over ``"model"``, then the ring):
  every rank's outputs equal the JAX ``make_fleet_pass`` on a 2 x 2 mesh
  of host devices, array for array and in the stats.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_global_accelerator_controller_tpu.compat import (
    RUNG_INTERPRET,
    registry,
)
from aws_global_accelerator_controller_tpu.parallel import (
    fleet_plan as jfleet_plan,
)
from aws_global_accelerator_controller_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh,
)
from aws_global_accelerator_controller_tpu.reconcile import (
    columnar as jcol,
)
from aws_global_accelerator_controller_tpu_torch.device import DeviceError
from aws_global_accelerator_controller_tpu_torch.models.convert import (
    params_from_jax,
)
from aws_global_accelerator_controller_tpu_torch.ops import cuda_ring
from aws_global_accelerator_controller_tpu_torch.parallel.distributed \
    import Group, World
from aws_global_accelerator_controller_tpu_torch.parallel.fleet_plan import (
    WholeFleetPlanner,
    _make_stats_ring,
)
from aws_global_accelerator_controller_tpu_torch.reconcile import (
    columnar as tcol,
)
from test_torch_fleet_plan import CAP, group_spec
from torch_ranks import run_world

WORLD = 4
RING_SIZES = (2, 3, 4)
FLEET_SEEDS = range(10)
PLANES = ("desired_w", "to_add", "to_remove", "to_reweight")


def _pinned_specs():
    """Groups pinned to shard 0 of 4 (``test_fleet_plan.py:172-195``)."""
    arn = ("arn:aws:elasticloadbalancing:us-east-1:1:loadbalancer/"
           "net/lb1/x")
    return [dict(key="default/a", group_arn="eg-a", desired=[],
                 observed=[], model_planned=False),
            dict(key="default/b", group_arn="eg-b", desired=[arn],
                 observed=[arn], observed_weights=[255], spec_weight=255,
                 model_planned=False)]


def _fleets():
    """name -> (shards, group specs)."""
    out = {}
    for seed in FLEET_SEEDS:
        for shards in (2, 4):
            rng = np.random.default_rng(seed)
            out[f"random_s{seed}_x{shards}"] = (shards, [
                group_spec(rng, i, shards)
                for i in range(int(rng.integers(1, 25)))])
    for shards in (2, 4):
        rng = np.random.default_rng(7)
        out[f"reference_x{shards}"] = (shards, [
            group_spec(rng, i, shards) for i in range(17)])
    out["pinned_x4"] = (4, _pinned_specs())
    out["empty_x2"] = (2, [])
    return out


FLEETS = _fleets()


def _for_ranks(specs):
    """Specs as the rank processes load them: plain strings, features as
    tensors."""
    return [{**s, "desired": [str(a) for a in s["desired"]],
             "observed": [str(a) for a in s["observed"]],
             "features": None if s.get("features") is None
             else torch.from_numpy(s["features"])} for s in specs]


def _jax(specs):
    return [jcol.GroupState(**s) for s in specs]


def _port(specs):
    return [tcol.GroupState(**s) for s in specs]


def _ring_tiles():
    """Arbitrary (8, 128) f32 tiles over a wide range of magnitudes, so
    that another order of the adds gives other bits."""
    rng = np.random.default_rng(11)
    return (rng.standard_normal((WORLD, 8, 128))
            * 10.0 ** rng.integers(-6, 7, (WORLD, 8, 128))).astype(
                np.float32)


@pytest.fixture(scope="module")
def jax_planner():
    return jfleet_plan.WholeFleetPlanner()


@pytest.fixture(scope="module")
def params(jax_planner):
    return params_from_jax({k: np.asarray(v)
                            for k, v in jax_planner.params.items()},
                           device="cpu")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, params):
    inputs = {
        "params": params,
        "ring": {"sizes": list(RING_SIZES),
                 "tiles": torch.from_numpy(_ring_tiles())},
        "fleets": [{"name": name, "shards": shards, "cap": CAP,
                    "specs": _for_ranks(specs)}
                   for name, (shards, specs) in FLEETS.items()],
        "mesh22": {"cap": CAP, "specs": _for_ranks(
            FLEETS["reference_x2"][1])},
    }
    return run_world("fleet", WORLD, inputs,
                     tmp_path_factory.mktemp("fleet_ranks"))


def _hop_order_sum(tiles, n, i):
    """Rank i's sum on a ring of n: own tile, then i - 1, i - 2, ...
    (mod n), each add an f32 add."""
    acc = tiles[i].copy()
    for h in range(1, n):
        acc = (acc + tiles[(i - h) % n]).astype(np.float32)
    return acc


@pytest.mark.parametrize("n", RING_SIZES)
def test_plain_ring_is_the_reference_hop_order(ranks, n):
    tiles = _ring_tiles()
    got = [r["ring"][n] for r in ranks if n in r["ring"]]
    assert len(got) == n
    for i, sum_i in enumerate(got):
        want = _hop_order_sum(tiles, n, i)
        assert sum_i.dtype == torch.float32
        assert np.array_equal(sum_i.numpy().view(np.int32),
                              want.view(np.int32)), (n, i)
    # past two ranks the order shows in the bits: the ranks' sums, each
    # in its own order, differ (f32 adds commute, so two ranks agree)
    assert n == 2 or any(not np.array_equal(got[0].numpy(), g.numpy())
                         for g in got[1:])


@pytest.mark.parametrize("n", RING_SIZES)
def test_a_ring_that_skips_a_hop_is_caught(ranks, n):
    tiles = _ring_tiles()
    for i, r in enumerate(r for r in ranks if n in r["ring_skip"]):
        want = _hop_order_sum(tiles, n, i)
        assert not np.array_equal(r["ring_skip"][n].numpy(), want), (n, i)


@pytest.mark.parametrize("n", RING_SIZES)
def test_inbox_slots_hold_each_sender_once(n):
    """Slot 0 of an inbox is its own rank's, slot d the sender's at ring
    distance d; ``slot_senders`` reads the slots back in that order."""
    for r in range(n):
        slots = [cuda_ring.inbox_slot(s, r, n) for s in range(n)]
        assert sorted(slots) == list(range(n)) and slots[r] == 0
        senders = cuda_ring.slot_senders(r, n)
        assert senders[0] == r and senders[1] == (r - 1) % n
        assert [cuda_ring.inbox_slot(s, r, n) for s in senders] == list(
            range(n))


def _exchange(blocks, parity):
    """Every rank's sum after K5's send and sum, emulated: inboxes as
    numpy arrays at made-up addresses, each sender's block stored where
    ``send_targets`` points, each inbox summed over slots 1 .. n - 1 of
    the parity after its own block, one f32 add a slot."""
    n, k = blocks.shape
    slot = cuda_ring.SLOT_FLOATS
    span = 1 << 20
    inboxes = np.zeros((n, cuda_ring.PARITIES * n * slot), np.float32)
    bases = [(j + 1) * span for j in range(n)]
    for s in range(n):
        for addr in cuda_ring.send_targets(bases, s, parity):
            j, off = divmod(addr, span)
            assert off % 4 == 0 and j - 1 != s
            inboxes[j - 1, off // 4:off // 4 + k] = blocks[s]
    sums = []
    for r in range(n):
        acc = blocks[r].copy()
        base = parity * n * slot
        for d in range(1, n):
            got = inboxes[r, base + d * slot:base + d * slot + k]
            assert np.array_equal(got, blocks[cuda_ring.slot_senders(r, n)[d]])
            acc = (acc + got).astype(np.float32)
        sums.append(acc)
    return sums


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("n", RING_SIZES)
def test_exchange_sums_in_the_reference_hop_order(n, parity):
    tiles = _ring_tiles()[:n]
    for row in range(tiles.shape[1]):
        blocks = tiles[:, row, :5]
        for i, got in enumerate(_exchange(blocks, parity)):
            want = _hop_order_sum(blocks, n, i)
            assert np.array_equal(got.view(np.int32), want.view(np.int32)), (
                n, parity, row, i)


def test_two_launches_a_pass_whatever_the_ranks():
    assert cuda_ring.launches_per_pass(1) == 0
    assert all(cuda_ring.launches_per_pass(n) == 2 for n in range(2, 33))


def _reference_plans(jax_planner, params, shards, specs):
    """(JAX sharded, JAX flat, port flat) plans of one fleet."""
    registry.reset()
    try:
        jsharded = jax_planner.plan_groups(_jax(specs), endpoints_cap=CAP,
                                           shards=shards)
        registry.disable("pallas_tpu", "pallas_interpret")
        jflat = jax_planner.plan_groups(_jax(specs), endpoints_cap=CAP,
                                        shards=shards)
    finally:
        registry.reset()
    tflat = WholeFleetPlanner(params=params, device="cpu").plan_groups(
        _port(specs), endpoints_cap=CAP, shards=shards)
    assert (jsharded.layout, jflat.layout, tflat.layout) == (
        "sharded", "flat", "flat")
    return {"jax sharded": jsharded, "jax flat": jflat, "port flat": tflat}


@pytest.mark.parametrize("name", sorted(FLEETS))
def test_sharded_pass_matches_every_reference(ranks, jax_planner, params,
                                              name):
    shards, specs = FLEETS[name]
    refs = _reference_plans(jax_planner, params, shards, specs)
    for r in ranks:
        got = r["fleets"][name]
        assert got["layout"] == "sharded", (name, r["rank"])
        for ref_name, ref in refs.items():
            for plane in PLANES:
                assert np.array_equal(got[plane].numpy(),
                                      np.asarray(getattr(ref, plane))), (
                    name, r["rank"], ref_name, plane)
            assert got["stats"] == ref.stats, (name, r["rank"], ref_name)


def test_data_by_model_mesh_matches_the_reference_pass(ranks, jax_planner):
    """The reference's pass on a 2 x 2 mesh of host devices (pmean over
    "model", psum over "data") against the port's on 4 ranks."""
    fleet = jcol.pack_fleet(_jax(FLEETS["reference_x2"][1]),
                            endpoints_cap=CAP, shards=2)
    mesh = jax_make_mesh(axis_shapes={"data": 2, "model": 2})
    fn = jfleet_plan.make_fleet_pass(jax_planner.model, RUNG_INTERPRET,
                                     mesh=mesh)
    desired, observed, observed_w, cached_w, mode, spec_w = \
        fleet.flat_grids()
    S, Gs, E = fleet.desired.shape
    out = fn(jax_planner.params,
             jnp.asarray(fleet.feat_rows.reshape(-1, fleet.feat_rows.shape[-1])),
             *(jnp.asarray(a) for a in (
                 fleet.row_seg.reshape(-1), fleet.row_slot.reshape(-1),
                 desired, observed, observed_w, cached_w,
                 fleet.rescored.reshape(-1), mode, spec_w)))
    *planes, stats = jax.device_get(out)
    want = [np.asarray(p).reshape(S, Gs, E) for p in planes]
    coords = set()
    for r in ranks:
        got = r["mesh22"]
        d = got["coords"]["data"]
        coords.add((d, got["coords"]["model"]))
        for plane, w in zip(PLANES, want):
            assert np.array_equal(got[plane].numpy(), w[d]), (r["rank"],
                                                              plane)
        assert np.array_equal(got["stats"].numpy(), np.asarray(stats))
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_a_mesh_past_the_world_plans_flat():
    """Shards beyond the world's ranks (here a world of one) take the flat
    layout, as the reference's ``_mesh_for`` does past its devices."""
    shards, specs = FLEETS["reference_x4"]
    planner = WholeFleetPlanner(seed=0, device="cpu")
    assert planner.world.size == 1
    assert planner.plan_groups(_port(specs), endpoints_cap=CAP,
                               shards=shards).layout == "flat"


def test_the_cuda_ring_raises_without_a_card(monkeypatch):
    """The ring's CUDA route needs the card: nothing runs on the CPU in
    its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    group = Group([0, 1], 0)
    with pytest.raises(DeviceError):
        _make_stats_ring(group, "cuda")
    world = World(0, 2, torch.device("cpu"), "gloo")
    with pytest.raises(DeviceError):
        WholeFleetPlanner(device="cuda", world=world)
    on_card = World(0, 2, torch.device("cuda", 0), "gloo")
    with pytest.raises(ValueError, match="world"):
        WholeFleetPlanner(device="cpu", world=on_card)


def test_a_ring_made_for_the_cpu_refuses_a_card_tensor():
    reduce = _make_stats_ring(Group([0, 1], 0), "cpu")
    with pytest.raises(ValueError, match="made for cpu"):
        reduce(torch.empty(5, device="meta"))
