"""The port's ShardedTemporalPlanner and ``train``/``plan --sharded``
against the unsharded model and the JAX package's planner, on the CPU.

The scenarios of the reference's ``tests/test_sharded_temporal.py`` that
do not use the zigzag layout, on gloo ranks: one world of 8 rank
processes (``torch_ranks.py``) runs them all, each on the mesh its case
names (ranks beyond that mesh sit it out), and imports no JAX; the JAX
planner and the unsharded runs are computed here.  Besides the
reference's: params and Adam state identical on every rank; a mask whose
valid-group count differs between the data shards, where the sharded
loss must equal the unsharded loss of the same scores (a per-rank
normaliser would not); the summed gradients of both supervisions
against the unsharded ones (a gradient counted n_seq times would not
show in an Adam trajectory, whose first steps are scale-free); the CLI's
guards and its sharded commands through ``main()`` on the ranks.

Tolerances, each stated where it is used.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from aws_global_accelerator_controller_tpu.models.temporal import (
    TemporalTrafficModel as JaxModel,
)
from aws_global_accelerator_controller_tpu.parallel import (
    ShardedTemporalPlanner as JaxPlanner,
)
from aws_global_accelerator_controller_tpu_torch import device as tdevice
from aws_global_accelerator_controller_tpu_torch.cmd.compute import main
from aws_global_accelerator_controller_tpu_torch.models.common import (
    masked_ce_loss,
    value_and_grad,
)
from aws_global_accelerator_controller_tpu_torch.models.convert import (
    params_from_jax,
)
from aws_global_accelerator_controller_tpu_torch.models.temporal import (
    TemporalTrafficModel,
    synthetic_window,
)
from aws_global_accelerator_controller_tpu_torch.models.traffic import Batch
from aws_global_accelerator_controller_tpu_torch.parallel import (
    distributed,
)
from aws_global_accelerator_controller_tpu_torch.parallel.plan import (
    ShardedTemporalPlanner,
    flash_local,
)
from torch_ranks import run_world

WORLD = 8
SMALL = dict(feature_dim=8, embed_dim=16, hidden_dim=32)
# (seq, data) of the reference's sharded-forward test that fit 8 ranks
FORWARD_MESHES = [(2, 1), (4, 2), (2, 2)]
CLI_TRAIN = ["train", "--model", "temporal", "--sharded", "--window", "16",
             "--groups", "8", "--endpoints", "4", "--hidden", "16",
             "--steps", "2", "--device", "cpu"]
CLI_PLAN = ["plan", "--model", "temporal", "--sharded", "--window", "16",
            "--groups", "8", "--endpoints", "4", "--hidden", "16",
            "--device", "cpu"]
CLI_INDIVISIBLE = ["train", "--model", "temporal", "--sharded", "--window",
                   "9", "--groups", "8", "--steps", "1", "--device", "cpu"]
CLI_ARGVS = [CLI_TRAIN + ["--supervision", "sequence"], CLI_TRAIN, CLI_PLAN,
             CLI_INDIVISIBLE]


def _window(seed, t=8, groups=4, endpoints=4, per_step=False):
    return synthetic_window(np.random.default_rng(seed), steps=t,
                            groups=groups, endpoints=endpoints,
                            per_step=per_step, device="cpu")


def _uneven(per_step: bool):
    """A window of 4 groups whose mask leaves group 3 with no valid
    endpoint: the data shards of a data-2 mesh hold 2 and 1 valid
    groups."""
    window, batch = _window(31, per_step=per_step)
    mask = batch.mask.clone()
    mask[3] = False
    mask[:3, 0] = True
    target = torch.where(mask, batch.target, 0.0)
    target = target / target.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return window, Batch(batch.features, mask, target)


def _case(name, shape, window, batch, **kw):
    return dict(name=name, shape={"data": shape[1], "seq": shape[0]},
                window=window, batch=tuple(batch), **kw)


@pytest.fixture(scope="module")
def jax_params():
    return {k: np.asarray(v) for k, v in JaxModel(
        attention="reference", **SMALL).init_params(
            jax.random.PRNGKey(3)).items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_params):
    """Every scenario on one world of 8 gloo ranks: (inputs, results)."""
    params = params_from_jax(jax_params, device="cpu")
    forward = [_case(f"forward_{s}x{d}", (s, d), *_window(10 * s + d),
                     params=params, model={"attention": "reference"})
               for s, d in FORWARD_MESHES]
    seq_model = {"attention": "reference", "supervision": "sequence"}
    train = [
        _case("sequence", (4, 2), *_window(22, per_step=True), seed=21,
              steps=5, model=seq_model),
        _case("last", (4, 2), *_window(12), seed=11, steps=5,
              model={"attention": "reference"}),
        _case("flash", (2, 2), *_window(8, t=16, groups=2, per_step=True),
              seed=7, steps=15, local="flash", model=seq_model),
    ]
    grads = [_case("sequence", (4, 2), *_uneven(True), seed=41,
                   model=seq_model),
             _case("last", (4, 2), *_uneven(False), seed=42,
                   model={"attention": "reference"})]
    inputs = {"forward": forward, "train": train, "grads": grads,
              "cli": CLI_ARGVS}
    results = run_world("sharded", WORLD, inputs,
                        tmp_path_factory.mktemp("sharded_world"))
    return inputs, results


def _model(case) -> TemporalTrafficModel:
    return TemporalTrafficModel(**SMALL, **case.get("model", {}))


def _jax_mesh(seq, data):
    devs = np.asarray(jax.devices()[:seq * data]).reshape(data, seq)
    return Mesh(devs, axis_names=("data", "seq"))


def _in_mesh(results, case):
    n = case["shape"]["data"] * case["shape"]["seq"]
    return results[:n]


def _weights_law(got, want):
    """The reference's law for a sharded plan
    (``tests/test_sharded_temporal.py:54-61``): no cell off by more than
    1, at least 90% of cells equal; returns the share of equal cells."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    assert np.abs(got - want).max() <= 1
    equal = float((got == want).mean())
    assert equal >= 0.9
    return equal


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq,data", FORWARD_MESHES)
def test_sharded_forward_matches_jax_and_unsharded(world, jax_params, seq,
                                                   data):
    """The port's sharded last-step scores and weights, on params carried
    over from the JAX model, against the JAX ShardedTemporalPlanner on a
    mesh of the same shape and against the port's unsharded model: scores
    within rtol 1e-4, atol 1e-5 (the reference's sharded-vs-unsharded
    tolerance: the per-shard (o, m, l) merge reassociates f32 sums),
    weights by the reference's sharded-plan law.  Every rank holds the
    same gathered plan."""
    inputs, results = world
    case = next(c for c in inputs["forward"]
                if c["name"] == f"forward_{seq}x{data}")
    outs = [r["forward"][case["name"]] for r in _in_mesh(results, case)]
    for o in outs[1:]:
        assert torch.equal(o["weights"], outs[0]["weights"])
        assert torch.equal(o["scores"], outs[0]["scores"])
    got_scores = outs[0]["scores"].numpy()
    got_weights = outs[0]["weights"].numpy()
    window, mask = case["window"], case["batch"][1]

    jmodel = JaxModel(attention="reference", **SMALL)
    planner = JaxPlanner(jmodel, _jax_mesh(seq, data))
    sp = planner.shard_params({k: jax.numpy.asarray(v)
                               for k, v in jax_params.items()})
    sw = planner.shard_window(jax.numpy.asarray(window.numpy()))
    want_scores = np.asarray(jax.jit(
        lambda p, w: jmodel.scores_last(p, w,
                                        attend_last=planner._last_attend),
        in_shardings=(planner.param_sharding,
                      planner.window_sharding))(sp, sw))
    want_weights = np.asarray(planner.forward(
        sp, sw, jax.numpy.asarray(mask.numpy())))
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-4,
                               atol=1e-5)
    _weights_law(got_weights, want_weights)

    model = _model(case)
    params = case["params"]
    with torch.no_grad():
        np.testing.assert_allclose(
            got_scores, model.scores_last(params, window).numpy(),
            rtol=1e-4, atol=1e-5)
        _weights_law(got_weights, model.forward(params, window, mask))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _unsharded_run(case):
    model = _model(case)
    params = model.init_params(torch.Generator().manual_seed(case["seed"]),
                               device="cpu")
    opt = model.init_opt_state(params)
    losses = []
    for _ in range(case["steps"]):
        params, opt, loss = model.train_step(params, opt, case["window"],
                                             Batch(*case["batch"]))
        losses.append(float(loss))
    return losses, params


@pytest.mark.parametrize("name,param_atol", [("sequence", 2e-3),
                                             ("last", 5e-3)])
def test_sharded_training_tracks_unsharded(world, name, param_atol):
    """5 steps on data 2 x seq 4 against 5 unsharded steps: the loss of
    every step within rtol 2e-3, atol 2e-4, and the final params within
    rtol 2e-2 and the reference's atol (``tests/test_sharded_temporal.py
    :79-92, :137-149``: bf16 params round updates whose sums ran in
    another order; near-zero params can flip an update's sign)."""
    inputs, results = world
    case = next(c for c in inputs["train"] if c["name"] == name)
    got = results[0]["train"][name]
    losses, params = _unsharded_run(case)
    assert got["local"] == "einsum"
    for i, (a, b) in enumerate(zip(got["losses"], losses)):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4,
                                   err_msg=f"step {i}")
    for k, p in params.items():
        np.testing.assert_allclose(got["params"][k].float().numpy(),
                                   p.float().numpy(), rtol=2e-2,
                                   atol=param_atol, err_msg=k)


@pytest.mark.parametrize("name", ["sequence", "last", "flash"])
def test_params_and_adam_state_identical_on_every_rank(world, name):
    """Every rank applies the same summed gradient to the same state: the
    params and both Adam moments are equal bit for bit on every rank."""
    inputs, results = world
    case = next(c for c in inputs["train"] if c["name"] == name)
    outs = [r["train"][name] for r in _in_mesh(results, case)]
    assert len(outs) == case["shape"]["data"] * case["shape"]["seq"]
    for o in outs[1:]:
        assert o["losses"] == outs[0]["losses"]
        assert o["count"] == outs[0]["count"] == case["steps"]
        for key in ("params", "mu", "nu"):
            for k, v in outs[0][key].items():
                assert torch.equal(o[key][k], v), (key, k)


def test_sharded_training_reduces_loss_flash_local(world):
    """The ring with the flash local attend (K6b-ring's plain version on
    the CPU) composes with the ring backward: 15 steps on data 2 x seq 2
    lower the loss (the reference's ``:95-113``)."""
    inputs, results = world
    got = results[0]["train"]["flash"]
    assert got["local"] == "flash"
    assert np.isfinite(got["losses"]).all()
    assert got["losses"][-1] < got["losses"][0]


def _assembled_scores(case, outs):
    """The whole batch's scores from the ranks' own: [T, G, E] of the
    sequence ranks' blocks, or [G, E] of the data shards."""
    seq = case["model"].get("supervision") == "sequence"
    blocks = {}
    for o in outs:
        c = o["coords"]
        blocks[(c["data"], c["seq"] if seq else 0)] = o["scores"]
    rows = [torch.cat([blocks[(d, s)] for d in range(case["shape"]["data"])],
                      dim=1 if seq else 0)
            for s in range(case["shape"]["seq"] if seq else 1)]
    return torch.cat(rows, dim=0) if seq else rows[0]


@pytest.mark.parametrize("name", ["sequence", "last"])
def test_loss_divides_by_the_whole_batch(world, name):
    """A mask whose data shards hold 2 and 1 valid groups: the sharded
    loss equals the unsharded loss of the same scores (gathered from the
    ranks) within 1e-6 relative (f32 sums in another order), while a mean
    of the shards' own means would be off by more than 1e-3; and it
    tracks the unsharded model's loss (rtol 2e-3, atol 2e-4)."""
    inputs, results = world
    case = next(c for c in inputs["grads"] if c["name"] == name)
    outs = [r["grads"][name] for r in _in_mesh(results, case)]
    assert len({o["loss"] for o in outs}) == 1
    got = outs[0]["loss"]
    scores = _assembled_scores(case, outs)
    window, batch = case["window"], Batch(*case["batch"])
    want = masked_ce_loss(scores, batch.mask, batch.target)
    want = float(want.mean()) if want.dim() else float(want)
    assert abs(got - want) <= 1e-6 * abs(want)
    g = batch.mask.shape[0] // 2
    halves = [masked_ce_loss(scores[..., d * g:(d + 1) * g, :],
                             batch.mask[d * g:(d + 1) * g],
                             batch.target[..., d * g:(d + 1) * g, :])
              .mean() for d in range(2)]
    per_rank_means = float(sum(halves)) / 2
    assert abs(per_rank_means - want) > 1e-3 * abs(want)
    model = _model(case)
    params = model.init_params(torch.Generator().manual_seed(case["seed"]),
                               device="cpu")
    np.testing.assert_allclose(got, float(model.loss(params, window, batch)),
                               rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("name", ["sequence", "last"])
def test_sharded_gradients_equal_the_unsharded(world, name):
    """The gradient summed over the 8 ranks against the unsharded model's,
    for every param, within 2e-2 of its norm (bf16 partial gradients of
    other summation orders, and under ``sequence`` the ring's einsums
    against dense attention): a share counted n_seq times (4 here), or an
    all-gather backward that did not sum the seq ranks' gradients, is off
    by a factor of order one."""
    inputs, results = world
    case = next(c for c in inputs["grads"] if c["name"] == name)
    got = results[0]["grads"][name]["grads"]
    model = _model(case)
    params = model.init_params(torch.Generator().manual_seed(case["seed"]),
                               device="cpu")
    _, want = value_and_grad(model.loss, params, case["window"],
                             Batch(*case["batch"]))
    for k, w in want.items():
        w = w.float()
        err = float((got[k].float() - w).norm() / w.norm().clamp_min(1e-30))
        assert err <= 2e-2, (k, err)


# ---------------------------------------------------------------------------
# the commands
# ---------------------------------------------------------------------------


def _cli(results, argv):
    i = CLI_ARGVS.index(argv)
    return [r["cli"][i] for r in results]


def _run(argv, capsys):
    assert main(argv) == 0
    import json

    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("supervision", ["sequence", "last"])
def test_train_sharded_on_ranks(world, capsys, supervision):
    """``train --sharded`` through ``main()`` on 8 ranks (data 4 x seq 2):
    rank 0 prints the JSON, the others nothing; its loss tracks the
    unsharded command's (rtol 2e-3, atol 2e-4)."""
    argv = CLI_TRAIN + (["--supervision", "sequence"]
                        if supervision == "sequence" else [])
    outs = _cli(world[1], argv)
    assert all(o["error"] is None for o in outs)
    assert all(o["stdout"] == "" for o in outs[1:])
    got = outs[0]["json"]
    assert (got["world"], got["mesh"], got["backend"]) == (
        8, {"data": 4, "seq": 2}, "gloo")
    assert got["local"] == "einsum"       # a block of 8 steps
    assert got["step"] == 2 and got["device"] == "cpu"
    assert [r["rank"] for r in got["ranks"]] == list(range(8))
    assert all(r["launches"] == {} for r in got["ranks"])
    want = _run([a for a in argv if a != "--sharded"], capsys)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-3,
                               atol=2e-4)


def test_plan_sharded_on_ranks(world, capsys):
    """``plan --sharded`` on 8 ranks against the unsharded command, by the
    reference's sharded-plan law."""
    outs = _cli(world[1], CLI_PLAN)
    assert all(o["stdout"] == "" for o in outs[1:])
    got = outs[0]["json"]
    assert got["mesh"] == {"data": 4, "seq": 2}
    want = _run([a for a in CLI_PLAN if a != "--sharded"], capsys)
    _weights_law(got["weights"], want["weights"])


def test_sharded_divisibility_guard_on_ranks(world):
    """The reference's guard and message, raised on every rank alike."""
    outs = _cli(world[1], CLI_INDIVISIBLE)
    assert {o["error"] for o in outs} == {
        "--sharded needs --window divisible by the seq axis (2) and "
        "--groups by the data axis (4); got window=9 groups=8"}


@pytest.mark.parametrize("argv,message", [
    (["train", "--model", "temporal", "--sharded", "--optimizer",
      "flat_adam"], "--optimizer flat_adam is the single-chip fast path; "
                    "--sharded training needs the per-leaf adam state"),
    (["train", "--model", "temporal", "--sharded", "--attention-chunk",
      "32"], "--attention-chunk applies to single-chip temporal training "
             "only; --sharded attends through the ring"),
    (["train", "--model", "mlp", "--sharded"],
     "--sharded --model mlp is not yet ported: the port shards the "
     "temporal family only"),
    (["plan", "--model", "mlp", "--sharded"],
     "--sharded --model mlp is not yet ported: the port shards the "
     "temporal family only"),
])
def test_sharded_guards(argv, message):
    """The reference's guards (``cmd/compute.py:304-330``) with its
    messages, and the families not yet ported, before any device is
    touched."""
    with pytest.raises(SystemExit) as e:
        main(argv + ["--device", "cpu"])
    assert str(e.value) == message


def test_layout_zigzag_is_not_ported():
    from aws_global_accelerator_controller_tpu_torch.parallel.mesh import (
        make_mesh,
    )

    with distributed.join_world("cpu") as w:
        mesh = make_mesh(w)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ShardedTemporalPlanner(TemporalTrafficModel(**SMALL), mesh,
                               layout="zigzag")
    with pytest.raises(SystemExit):
        main(["train", "--sharded", "--layout", "zigzag"])


def test_train_sharded_needs_the_card(monkeypatch):
    """``--device cuda`` (the default) raises where there is no card, and
    so does a card that does not exist; no rank carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tdevice.DeviceError):
        main(["train", "--model", "temporal", "--sharded", "--steps", "1"])
    with pytest.raises(tdevice.DeviceError):
        main(["plan", "--model", "temporal", "--sharded"])
    with pytest.raises(tdevice.DeviceError):
        main(["train", "--model", "temporal", "--sharded", "--steps", "1",
              "--device", "cuda:3"])


def test_rank_device_takes_the_local_rank_card_or_raises(monkeypatch):
    """``cuda`` is the card of the rank's local rank, which must exist;
    several ranks share a card only under an explicit ``cuda:N``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(tdevice.DeviceError, match="cuda:N"):
        distributed.rank_device("cuda", 1)
    assert distributed.rank_device("cpu", 3) == torch.device("cpu")


def test_train_sharded_without_a_launcher_is_one_rank(capsys):
    """With no launcher the world is one rank (a 1 x 1 mesh, no process
    group): the ring has one block, the flash local at a 64-step block,
    and the loss tracks the unsharded command's."""
    argv = ["train", "--model", "temporal", "--supervision", "sequence",
            "--window", "64", "--groups", "3", "--endpoints", "4",
            "--hidden", "16", "--steps", "2", "--device", "cpu"]
    got = _run(argv + ["--sharded"], capsys)
    assert (got["world"], got["mesh"], got["backend"], got["local"]) == (
        1, {"data": 1, "seq": 1}, None, "flash")
    want = _run(argv, capsys)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-3,
                               atol=2e-4)


def test_flash_local_gate():
    """The reference's gate: flash where the model asks for it and a
    rank's block reaches FLASH_MIN_WINDOW (64); at the train default
    window of 64 with seq 2 the ring attends with einsums."""
    flash = TemporalTrafficModel(**SMALL)
    assert flash_local(flash, 64, 2) == "einsum"
    assert flash_local(flash, 128, 2) == "flash"
    assert flash_local(flash, None, 1) == "einsum"
    assert flash_local(TemporalTrafficModel(attention="reference", **SMALL),
                       256, 2) == "einsum"


def test_model_seams_default_to_the_unsharded_path():
    """The reference's seams: ``attend`` in ``scores_seq`` and ``loss``,
    ``attend_last`` and ``last_step`` in ``scores_last``;
    given the model's own attention or row, each equals the call without
    it bit for bit."""
    seq = TemporalTrafficModel(attention="reference", supervision="sequence",
                               **SMALL)
    params = seq.init_params(torch.Generator().manual_seed(1), device="cpu")
    window, batch = _window(5, per_step=True)
    assert torch.equal(seq.loss(params, window, batch, attend=seq._attend),
                       seq.loss(params, window, batch))
    last = TemporalTrafficModel(attention="reference", **SMALL)
    window, batch = _window(6)
    want = last.scores_last(params, window)
    assert torch.equal(last.scores_last(params, window,
                                        last_step=window[-1]), want)
    assert not torch.equal(last.scores_last(params, window,
                                            last_step=window[3]), want)
    assert torch.equal(last.loss(params, window, batch, attend=last._attend),
                       masked_ce_loss(last.scores(params, window),
                                      batch.mask, batch.target))
