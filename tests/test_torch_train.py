"""The port's training step against the JAX package's, on the CPU.

Both packages start from the same params (the JAX init, carried bit for
bit by ``params_from_jax``) and train on the same batches, made with
numpy from a seed.  The JAX model runs op by op, not under ``jax.jit``
(XLA's fusion keeps bf16 intermediates in f32 there), with its flash
kernels in Pallas interpret mode.  The streams number G x E = 5 x 8 = 40,
more than the 32 heads of the reference's fused backward, so unchunked
both packages differentiate through the two-sweep K7/K8 route; with
``attention_chunk`` each call falls under that gate and both take the
fused one-sweep K9 route.  Tolerances, each stated where it is used:

- the optimizers: bit for bit (the same bf16 or f32 operations in the
  same order);
- per-parameter gradients: the gradient tolerance of ``parity.py``
  (rtol 5e-2, atol 5e-3).  Most entries agree bit for bit.  The biases'
  gradients are bf16 sums of bf16 cotangents; the port takes them in the
  order of XLA's CPU reduction (``ops/cuda_mlp.py::xla_cpu_bf16_sum``,
  bit-equal to ``jax.vjp`` in ``tests/test_torch_bias_grad.py``), so
  what remains between the packages is the f32 order of the matmuls'
  and attention's own sums;
- trajectories: losses within rtol 1e-4; params within 2 lr per step:
  an Adam step moves a param by about lr, so where a gradient near zero
  has its sign flipped by another f32 order the two runs part by up to
  2 lr a step.  ``tests/test_torch_train_seeds_adam.py`` and
  ``tests/test_torch_train_seeds_flat_adam.py`` hold the same check on
  20 batch seeds each.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aws_global_accelerator_controller_tpu.models.common import (
    flat_adam as jax_flat_adam,
)
from aws_global_accelerator_controller_tpu.models.temporal import (
    TemporalTrafficModel as JaxTemporal,
)
from aws_global_accelerator_controller_tpu.models.traffic import (
    Batch as JaxBatch,
    TrafficPolicyModel as JaxTraffic,
)
from aws_global_accelerator_controller_tpu.ops.pallas_attention import (
    _FUSED_BWD_MAX_HEADS,
)
from aws_global_accelerator_controller_tpu_torch import parity
from aws_global_accelerator_controller_tpu_torch.cmd import compute
from aws_global_accelerator_controller_tpu_torch.cmd.compute import main
from aws_global_accelerator_controller_tpu_torch.device import DeviceError
from aws_global_accelerator_controller_tpu_torch.kernels import build
from aws_global_accelerator_controller_tpu_torch.models import common
from aws_global_accelerator_controller_tpu_torch.models.common import (
    adam,
    apply_updates,
    flat_adam,
    value_and_grad,
)
from aws_global_accelerator_controller_tpu_torch.models.convert import (
    params_from_jax,
)
from aws_global_accelerator_controller_tpu_torch.models.temporal import (
    TemporalTrafficModel,
    synthetic_window,
)
from aws_global_accelerator_controller_tpu_torch.models.traffic import (
    TrafficPolicyModel,
    synthetic_batch,
)
from aws_global_accelerator_controller_tpu_torch.ops import cuda_attention
from aws_global_accelerator_controller_tpu_torch.signals import (
    ScopedStopSignal,
)

SMALL = dict(feature_dim=8, embed_dim=16, hidden_dim=32)
G, E, T = 5, 8, 64
LR = 1e-3


def to_torch(params):
    return params_from_jax({k: np.asarray(v) for k, v in params.items()},
                           device="cpu")


def jax_batch(batch):
    return JaxBatch(features=jnp.asarray(batch.features.float().numpy(),
                                         jnp.bfloat16),
                    mask=jnp.asarray(batch.mask.numpy()),
                    target=jnp.asarray(batch.target.numpy()))


def window(supervision, seed):
    return synthetic_window(np.random.default_rng(seed), steps=T, groups=G,
                            endpoints=E, per_step=supervision == "sequence",
                            device="cpu")


def as_f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x).astype(jnp.float32)))


@pytest.fixture(scope="module")
def temporal_params():
    jp = JaxTemporal(**SMALL).init_params(jax.random.PRNGKey(0))
    return jp, to_torch(jp)


def test_streams_take_the_reference_two_sweep_route():
    assert G * E > _FUSED_BWD_MAX_HEADS


@pytest.mark.parametrize("supervision", ["last", "sequence"])
def test_temporal_grads_match_jax(temporal_params, supervision):
    jp, tp = temporal_params
    w, b = window(supervision, 1)
    kw = dict(attention="flash_always", supervision=supervision, **SMALL)
    jloss, jgrads = jax.value_and_grad(JaxTemporal(**kw).loss)(
        jp, jnp.asarray(w.numpy()), jax_batch(b))
    build.reset_launch_counts()
    loss, grads = value_and_grad(TemporalTrafficModel(**kw).loss, tp, w, b)
    assert not any(build.launch_counts().values())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        assert g.dtype == torch.bfloat16 and g.shape == tp[k].shape, k
        assert parity.grads_close(as_f32(g), as_f32(jgrads[k])), k


def test_mlp_grads_match_jax():
    jp = JaxTraffic(hidden_dim=32).init_params(jax.random.PRNGKey(1))
    batch = synthetic_batch(np.random.default_rng(3), groups=16,
                            endpoints=8, device="cpu")
    jloss, jgrads = jax.value_and_grad(JaxTraffic(hidden_dim=32).loss)(
        jp, jax_batch(batch))
    loss, grads = value_and_grad(TrafficPolicyModel(hidden_dim=32).loss,
                                 to_torch(jp), batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    for k, g in grads.items():
        assert parity.grads_close(as_f32(g), as_f32(jgrads[k])), k


def test_flash_grads_agree_with_dense_attention_grads(temporal_params):
    """The JAX package's own check (``test_temporal_model.py:121-142``),
    on the port: the flash VJP and dense autograd give the same
    parameter gradients within its tolerance."""
    _, tp = temporal_params
    w, b = window("sequence", 2)
    grads = {}
    for attention in ("flash", "reference"):
        model = TemporalTrafficModel(attention=attention,
                                     supervision="sequence", **SMALL)
        grads[attention] = value_and_grad(model.loss, tp, w, b)[1]
    for k, g in grads["flash"].items():
        assert parity.grads_close(as_f32(g), as_f32(grads["reference"][k])), k


def _optimizers(name):
    """(the reference's optimizer, the port's) for ``name``."""
    if name == "adam":
        return optax.adam(LR), adam(LR)
    return jax_flat_adam(LR), flat_adam(LR)


def _jax_state(name, state):
    return state[0] if name == "adam" else state


def _bits(x):
    return as_f32(x).view(np.int32)


@pytest.mark.parametrize("name", ["adam", "flat_adam"])
def test_optimizers_match_the_reference_bit_for_bit(name):
    """Fifty steps over 1,048,907 elements of fresh bf16 grads whose
    scales spread from 1e-8 to 1: the port's adam against
    ``optax.adam``, its flat_adam against the JAX package's; updates,
    params and moments bit for bit."""
    rng = np.random.default_rng(5)
    shapes = {"w1": (1024, 1024), "b1": (300,), "w2": (7, 11), "b2": (1,)}
    jp = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32),
                         jnp.bfloat16) for k, s in shapes.items()}
    jopt, topt = _optimizers(name)
    jstate, tp = jopt.init(jp), to_torch(jp)
    tstate = topt.init(tp)
    for _ in range(50):
        g = {k: jnp.asarray((rng.standard_normal(s)
                             * 10.0 ** rng.uniform(-8, 0, s)).astype(
                                 np.float32), jnp.bfloat16)
             for k, s in shapes.items()}
        jup, jstate = jopt.update(g, jstate, jp)
        jp = optax.apply_updates(jp, jup)
        tup, tstate = topt.update(to_torch(g), tstate, tp)
        tp = apply_updates(tp, tup)
        for k in shapes:
            assert tup[k].dtype == tp[k].dtype == torch.bfloat16
            assert np.array_equal(_bits(tup[k]), _bits(jup[k])), k
            assert np.array_equal(_bits(tp[k]), _bits(jp[k])), k
    js = _jax_state(name, jstate)
    assert tstate.count == int(js.count) == 50
    if name == "adam":
        for k in shapes:
            assert np.array_equal(_bits(tstate.mu[k]), _bits(js.mu[k])), k
            assert np.array_equal(_bits(tstate.nu[k]), _bits(js.nu[k])), k
    else:
        assert np.array_equal(_bits(tstate.mu), _bits(js.mu))
        assert np.array_equal(_bits(tstate.nu), _bits(js.nu))


def test_flat_adam_takes_the_reference_sqrt():
    """One element at count 43 where a float32 ``torch.sqrt`` on the CPU
    is one ulp off the correctly rounded root, which moves the bf16 step
    by one ulp: the port steps as the JAX package's ``flat_adam``."""
    mu, nu = np.float32(0.0011205738), np.float32(5.5017717e-06)
    grad = jnp.asarray([-0.0059509277], jnp.bfloat16)
    jopt, topt = _optimizers("flat_adam")
    jstate = jopt.init({"w": grad})._replace(
        count=jnp.asarray(43, jnp.int32), mu=jnp.asarray([mu]),
        nu=jnp.asarray([nu]))
    tstate = topt.init(to_torch({"w": grad}))._replace(
        count=43, mu=torch.tensor([mu]), nu=torch.tensor([nu]))
    jup, _ = jopt.update({"w": grad}, jstate)
    tup, _ = topt.update(to_torch({"w": grad}), tstate)
    assert float(as_f32(jup["w"])[0]) == pytest.approx(-3.6716461e-05,
                                                       rel=1e-7)
    assert np.array_equal(_bits(tup["w"]), _bits(jup["w"]))


@pytest.mark.parametrize("decay", [0.9, 0.999])
def test_bias_correction_matches_xla(decay):
    """1 - decay**count for counts 1-100,000 equals ``jnp``'s float32
    value, as ``optax`` (int32 count) and the JAX ``flat_adam`` (float32
    count) compute it."""
    counts = np.arange(1, 100_001, dtype=np.int32)
    want_int = np.asarray(jax.jit(lambda c: 1 - decay ** c)(counts))
    want_f32 = np.asarray(1.0 - decay ** jnp.asarray(counts, jnp.float32))
    assert np.array_equal(want_int, want_f32)
    got = np.array([common._bias(decay, int(c)) for c in counts],
                   np.float32)
    assert np.array_equal(got.view(np.int32), want_int.view(np.int32))


@pytest.mark.parametrize("name", ["adam", "flat_adam"])
def test_optimizers_flush_subnormals_as_xla(name):
    """Grads whose squares, products with the decay constants or roots
    fall below float32's smallest normal: XLA on the CPU reads and
    writes subnormals as zero, and so does the port (moments, updates
    and params bit for bit over three steps)."""
    vals = np.array([1e-19, -2e-19, 3e-18, 1e-37, 5e-39, 0.0, 1e-3,
                     -1e-20], np.float32)
    g = {"w": jnp.asarray(vals, jnp.bfloat16)}
    jp = {"w": jnp.asarray([0, 1, -1, 0, 0, 0, 2, 0], jnp.bfloat16)}
    jopt, topt = _optimizers(name)
    jstate, tp = jopt.init(jp), to_torch(jp)
    tstate = topt.init(tp)
    for _ in range(3):
        jup, jstate = jopt.update(g, jstate, jp)
        jp = optax.apply_updates(jp, jup)
        tup, tstate = topt.update(to_torch(g), tstate, tp)
        tp = apply_updates(tp, tup)
        js = _jax_state(name, jstate)
        jnu, tnu = ((js.nu["w"], tstate.nu["w"]) if name == "adam"
                    else (js.nu, tstate.nu))
        assert np.array_equal(_bits(tnu), _bits(jnu))
        assert np.array_equal(_bits(tup["w"]), _bits(jup["w"]))
        assert np.array_equal(_bits(tp["w"]), _bits(jp["w"]))


def check_three_step_trajectory(temporal_params, optimizer, supervision,
                                seed):
    """Three train steps of both packages on the batches ``(seed, step)``:
    losses within rtol 1e-4, params within 2 lr a step."""
    jp, tp = temporal_params
    kw = dict(attention="flash_always", supervision=supervision,
              optimizer=optimizer, learning_rate=LR, **SMALL)
    jmodel, tmodel = JaxTemporal(**kw), TemporalTrafficModel(**kw)
    jstate, tstate = jmodel.init_opt_state(jp), tmodel.init_opt_state(tp)
    for step in range(3):
        w, b = window(supervision, (seed, step))
        jp, jstate, jloss = jmodel.train_step(jp, jstate,
                                              jnp.asarray(w.numpy()),
                                              jax_batch(b))
        tp, tstate, loss = tmodel.train_step(tp, tstate, w, b)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    for k, p in tp.items():
        assert p.dtype == torch.bfloat16
        np.testing.assert_allclose(as_f32(p), as_f32(jp[k]), rtol=0,
                                   atol=2 * LR * 3, err_msg=k)


@pytest.mark.parametrize("optimizer,supervision", [
    ("adam", "sequence"), ("flat_adam", "last")])
def test_three_step_trajectory_matches_jax(temporal_params, optimizer,
                                           supervision):
    check_three_step_trajectory(temporal_params, optimizer, supervision, 7)


def _trajectory(model, params, steps=3, seed=9):
    state = model.init_opt_state(params)
    losses = []
    for step in range(steps):
        w, b = window(model.supervision, (seed, step))
        params, state, loss = model.train_step(params, state, w, b)
        losses.append(float(loss))
    return params, losses


def test_remat_gives_the_same_trajectory(temporal_params):
    _, tp = temporal_params
    runs = [_trajectory(TemporalTrafficModel(supervision="sequence",
                                             remat=remat, **SMALL), tp)
            for remat in (False, True)]
    assert runs[0][1] == runs[1][1]
    assert all(torch.equal(runs[0][0][k], runs[1][0][k]) for k in tp)


def test_sequence_training_reduces_loss():
    model = TemporalTrafficModel(supervision="sequence", **SMALL)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    w, b = synthetic_window(np.random.default_rng(1), steps=T, groups=4,
                            endpoints=8, per_step=True, device="cpu")
    state = model.init_opt_state(params)
    first = float(model.loss(params, w, b))
    for _ in range(30):
        params, state, loss = model.train_step(params, state, w, b)
    assert float(loss) < first


@pytest.mark.parametrize("chunk", [8, 5])
def test_chunked_grads_match_jax(temporal_params, chunk):
    """``attention_chunk`` splits the 40 streams into calls of at most
    ``chunk`` heads (5 calls of 8, or 7 of 5 and one of 5), each under
    the reference's 32-head gate, so each call's backward is the fused
    one-sweep K9 here (its plain version, no launch on the CPU) and
    ``_dqkv_kernel`` in the JAX package: the loss within rtol 1e-4, every
    gradient within the gradient tolerance."""
    jp, tp = temporal_params
    w, b = window("sequence", 3)
    assert cuda_attention.fused_bwd_route(T, chunk, SMALL["embed_dim"])
    kw = dict(attention="flash_always", supervision="sequence",
              attention_chunk=chunk, **SMALL)
    jloss, jgrads = jax.value_and_grad(JaxTemporal(**kw).loss)(
        jp, jnp.asarray(w.numpy()), jax_batch(b))
    build.reset_launch_counts()
    loss, grads = value_and_grad(TemporalTrafficModel(**kw).loss, tp, w, b)
    assert not any(build.launch_counts().values())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    for k, g in grads.items():
        assert g.dtype == torch.bfloat16 and g.shape == tp[k].shape, k
        assert parity.grads_close(as_f32(g), as_f32(jgrads[k])), k


@pytest.mark.parametrize("optimizer,chunk", [("adam", 8),
                                             ("flat_adam", 5)])
def test_chunked_three_step_trajectory_matches_jax(temporal_params,
                                                   optimizer, chunk):
    """Three chunked training steps (K6b and K9 per chunk, as plain
    versions) against the JAX package's, on the batches of
    ``test_three_step_trajectory_matches_jax`` and with its tolerances:
    losses within rtol 1e-4, params within 2 lr per step.  The port's
    chunked params equal its unchunked ones (K6b, K7 and K8 over all 40
    heads) bit for bit: the plain K9 sums as the plain K7 and K8 do."""
    jp, tp = temporal_params
    kw = dict(attention="flash_always", supervision="sequence",
              optimizer=optimizer, learning_rate=LR, **SMALL)
    whole, _ = _trajectory(TemporalTrafficModel(**kw), tp, seed=7)
    kw["attention_chunk"] = chunk
    jmodel, tmodel = JaxTemporal(**kw), TemporalTrafficModel(**kw)
    jstate, tstate = jmodel.init_opt_state(jp), tmodel.init_opt_state(tp)
    for step in range(3):
        w, b = window("sequence", (7, step))
        jp, jstate, jloss = jmodel.train_step(jp, jstate,
                                              jnp.asarray(w.numpy()),
                                              jax_batch(b))
        tp, tstate, loss = tmodel.train_step(tp, tstate, w, b)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    for k, p in tp.items():
        assert p.dtype == torch.bfloat16
        np.testing.assert_allclose(as_f32(p), as_f32(jp[k]), rtol=0,
                                   atol=2 * LR * 3, err_msg=k)
        assert torch.equal(p, whole[k]), k


TRAIN = ["train", "--groups", "3", "--endpoints", "4", "--hidden", "16",
         "--steps", "4", "--device", "cpu"]


@pytest.mark.parametrize("argv", [
    ["--model", "mlp"],
    ["--model", "mlp", "--optimizer", "flat_adam", "--eval-every", "2"],
    ["--model", "temporal"],
    ["--model", "temporal", "--supervision", "sequence", "--remat"]])
def test_train_command_on_cpu(capsys, argv):
    assert main(TRAIN + argv) == 0
    captured = capsys.readouterr()
    out = json.loads(captured.out)
    assert set(out) == {"step", "model", "loss", "device"}
    assert (out["step"], out["model"], out["device"]) == (
        4, argv[1], "cpu")
    assert np.isfinite(out["loss"]) and out["loss"] > 0
    assert "step 4 loss" in captured.err
    if "--eval-every" in argv:
        assert "step 2 eval_loss" in captured.err
    main(TRAIN + argv)
    assert json.loads(capsys.readouterr().out) == out


def test_train_guard_reinitialises_on_a_non_finite_loss(capsys, monkeypatch):
    real = TrafficPolicyModel.train_step
    calls = []

    def flaky(self, params, opt_state, *data):
        calls.append(1)
        p, s, loss = real(self, params, opt_state, *data)
        return p, s, loss * float("nan") if len(calls) == 2 else loss

    monkeypatch.setattr(TrafficPolicyModel, "train_step", flaky)
    assert main(TRAIN + ["--guard"]) == 0
    out = json.loads(capsys.readouterr().out)
    # batch 2 diverged: the params were re-initialised, and batches 3
    # and 4 applied two updates to them
    assert out["step"] == 2 and np.isfinite(out["loss"])
    monkeypatch.setattr(TrafficPolicyModel, "train_step",
                        lambda self, p, s, *d: (p, s, torch.tensor(
                            float("inf"))))
    with pytest.raises(SystemExit, match="diverged"):
        main(TRAIN + ["--steps", "10", "--guard"])


def test_train_stops_on_a_signal(capsys, monkeypatch):
    class Stopped(ScopedStopSignal):
        def __enter__(self):
            event = super().__enter__()
            event.set()
            return event

    monkeypatch.setattr(compute, "ScopedStopSignal", Stopped)
    assert main(TRAIN) == 0
    out = json.loads(capsys.readouterr().out)
    assert out == {"step": 0, "model": "mlp", "loss": None, "device": "cpu",
                   "preempted": True}


def test_chunked_train_command_on_cpu(capsys):
    """``train --attention-chunk 8`` on the CPU: 12 streams in calls of 8
    and 4, each backward on the fused route (plain versions)."""
    argv = TRAIN + ["--model", "temporal", "--supervision", "sequence",
                    "--attention-chunk", "8"]
    build.reset_launch_counts()
    assert main(argv) == 0
    assert not any(build.launch_counts().values())
    out = json.loads(capsys.readouterr().out)
    assert (out["step"], out["model"], out["device"]) == (4, "temporal",
                                                          "cpu")
    assert np.isfinite(out["loss"]) and out["loss"] > 0


@pytest.mark.parametrize("extra,match", [
    (["--attention-chunk", "-1"], "must be >= 0"),
    (["--model", "mlp", "--attention-chunk", "8"], "temporal family only")])
def test_train_command_refuses_a_bad_attention_chunk(extra, match):
    """The reference's guards (``cmd/compute.py:311-317``, ``:331-332``),
    before any device is touched."""
    with pytest.raises(SystemExit, match=match):
        main(TRAIN + ["--model", "temporal", "--supervision", "sequence"]
             + extra)


def test_train_command_refuses_what_the_slice_leaves_out(monkeypatch):
    for extra in (["--ckpt", "x"], ["--sharded"], ["--model", "moe"]):
        with pytest.raises(SystemExit):
            main(TRAIN + extra)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        main(["train", "--steps", "1"])
