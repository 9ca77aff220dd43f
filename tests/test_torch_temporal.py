"""The port's temporal family against the JAX package's, on the CPU.

Both packages compute with the same params (the JAX model's init,
carried bit for bit by ``params_from_jax``) on the same windows, made
with numpy from a seed.  The JAX flash kernel runs in Pallas interpret
mode.  The JAX model runs op by op, not under ``jax.jit``: XLA's fusion
keeps some bf16 intermediates in f32 (excess precision), which is not
the rounding the model's code states and the port follows.  Sizes are
small (T = 64 and 72, 8 streams, D = 16 or 32) so the file runs in
seconds.  Tolerances, each stated where it is used:

- attention outputs: 2 bf16 ulps of the magnitude they average
  (``parity.attention_close``);
- the dense attention oracle: rtol = atol = 1e-5 (f32 both sides);
- scores: 2 bf16 ulps (``parity.scores_close``);
- weights: +-1 on at most 0.5% of cells (``parity.weights_close``);
- losses: rtol 1e-4 (f32 sums in another order);
- the softmax stats m and l of the flash forward: rtol 1e-6 (s in
  another f32 order moves the row max and sum by an f32 ulp or two);
- attention gradients: 2 bf16 ulps of the magnitude each one sums
  (``cuda_attention.flash_attention_bwd_magnitude``), at the reference's
  block; against dense autograd, the gradient tolerance
  (``parity.grads_close``).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_global_accelerator_controller_tpu.models.temporal import (
    FLASH_MIN_WINDOW as JAX_FLASH_MIN_WINDOW,
    TemporalTrafficModel as JaxModel,
)
from aws_global_accelerator_controller_tpu.models.traffic import (
    Batch as JaxBatch,
)
from aws_global_accelerator_controller_tpu.ops.pallas_attention import (
    _flash_fwd_padded,
    _fused_bwd_eligible,
    _prescale as jax_prescale,
    _resolve_blocks,
    flash_attention as jax_flash_attention,
)
from aws_global_accelerator_controller_tpu.parallel.ring_attention import (
    attention_reference as jax_attention_reference,
)
from aws_global_accelerator_controller_tpu_torch import parity
from aws_global_accelerator_controller_tpu_torch.cmd.compute import (
    main,
    plan_l1,
)
from aws_global_accelerator_controller_tpu_torch.device import DeviceError
from aws_global_accelerator_controller_tpu_torch.models import temporal
from aws_global_accelerator_controller_tpu_torch.models.convert import (
    params_from_jax,
)
from aws_global_accelerator_controller_tpu_torch.models.temporal import (
    FLASH_MIN_WINDOW,
    TemporalTrafficModel,
    synthetic_window,
)
from aws_global_accelerator_controller_tpu_torch.ops import cuda_attention
from aws_global_accelerator_controller_tpu_torch.ops.cuda_attention import (
    BLOCK_K,
    flash_attention,
    flash_attention_bwd_magnitude,
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_attention_stats_plain,
)
from aws_global_accelerator_controller_tpu_torch.parallel.ring_attention \
    import attention_reference

SMALL = dict(feature_dim=8, embed_dim=16, hidden_dim=32)
G, E = 2, 4


def bf16_pair(rng, shape):
    """The same bf16 values as a jax array and a torch tensor."""
    a = jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                    jnp.bfloat16)
    t = torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16)
    return a, t


def telemetry(T, seed):
    return np.random.default_rng(seed).standard_normal(
        (T, G, E, 8)).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    """(jax params, port params): the JAX init, carried bit for bit."""
    jp = jax.jit(JaxModel(**SMALL).init_params)(jax.random.PRNGKey(0))
    return jp, params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                               device="cpu")


def test_flash_min_window_matches_jax():
    assert FLASH_MIN_WINDOW == JAX_FLASH_MIN_WINDOW


@pytest.mark.parametrize("T,D", [(64, 16), (72, 32)])
def test_flash_plain_matches_jax_flash_at_its_block(T, D):
    """The plain version of K6a against the Pallas kernel (interpret
    mode) at JAX's own K block: one block covering T (80 at T = 72,
    with 8 padded keys masked)."""
    rng = np.random.default_rng(T)
    (jq, q), (jk, k), (jv, v) = (bf16_pair(rng, (T, 8, D))
                                 for _ in range(3))
    _, block_k = _resolve_blocks(T, T, None, None)
    got = flash_attention_plain(q, k, v, causal=True, block_k=block_k)
    want = np.asarray(jax_flash_attention(jq, jk, jv, causal=True)
                      .astype(jnp.float32))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (T, 8, D)
    mag = flash_attention_plain(q, k, v.abs(), causal=True, block_k=block_k)
    assert parity.attention_close(got.float().numpy(), want,
                                  mag.float().numpy())


def test_flash_plain_block_partition_only_rounds():
    """Folding the keys in 64-blocks or in one block differs only at the
    bf16 rounding of p (2 ulps of the magnitude)."""
    rng = np.random.default_rng(3)
    _, q = bf16_pair(rng, (130, 4, 32))
    _, k = bf16_pair(rng, (130, 4, 32))
    _, v = bf16_pair(rng, (130, 4, 32))
    one = flash_attention_plain(q, k, v, True, block_k=130)
    assert torch.equal(flash_attention(q, k, v), flash_attention_plain(
        q, k, v, True, block_k=BLOCK_K))
    mag = flash_attention_plain(q, k, v.abs(), True, block_k=130)
    assert parity.attention_close(flash_attention(q, k, v).float().numpy(),
                                  one.float().numpy(), mag.float().numpy())


@pytest.mark.parametrize("T", [64, 72])
def test_stats_plain_matches_jax_stats_kernel(T):
    """The plain version of K6b against the reference's VJP forward
    (``_stats_kernel`` in interpret mode, ``_flash_fwd_padded``) at its
    block: the normalised o, and the stats m and l of the live rows."""
    rng = np.random.default_rng(T + 1)
    (jq, q), (jk, k), (jv, v) = (bf16_pair(rng, (T, 8, 32))
                                 for _ in range(3))
    block_q, block_k = _resolve_blocks(T, T, None, None)
    heads = [jnp.transpose(x, (1, 0, 2)) for x in (jq, jk, jv)]
    oh, jm, jl = _flash_fwd_padded(jax_prescale(heads[0]), *heads[1:], True,
                                   block_q, block_k, True)
    o, m, l = flash_attention_stats_plain(q, k, v, True, block_k)
    assert (o.dtype, m.dtype, l.dtype) == (torch.bfloat16, torch.float32,
                                           torch.float32)
    assert tuple(m.shape) == tuple(l.shape) == (8, T)
    want = np.asarray(jnp.transpose(oh, (1, 0, 2)).astype(jnp.float32))
    mag = flash_attention_plain(q, k, v.abs(), True, block_k)
    assert parity.attention_close(o.float().numpy(), want,
                                  mag.float().numpy())
    np.testing.assert_allclose(m.numpy(), np.asarray(jm)[:, :T, 0],
                               rtol=1e-6)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl)[:, :T, 0],
                               rtol=1e-6)
    # l >= 1 on every live row, so K6a's o (/ l) is K6b's (/ max(l, 1))
    assert bool((l >= 1).all())
    assert torch.equal(flash_attention_plain(q, k, v, True, block_k), o)


def _plain_grads(q, k, v, do, block):
    o, m, l = flash_attention_stats_plain(q, k, v, True, block)
    return (flash_attention_bwd_plain(q, k, v, o, do, m, l, True, block,
                                      block),
            flash_attention_bwd_magnitude(q, k, v, o, do, m, l, True))


@pytest.mark.parametrize("T,S,D,fused", [
    (64, 40, 16, False), (64, 40, 32, False), (72, 40, 16, False),
    (72, 40, 32, False), (72, 8, 32, True)])
def test_bwd_plain_matches_jax_flash_vjp(T, S, D, fused):
    """The plain two-sweep backward (K7, K8) against ``jax.vjp`` of the
    reference's flash attention with a random bf16 cotangent, at the
    reference's block.  At S = 40 heads the reference takes its two-sweep
    route (``_dq_kernel``, ``_dkv_kernel``); at S = 8 its fused one-sweep
    ``_dqkv_kernel``, which computes the same sums."""
    rng = np.random.default_rng(T + S + D)
    (jq, q), (jk, k), (jv, v), (jdo, do) = (bf16_pair(rng, (T, S, D))
                                            for _ in range(4))
    block, _ = _resolve_blocks(T, T, None, None)
    tp = -(-T // block) * block
    assert _fused_bwd_eligible(tp, tp, 128, S) == fused
    _, vjp = jax.vjp(lambda *x: jax_flash_attention(*x, causal=True),
                     jq, jk, jv)
    got, mags = _plain_grads(q, k, v, do, block)
    for name, g, w, mag in zip(("dq", "dk", "dv"), got, vjp(jdo), mags):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == (T, S, D)
        assert parity.attention_close(
            g.float().numpy(), np.asarray(w.astype(jnp.float32)),
            mag.numpy()), name


def test_flash_autograd_is_the_plain_backward_and_near_dense():
    """Autograd through ``flash_attention`` runs the plain K6b and, at 6
    heads, the plain fused backward K9 (the reference's route) on CPU
    tensors, bit for bit.  Against dense autograd through the
    attention oracle (f32, no rounding of p, ds or o) it agrees within 3
    bf16 ulps of the magnitude: the 2 of the flash rounding plus the
    rounding of o, as for the forward (the model's parameter gradients
    are held to the JAX package's flash-vs-dense tolerance in
    ``test_torch_train.py``)."""
    rng = np.random.default_rng(12)
    q, k, v, do = (bf16_pair(rng, (72, 6, 32))[1] for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*leaves)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), flash_attention(q, k, v))
    got = torch.autograd.grad(out, leaves, do)
    _, mags = _plain_grads(q, k, v, do, BLOCK_K)
    o, m, l = flash_attention_stats_plain(q, k, v)
    assert cuda_attention.fused_bwd_route(72, 6, 32)
    want = cuda_attention.flash_bwd_dqkv_plain(
        q, k, v, do, m, l, cuda_attention.attention_dvec(o, do))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    dense = [x.clone().float().requires_grad_(True) for x in (q, k, v)]
    ref = torch.autograd.grad(attention_reference(*dense, causal=True),
                              dense, do.float())
    for a, b, mag in zip(got, ref, mags):
        assert parity.attention_close(a.float().numpy(), b.numpy(),
                                      mag.numpy(), ulps=3)


def test_width_padding_is_exact():
    """On the card the wrappers pad a head width that is not a multiple
    of 8 with zero columns and keep the true width's scale
    (``cuda_attention._pad_width``).  The plain versions show that is
    exact: at D = 20, attention and its backward on the zero-padded
    D = 24 inputs, with the scale of D = 20 and the padding dropped,
    equal the unpadded ones bit for bit, and the padded columns come out
    zero."""
    rng = np.random.default_rng(20)
    D = 20
    q, k, v, do = (bf16_pair(rng, (130, 3, D))[1] for _ in range(4))
    padded = cuda_attention._pad_width(q, k, v, do)
    assert all(x.shape == (130, 3, 24) for x in padded)
    pq, pk, pv, pdo = padded
    o, m, l = flash_attention_stats_plain(q, k, v)
    po, pm, pl = flash_attention_stats_plain(pq, pk, pv, scale=D ** -0.5)
    assert torch.equal(po[..., :D], o) and not po[..., D:].any()
    assert torch.equal(pm, m) and torch.equal(pl, l)
    grads = flash_attention_bwd_plain(q, k, v, o, do, m, l)
    pgrads = flash_attention_bwd_plain(pq, pk, pv, po, pdo, pm, pl,
                                       scale=D ** -0.5)
    for g, pg in zip(grads, pgrads):
        assert torch.equal(pg[..., :D], g) and not pg[..., D:].any()


@pytest.mark.parametrize("causal", [True, False])
def test_attention_reference_matches_jax(causal):
    rng = np.random.default_rng(7)
    (jq, q), (jk, k), (jv, v) = (bf16_pair(rng, (72, 8, 32))
                                 for _ in range(3))
    got = attention_reference(q, k, v, causal=causal)
    want = np.asarray(jax_attention_reference(jq, jk, jv, causal=causal))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    flash = flash_attention(q, k, v, causal=causal).float()
    mag = attention_reference(q, k, v.abs(), causal=causal)
    # flash rounds p and o to bf16: 2 bf16 ulps of the magnitude plus the
    # rounding of o itself
    assert parity.attention_close(flash.numpy(), got.numpy(), mag.numpy(),
                                  ulps=3)


@pytest.mark.parametrize("T", [64, 72])
@pytest.mark.parametrize("attention", ["flash_always", "reference"])
@pytest.mark.parametrize("method", ["scores", "scores_last", "scores_seq"])
def test_scores_match_jax(params, T, attention, method):
    jp, tp = params
    w = telemetry(T, seed=T)
    want = np.asarray(getattr(JaxModel(attention=attention, **SMALL),
                              method)(jp, jnp.asarray(w)))
    got = getattr(TemporalTrafficModel(attention=attention, **SMALL),
                  method)(tp, torch.from_numpy(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    scale = None
    if attention == "flash_always" and T % BLOCK_K:
        # JAX folds T = 72 keys in one 80-key block, the kernel in 64-key
        # blocks; p is rounded against the running max, so the attended
        # values differ at their last ulp and a score that cancels to
        # near zero moves by more than 2 ulps of itself: held to 2 ulps
        # of the largest score of the same step
        scale = np.abs(want).max(axis=(-2, -1), keepdims=True)
    assert parity.scores_close(got.numpy(), want, scale=scale)


@pytest.mark.parametrize("T", [64, 72])
def test_forward_weights_match_jax(params, T):
    jp, tp = params
    w = telemetry(T, seed=T + 1)
    mask = np.random.default_rng(T).random((G, E)) < 0.8
    want = np.asarray(JaxModel(**SMALL).forward(jp, jnp.asarray(w),
                                                jnp.asarray(mask)))
    got = TemporalTrafficModel(**SMALL).forward(tp, torch.from_numpy(w),
                                                torch.from_numpy(mask))
    assert got.dtype == torch.int32
    assert parity.weights_close(got.numpy(), want)
    assert not got.numpy()[~mask].any()


@pytest.mark.parametrize("supervision", ["last", "sequence"])
def test_loss_matches_jax(params, supervision):
    jp, tp = params
    window, batch = synthetic_window(
        np.random.default_rng(11), steps=64, groups=G, endpoints=E,
        per_step=supervision == "sequence", device="cpu")
    jbatch = JaxBatch(features=jnp.asarray(batch.features.float().numpy(),
                                           jnp.bfloat16),
                      mask=jnp.asarray(batch.mask.numpy()),
                      target=jnp.asarray(batch.target.numpy()))
    kw = dict(attention="flash_always", supervision=supervision, **SMALL)
    want = float(JaxModel(**kw).loss(jp, jnp.asarray(window.numpy()),
                                     jbatch))
    got = TemporalTrafficModel(**kw).loss(tp, window, batch)
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-4)


def test_attention_chunk_split_equals_unsplit(params):
    _, tp = params
    w = torch.from_numpy(telemetry(64, seed=5))
    whole = TemporalTrafficModel(**SMALL).scores_seq(tp, w)
    for chunk in (3, 8):
        split = TemporalTrafficModel(attention_chunk=chunk,
                                     **SMALL).scores_seq(tp, w)
        assert torch.equal(split, whole)


def test_constructor_checks():
    for head in ("reference", "fused", "fused_always"):
        assert TemporalTrafficModel(head=head).head == head
    for bad in (dict(attention="ring"), dict(supervision="all"),
                dict(head="pallas"), dict(attention_chunk=-1)):
        with pytest.raises(ValueError):
            TemporalTrafficModel(**bad)
    assert TemporalTrafficModel(remat=True).remat is True


def test_short_windows_take_the_dense_reference(params, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("flash kernel called for a short window")

    monkeypatch.setattr(temporal, "flash_attention", boom)
    _, tp = params
    w = torch.from_numpy(telemetry(FLASH_MIN_WINDOW - 1, seed=2))
    seq = TemporalTrafficModel(attention="flash", **SMALL).scores_seq(tp, w)
    assert tuple(seq.shape) == (FLASH_MIN_WINDOW - 1, G, E)


def test_init_params_has_the_jax_shapes_and_scales(params):
    jp, _ = params
    model = TemporalTrafficModel(**SMALL)
    tp = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert set(tp) == set(jp)
    for k, v in tp.items():
        assert tuple(v.shape) == tuple(jp[k].shape), k
        assert v.dtype == torch.bfloat16
    assert abs(tp["wq"].float().std().item() * 4.0 - 1.0) < 0.15
    assert not tp["b1"].float().any()
    again = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(tp[k], again[k]) for k in tp)


def test_params_from_jax_carries_the_temporal_params(params):
    jp, tp = params
    for k, v in jp.items():
        assert np.array_equal(tp[k].view(torch.int16).numpy().view(np.uint16),
                              np.asarray(v).view(np.uint16)), k


def test_synthetic_window_is_seeded_and_well_formed():
    w, b = synthetic_window(np.random.default_rng(4), steps=5, groups=3,
                            endpoints=6, per_step=True, device="cpu")
    w2, b2 = synthetic_window(np.random.default_rng(4), steps=5, groups=3,
                              endpoints=6, per_step=True, device="cpu")
    assert w.dtype == torch.float32 and tuple(w.shape) == (5, 3, 6, 8)
    assert torch.equal(w, w2) and torch.equal(b.mask, b2.mask)
    assert torch.equal(b.features, w[-1].to(torch.bfloat16))
    assert tuple(b.target.shape) == (5, 3, 6)
    sums = b.target.sum(dim=-1)
    assert bool(((sums - 1).abs().lt(1e-5) | sums.eq(0)).all())
    # step 0's trend is zero: uniform over the valid endpoints
    n = b.mask.sum(dim=-1, keepdim=True).clamp_min(1)
    assert torch.allclose(b.target[0], b.mask / n)
    _, last = synthetic_window(np.random.default_rng(4), steps=5, groups=3,
                               endpoints=6, device="cpu")
    assert torch.allclose(last.target, b.target[-1])


def test_plan_l1_of_the_uniform_plan_is_the_uniform_l1():
    mask = torch.tensor([[True, True, False], [False, False, False]])
    target = torch.tensor([[0.75, 0.25, 0.0], [0.0, 0.0, 0.0]])
    l1, u1 = plan_l1(torch.tensor([[7, 7, 0], [0, 0, 0]]), mask, target)
    assert float(l1) == float(u1) == 0.5
    l1, _ = plan_l1(torch.tensor([[3, 1, 9], [4, 0, 0]]), mask, target)
    assert float(l1) == 0.0


def test_plan_temporal_command_on_cpu(capsys):
    assert main(["plan", "--model", "temporal", "--groups", "3",
                 "--endpoints", "5", "--window", "16", "--device",
                 "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"groups", "endpoints", "device", "weights"}
    w = np.asarray(out["weights"])
    assert w.shape == (3, 5) and w.min() >= 0 and w.max() <= 255
    with pytest.raises(SystemExit):
        main(["plan", "--model", "temporal", "--serve", "fused",
              "--device", "cpu"])


@pytest.mark.parametrize("model,supervision", [
    ("mlp", "last"), ("temporal", "last"), ("temporal", "sequence")])
def test_eval_command_on_cpu(capsys, model, supervision):
    argv = ["eval", "--model", model, "--supervision", supervision,
            "--batches", "2", "--groups", "3", "--endpoints", "4",
            "--hidden", "32", "--window", "64", "--device", "cpu"]
    assert main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"model", "step", "batches", "mean_loss", "plan_l1",
                        "uniform_l1", "beats_uniform", "device"}
    assert (out["model"], out["batches"], out["device"]) == (model, 2, "cpu")
    assert np.isfinite(out["mean_loss"]) and out["mean_loss"] > 0
    assert 0 <= out["plan_l1"] <= 2 and 0 <= out["uniform_l1"] <= 2
    assert out["beats_uniform"] == (out["plan_l1"] < out["uniform_l1"])
    main(argv)
    assert json.loads(capsys.readouterr().out) == out
    with pytest.raises(SystemExit):
        main(["eval", "--batches", "0", "--device", "cpu"])


def test_eval_without_device_cpu_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        main(["eval", "--model", "temporal", "--batches", "1"])
    with pytest.raises(DeviceError):
        main(["plan", "--model", "temporal"])
