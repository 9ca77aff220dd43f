"""The port's fused score head (kernels K10 and K11) against the JAX
package's, on the CPU.

The reference's kernels run as its own tests run them here, in Pallas
interpret mode (``_fwd`` and ``_bwd`` with ``interpret=True``); the port
runs their plain versions, which follow the kernels' arithmetic.  Inputs
are made with numpy from a seed.  Shapes come from the reference's own
``tests/test_pallas_head.py``: the tile-hostile (19, 48, 96, 200), the
single stream (8, 1, 8, 16) and (16, 128, 128, 256) with H > 128.
Tolerances, each stated where it is used:

- scores: 2 bf16 ulps of what each sums in absolute value
  (``cuda_head.score_head_magnitude``); at these shapes they agree bit
  for bit;
- dx: 2 bf16 ulps of what each element sums in absolute value, a relu
  gate that another f32 order could flip counted in full
  (``cuda_head.score_head_dx_magnitude``): dx sums in another f32 order
  than XLA's;
- weight gradients: within ``cuda_head.score_head_weight_grad_limits``
  (a share of the root sum of squares of their terms, which is what a
  sum over rows of random sign cancels to, plus the f32 order's error
  and the terms of gates another order could flip) and one ulp of
  their dtype;
- model losses: rtol 1e-4; each param's change over 3 adam steps
  within half a step of the reference's change and one bf16 ulp of the
  param (where one f32 update lands on the other side of a bf16
  rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_global_accelerator_controller_tpu.models.temporal import (
    TemporalTrafficModel as JaxModel,
)
from aws_global_accelerator_controller_tpu.models.traffic import (
    Batch as JaxBatch,
)
from aws_global_accelerator_controller_tpu.ops import pallas_head
from aws_global_accelerator_controller_tpu_torch import parity
from aws_global_accelerator_controller_tpu_torch.kernels import build
from aws_global_accelerator_controller_tpu_torch.models import temporal
from aws_global_accelerator_controller_tpu_torch.models.convert import (
    params_from_jax,
)
from aws_global_accelerator_controller_tpu_torch.models.temporal import (
    TemporalTrafficModel,
    synthetic_window,
)
from aws_global_accelerator_controller_tpu_torch.ops import cuda_head
from aws_global_accelerator_controller_tpu_torch.ops.cuda_head import (
    score_head,
    score_head_bwd_plain,
    score_head_dx_magnitude,
    score_head_magnitude,
    score_head_plain,
    score_head_weight_grad_limits,
    weight_grad_error,
)

SHAPES = [(19, 48, 96, 200), (8, 1, 8, 16), (16, 128, 128, 256)]
SMALL = dict(feature_dim=8, embed_dim=16, hidden_dim=32)
G, E, T = 5, 8, 64
LR = 1e-3


def to_torch(params):
    return params_from_jax({k: np.asarray(v) for k, v in params.items()},
                           device="cpu")


def as_f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x).astype(jnp.float32)))


def head_inputs(t, s, d, h, seed):
    """(x, w1, b1, w2, b2, ds) as JAX arrays: bf16 x and params with the
    reference test's scales, an f32 cotangent."""
    rng = np.random.default_rng(seed)
    bf = jnp.bfloat16
    return (jnp.asarray(rng.standard_normal((t, s, d), np.float32), bf),
            jnp.asarray(rng.standard_normal((d, h), np.float32) * 0.1, bf),
            jnp.asarray(np.linspace(-0.1, 0.1, h, dtype=np.float32), bf),
            jnp.asarray(rng.standard_normal((h, 1), np.float32) * 0.1, bf),
            jnp.asarray(np.full(1, 0.05, np.float32), bf),
            jnp.asarray(rng.standard_normal((t, s), np.float32)))


def torch_inputs(args):
    return list(to_torch(dict(enumerate(args))).values())


@pytest.mark.parametrize("t,s,d,h", SHAPES)
def test_forward_plain_matches_reference_kernel(t, s, d, h):
    args = head_inputs(t, s, d, h, t + h)
    want = as_f32(pallas_head._fwd(*args[:5], interpret=True))
    x, w1, b1, w2, b2, _ = torch_inputs(args)
    got = score_head_plain(x, w1, b1, w2, b2)
    assert got.dtype == torch.float32 and tuple(got.shape) == (t, s)
    assert parity.scores_close(as_f32(got), want,
                               scale=as_f32(score_head_magnitude(
                                   x, w1, b1, w2, b2)))


@pytest.mark.parametrize("t,s,d,h", SHAPES)
def test_backward_plain_matches_reference_kernel(t, s, d, h):
    args = head_inputs(t, s, d, h, 3 * t + h)
    want = pallas_head._bwd(*args, interpret=True)
    ins = torch_inputs(args)
    got = score_head_bwd_plain(*ins)
    for name, g, w, like in zip(("dx", "dw1", "db1", "dw2", "db2"), got,
                                want, ins):
        assert g.dtype == like.dtype and g.shape == like.shape, name
    assert parity.scores_close(as_f32(got[0]), as_f32(want[0]),
                               scale=as_f32(score_head_dx_magnitude(*ins)))
    limits = score_head_weight_grad_limits(*ins)
    for name, g, w, lim in zip(("dw1", "db1", "dw2", "db2"), got[1:],
                               want[1:], limits):
        w = torch.from_numpy(np.array(as_f32(w))).to(g.dtype)
        assert weight_grad_error(g, w, lim) <= 1.0, name


def _lose_rows(ins, keep):
    """The weight gradients of the rows where ``keep`` is 1 only: what
    a backward that lost the other rows' share would return."""
    x, w1, b1, w2, b2, ds = ins
    return score_head_bwd_plain(x, w1, b1, w2, b2,
                                ds * keep.reshape(ds.shape))[1:]


@pytest.mark.parametrize("fault", ["zeros", "every_other_cta",
                                   "first_tile_of_each_cta", None])
def test_weight_gradient_limits_catch_lost_rows(fault):
    """At 64,000 rows (the card test's many-row-tile shape), where each
    weight gradient is a sum that cancels to a few hundredths of its
    absolute sum, the limits fail a backward that returns zeros, sums
    every other CTA's partial or adds only the first row tile of each
    CTA (64-row tiles, 8 a CTA), and pass the same sums taken in another
    order (float64)."""
    t, s, d, h = 64, 1000, 32, 128
    ins = torch_inputs(head_inputs(t, s, d, h, 17))
    want = score_head_bwd_plain(*ins)[1:]
    limits = score_head_weight_grad_limits(*ins)
    tile = torch.arange(t * s) // 64
    if fault is None:
        x, w1, b1, w2, _, ds = ins
        x2, dsf = x.reshape(-1, d), ds.reshape(-1, 1)
        hid = cuda_head._hidden(x2, w1, b1)
        dh = torch.where(hid > 0, dsf * w2.float().t(),
                         0.0).to(torch.bfloat16).double()
        got = ((x2.double().t() @ dh).to(w1.dtype),
               dh.sum(dim=0).to(b1.dtype),
               (hid.double().t() @ dsf.to(torch.bfloat16).double())
               .to(w2.dtype), dsf.double().sum(dim=0).to(ins[4].dtype))
    elif fault == "zeros":
        got = [torch.zeros_like(w) for w in want]
    elif fault == "every_other_cta":
        got = _lose_rows(ins, (tile // 8 % 2 == 0).float())
    else:
        got = _lose_rows(ins, (tile % 8 == 0).float())
    errs = [weight_grad_error(g, w, lim)
            for g, w, lim in zip(got, want, limits)]
    if fault is None:
        assert max(errs) <= 1.0, errs
    else:
        assert max(errs) > 4.0, errs


def test_autograd_runs_the_plain_backward_on_cpu():
    """Under autograd ``score_head`` takes the head's VJP (the plain K11
    on CPU tensors), not dense autograd: its gradients are the plain
    backward's bit for bit, and no kernel launches."""
    ins = torch_inputs(head_inputs(19, 48, 96, 200, 1))
    leaves = [t.clone().requires_grad_(True) for t in ins[:5]]
    build.reset_launch_counts()
    out = score_head(*leaves)
    got = torch.autograd.grad(out, leaves, ins[5])
    assert not any(build.launch_counts().values())
    want = score_head_bwd_plain(*ins)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with torch.no_grad():
        assert torch.equal(score_head(*ins[:5]), out.detach())


def test_magnitude_admits_a_flipped_relu_gate():
    """A unit whose pre-activation is zero to within the f32 order of
    x . w1 is counted in full: dx with that gate flipped stays within two
    bf16 ulps of its magnitude, and dw1 and db1 within their limits."""
    x = torch.tensor([[[1.0, -1.0]]], dtype=torch.bfloat16)
    w1 = torch.tensor([[1.0, 0.5], [1.0, 0.25]], dtype=torch.bfloat16)
    b1 = torch.zeros(2, dtype=torch.bfloat16)
    w2 = torch.tensor([[1.0], [1.0]], dtype=torch.bfloat16)
    b2 = torch.zeros(1, dtype=torch.bfloat16)
    ds = torch.ones((1, 1))
    dx, dw1, db1, *_ = score_head_bwd_plain(x, w1, b1, w2, b2, ds)
    mag = score_head_dx_magnitude(x, w1, b1, w2, b2, ds)
    # unit 0 sits at exactly zero (shut); opened, dx gains w1[:, 0]
    flipped = dx.float() + w1[:, 0].float()
    assert parity.scores_close(as_f32(flipped), as_f32(dx),
                               scale=as_f32(mag))
    assert not parity.scores_close(
        as_f32(flipped), as_f32(dx),
        scale=as_f32(dx.float().abs() + w1[:, 1].float().abs()))
    # and dw1, db1 gain x and 1 in unit 0's column
    lim_dw1, lim_db1, *_ = score_head_weight_grad_limits(x, w1, b1, w2, b2,
                                                         ds)
    opened = dw1.clone()
    opened[:, 0] += x.reshape(-1)
    assert weight_grad_error(opened, dw1, lim_dw1) <= 1.0
    opened_b = db1.clone()
    opened_b[0] += 1
    assert weight_grad_error(opened_b, db1, lim_db1) <= 1.0
    assert weight_grad_error(opened, dw1, torch.zeros_like(lim_dw1)) > 1.0


def window(seed):
    return synthetic_window(np.random.default_rng(seed), steps=T, groups=G,
                            endpoints=E, per_step=True, device="cpu")


def jax_batch(batch):
    return JaxBatch(features=jnp.asarray(batch.features.float().numpy(),
                                         jnp.bfloat16),
                    mask=jnp.asarray(batch.mask.numpy()),
                    target=jnp.asarray(batch.target.numpy()))


@pytest.fixture(scope="module")
def jax_params():
    return JaxModel(**SMALL).init_params(jax.random.PRNGKey(0))


def test_fused_always_trajectory_matches_jax(jax_params):
    """Three sequence-supervised adam steps through the fused head (the
    reference's Pallas head in interpret mode, the port's plain K10 and
    K11) with flash attention: the losses within rtol 1e-4; each param's
    change within half a step (lr / 2) and one bf16 ulp of the param of
    the reference's change, on at most 1/16 of its elements anything but
    equal; and the head's params moved.  b2 is held only within 2 lr a
    step: its gradient is zero in exact arithmetic (the sequence loss is
    a softmax over each group's endpoints, which a shift shared by every
    score leaves alone), so its steps are adam's response to rounding."""
    kw = dict(attention="flash_always", supervision="sequence",
              head="fused_always", learning_rate=LR, **SMALL)
    jmodel, tmodel = JaxModel(**kw), TemporalTrafficModel(**kw)
    jp, tp = jax_params, to_torch(jax_params)
    start = {k: as_f32(v) for k, v in jp.items()}
    jstate, tstate = jmodel.init_opt_state(jp), tmodel.init_opt_state(tp)
    build.reset_launch_counts()
    for step in range(3):
        w, b = window((11, step))
        jp, jstate, jloss = jmodel.train_step(jp, jstate,
                                              jnp.asarray(w.numpy()),
                                              jax_batch(b))
        tp, tstate, loss = tmodel.train_step(tp, tstate, w, b)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert not any(build.launch_counts().values())
    for k, p in tp.items():
        assert p.dtype == torch.bfloat16
        got, want = as_f32(p) - start[k], as_f32(jp[k]) - start[k]
        if k == "b2":
            np.testing.assert_allclose(got, want, rtol=0, atol=2 * LR * 3)
            continue
        ulp = parity.bf16_ulp(np.maximum(np.abs(as_f32(p)),
                                         np.abs(as_f32(jp[k]))))
        assert (np.abs(got - want) <= LR / 2 + ulp).all(), k
        assert (got != want).mean() <= 1 / 16, k
        if k in ("w1", "b1", "w2"):
            assert (got != 0).mean() >= 0.5, k

def test_converted_fused_params_give_the_reference_scores(jax_params):
    """A JAX ``head="fused_always"`` model's params, carried by
    ``params_from_jax`` unchanged (w1 [D, H], b1 [H], w2 [H, 1], b2 [1]),
    give the port the reference's per-step scores."""
    kw = dict(attention="reference", supervision="sequence",
              head="fused_always", **SMALL)
    w, _ = window(4)
    want = as_f32(JaxModel(**kw).scores_seq(jax_params,
                                            jnp.asarray(w.numpy())))
    tp = to_torch(jax_params)
    assert {k: tuple(v.shape) for k, v in tp.items()
            if k in ("w1", "b1", "w2", "b2")} == {
        "w1": (16, 32), "b1": (32,), "w2": (32, 1), "b2": (1,)}
    got = as_f32(TemporalTrafficModel(**kw).scores_seq(tp, w))
    assert parity.scores_close(got, want)


def test_fused_on_cpu_is_the_dense_head(jax_params, monkeypatch):
    """``head="fused"`` takes the fused head only on the card, as the
    reference's does only on its TPU rung: on the CPU the loss and the
    gradients are the dense head's bit for bit."""
    from aws_global_accelerator_controller_tpu_torch.models.common import (
        value_and_grad,
    )

    def boom(*a, **k):
        raise AssertionError("the fused head ran on the CPU")

    monkeypatch.setattr(temporal, "score_head", boom)
    tp = to_torch(jax_params)
    w, b = window(5)
    kw = dict(supervision="sequence", **SMALL)
    fused = value_and_grad(TemporalTrafficModel(head="fused", **kw).loss,
                           tp, w, b)
    dense = value_and_grad(TemporalTrafficModel(**kw).loss, tp, w, b)
    assert torch.equal(fused[0], dense[0])
    assert all(torch.equal(fused[1][k], dense[1][k]) for k in tp)


def test_two_dimensional_paths_stay_dense(jax_params, monkeypatch):
    """``scores`` and ``scores_last`` score [S, D] representations, which
    the fused head never takes (as in the reference)."""
    def boom(*a, **k):
        raise AssertionError("the fused head took a 2-D representation")

    monkeypatch.setattr(temporal, "score_head", boom)
    tp = to_torch(jax_params)
    w, _ = window(6)
    for name in ("scores", "scores_last"):
        got = getattr(TemporalTrafficModel(head="fused_always", **SMALL),
                      name)(tp, w)
        want = getattr(TemporalTrafficModel(**SMALL), name)(tp, w)
        assert torch.equal(got, want), name


def test_remat_is_skipped_for_a_fused_head(jax_params, monkeypatch):
    """The fused head recomputes its hidden in its own backward, so
    ``remat`` does not checkpoint it (the reference's ``scores_seq``);
    the dense head under ``remat`` still is."""
    calls = []

    def counting(fn, *args, **kw):
        calls.append(fn)
        return fn(*args)

    monkeypatch.setattr(temporal, "checkpoint", counting)
    tp = to_torch(jax_params)
    w, b = window(7)
    kw = dict(supervision="sequence", remat=True, **SMALL)
    fused = TemporalTrafficModel(head="fused_always", **kw)
    state = fused.init_opt_state(tp)
    _, _, loss = fused.train_step(tp, state, w, b)
    assert calls == [] and bool(torch.isfinite(loss))
    dense = TemporalTrafficModel(**kw)
    dense.train_step(tp, dense.init_opt_state(tp), w, b)
    assert len(calls) == 1


def test_kernel_wrappers_refuse_other_devices():
    meta = [t.to("meta") for t in torch_inputs(head_inputs(2, 3, 8, 16, 0))]
    with pytest.raises(ValueError, match="CUDA"):
        cuda_head.score_head_forward(*meta[:5])
    with pytest.raises(ValueError, match="CUDA"):
        cuda_head.score_head_bwd(*meta)


@pytest.mark.parametrize("D", [32, 20])
def test_kernel_layout_takes_w1_as_it_is(D):
    """The kernels' operands (``_layout``, past the wrappers' device
    check): at D = 32 x and w1 are the caller's own storage, no copy
    kernel before K10 or K11; at D = 20 both are padded with zeros to
    D = 24, the values unchanged."""
    x, w1, b1, w2, b2 = torch_inputs(head_inputs(2, 3, D, 16, 0))[:5]
    x2, w1p, *_, N, got_d, H = cuda_head._layout("layout", x, w1, b1, w2,
                                                 b2)
    assert (N, got_d, H) == (6, D, 16)
    if D % cuda_head.WIDTH_MULTIPLE == 0:
        assert w1p.data_ptr() == w1.data_ptr()
        assert x2.data_ptr() == x.data_ptr()
    else:
        assert w1p.shape == (24, 16) and x2.shape == (6, 24)
        assert torch.equal(w1p[:D], w1) and not bool(w1p[D:].any())
        assert torch.equal(x2[:, :D], x.reshape(6, D))
        assert not bool(x2[:, D:].any())
