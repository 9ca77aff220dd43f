"""The port's traffic model and ``plan`` command against the JAX
package's, on the CPU.

Both packages compute with the same params: the JAX model's init,
carried bit for bit by ``params_from_jax``.  Features and masks are made
with numpy from a seed.  The JAX fused kernel runs in Pallas interpret
mode.  Tolerances: scores within 2 bf16 ulps, weights +-1 on at most
0.5% of cells (recorded).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_global_accelerator_controller_tpu.models.traffic import (
    FEATURE_DIM as JAX_FEATURE_DIM,
    HIDDEN_DIM as JAX_HIDDEN_DIM,
    TrafficPolicyModel as JaxModel,
)
from aws_global_accelerator_controller_tpu.ops.pallas_mlp import (
    _forward as jax_fused_forward,
)
from aws_global_accelerator_controller_tpu_torch import parity
from aws_global_accelerator_controller_tpu_torch.cmd.compute import main
from aws_global_accelerator_controller_tpu_torch.models.convert import (
    params_from_jax,
)
from aws_global_accelerator_controller_tpu_torch.models.traffic import (
    FEATURE_DIM,
    HIDDEN_DIM,
    TrafficPolicyModel,
    synthetic_batch,
)
from aws_global_accelerator_controller_tpu_torch.ops.cuda_mlp import (
    forward_cuda,
    forward_reference,
    score_rows_cuda,
)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params) sharing params."""
    jm = JaxModel()
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                         device="cpu")
    return jm, jp, TrafficPolicyModel(), tp


def telemetry(seed, G=24, E=16):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((G, E, FEATURE_DIM)).astype(np.float32)
    mask = rng.random((G, E)) < 0.8
    mask[::6] = False
    return feats, mask


def test_widths_match_the_jax_model():
    assert (FEATURE_DIM, HIDDEN_DIM) == (JAX_FEATURE_DIM, JAX_HIDDEN_DIM)


def test_scores_within_two_bf16_ulps(pair):
    jm, jp, tm, tp = pair
    for seed in range(3):
        feats, _ = telemetry(seed)
        got = tm.scores(tp, torch.from_numpy(feats))
        want = np.asarray(jm.scores(jp, jnp.asarray(feats)))
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert parity.scores_close(got.numpy(), want)


def test_score_rows_is_independent_of_the_batch(pair):
    _, _, tm, tp = pair
    feats, _ = telemetry(3)
    rows = torch.from_numpy(feats.reshape(-1, FEATURE_DIM))
    whole = tm.score_rows(tp, rows)
    assert torch.equal(whole.reshape(feats.shape[:2]),
                       tm.scores(tp, torch.from_numpy(feats)))
    assert torch.equal(tm.score_rows(tp, rows[5:12]), whole[5:12])
    assert torch.equal(score_rows_cuda(tp, rows), whole)


def test_forward_dense_matches_jax(pair, record_property):
    jm, jp, tm, tp = pair
    got, want = [], []
    for seed in range(4):
        feats, mask = telemetry(10 + seed)
        got.append(tm.forward_dense(tp, torch.from_numpy(feats),
                                    torch.from_numpy(mask)).numpy())
        want.append(np.asarray(jm.forward_dense(jp, jnp.asarray(feats),
                                                jnp.asarray(mask))))
    err, frac = parity.weight_mismatch(np.stack(got), np.stack(want))
    record_property("mismatch_frac", frac)
    assert err <= parity.MAX_WEIGHT_DIFF
    assert frac <= parity.MAX_MISMATCH_FRAC


def test_fused_path_matches_pallas_kernel_interpret(pair, record_property):
    """The CPU side of kernel K3 against the TPU kernel interpreted."""
    _, jp, tm, tp = pair
    feats, mask = telemetry(20, G=16, E=8)
    fused = TrafficPolicyModel(serve="fused")
    got = fused.forward(tp, torch.from_numpy(feats), torch.from_numpy(mask))
    assert torch.equal(got, forward_cuda(tp, torch.from_numpy(feats),
                                         torch.from_numpy(mask)))
    assert torch.equal(got, forward_reference(tp, torch.from_numpy(feats),
                                              torch.from_numpy(mask)))
    want = np.asarray(jax_fused_forward(jp, jnp.asarray(feats),
                                        jnp.asarray(mask), interpret=True))
    err, frac = parity.weight_mismatch(got.numpy(), want)
    record_property("mismatch_frac", frac)
    assert err <= parity.MAX_WEIGHT_DIFF
    assert frac <= parity.MAX_MISMATCH_FRAC
    assert not got.numpy()[~mask].any()


def test_serve_modes_agree_on_cpu(pair):
    _, _, _, tp = pair
    feats, mask = telemetry(30)
    x, m = torch.from_numpy(feats), torch.from_numpy(mask)
    outs = [TrafficPolicyModel(serve=s).forward(tp, x, m)
            for s in ("auto", "dense", "fused")]
    assert all(parity.weights_close(o.numpy(), outs[0].numpy())
               for o in outs)
    with pytest.raises(ValueError):
        TrafficPolicyModel(serve="pallas")


def test_init_params_has_the_jax_shapes_and_scales(pair):
    _, jp, tm, _ = pair
    params = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert set(params) == set(jp)
    for k, v in params.items():
        assert tuple(v.shape) == tuple(jp[k].shape), k
        assert v.dtype == torch.bfloat16
    std = params["w2"].float().std().item()
    assert abs(std * np.sqrt(HIDDEN_DIM) - 1.0) < 0.05
    assert not params["b1"].float().any()
    again = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_synthetic_batch_is_seeded_and_well_formed():
    a = synthetic_batch(np.random.default_rng(5), 6, 10, device="cpu")
    b = synthetic_batch(np.random.default_rng(5), 6, 10, device="cpu")
    assert a.features.dtype == torch.bfloat16
    assert tuple(a.features.shape) == (6, 10, FEATURE_DIM)
    assert a.mask.dtype == torch.bool and tuple(a.mask.shape) == (6, 10)
    assert torch.equal(a.features, b.features)
    assert torch.equal(a.mask, b.mask)
    sums = a.target.sum(dim=-1)
    assert bool(((sums - 1).abs().lt(1e-5) | sums.eq(0)).all())


def test_plan_command_on_cpu(capsys):
    assert main(["plan", "--groups", "5", "--endpoints", "6", "--seed",
                 "3", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"groups", "endpoints", "device", "weights"}
    assert (out["groups"], out["endpoints"], out["device"]) == (5, 6,
                                                                "cpu")
    w = np.asarray(out["weights"])
    assert w.shape == (5, 6) and w.min() >= 0 and w.max() <= 255
    main(["plan", "--groups", "5", "--endpoints", "6", "--seed", "3",
          "--device", "cpu", "--serve", "fused"])
    fused = json.loads(capsys.readouterr().out)
    assert parity.weights_close(np.asarray(fused["weights"]), w)


def test_plan_command_takes_any_hidden_width(capsys):
    """The fused MLP kernel tiles its hidden layer, so ``--hidden 256``
    needs no other ``--serve`` and the help names no limit."""
    from aws_global_accelerator_controller_tpu_torch.cmd.compute import (
        build_parser,
    )

    with pytest.raises(SystemExit):
        build_parser().parse_args(["plan", "--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "--hidden HIDDEN Model hidden width." in text
    assert "128" not in text and "--serve dense" not in text
    args = build_parser().parse_args(["plan", "--model", "mlp", "--hidden",
                                      "256"])
    assert (args.hidden, args.serve) == (256, "auto")
    assert main(["plan", "--model", "mlp", "--hidden", "256", "--groups",
                 "4", "--endpoints", "5", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert np.asarray(out["weights"]).shape == (4, 5)
