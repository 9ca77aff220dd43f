"""The port's weight and diff ops against the JAX package's, on the CPU.

Every input is made once with numpy from a seed and handed to both
packages.  The JAX quantizer kernel runs in Pallas interpret mode, as
the JAX package's own tests run it off the TPU.  Tolerances are the
port's (``aws_global_accelerator_controller_tpu_torch/parity.py``):
diffs and ids exact; weights +-1 on at most 0.5% of cells, with the
fraction recorded.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_global_accelerator_controller_tpu.ops import diff as jdiff
from aws_global_accelerator_controller_tpu.ops.pallas_weights import (
    _plan as jax_plan_kernel,
)
from aws_global_accelerator_controller_tpu.ops.weights import (
    masked_softmax as jax_masked_softmax,
    plan_weights as jax_plan_weights,
)
from aws_global_accelerator_controller_tpu_torch import parity
from aws_global_accelerator_controller_tpu_torch.device import DeviceError
from aws_global_accelerator_controller_tpu_torch.ops import diff as tdiff
from aws_global_accelerator_controller_tpu_torch.ops.cuda_weights import (
    plan_block,
    plan_weights_cuda,
)
from aws_global_accelerator_controller_tpu_torch.ops.weights import (
    MAX_WEIGHT,
    masked_softmax,
    plan_weights,
)

SHAPES = [(64, 4), (48, 16), (32, 32), (16, 7)]


def score_case(seed, G, E):
    """Scores with ragged rows, all-masked rows (every 5th) and one row
    of two equal scores (p = 0.5, so 127.5 rounds half to even)."""
    rng = np.random.default_rng(seed)
    scores = (rng.standard_normal((G, E)) * 3).astype(np.float32)
    mask = np.arange(E)[None, :] < rng.integers(0, E + 1, (G, 1))
    mask[::5] = False
    scores[1, :2] = 0.5
    mask[1] = False
    mask[1, :2] = True
    return scores, mask


def pooled(pairs):
    got = np.concatenate([np.asarray(g).ravel() for g, _ in pairs])
    want = np.concatenate([np.asarray(w).ravel() for _, w in pairs])
    return parity.weight_mismatch(got, want)


def test_plan_weights_matches_jax(record_property):
    pairs = []
    for seed, (G, E) in enumerate(SHAPES):
        scores, mask = score_case(seed, G, E)
        got = plan_weights(torch.from_numpy(scores), torch.from_numpy(mask))
        want = jax_plan_weights(jnp.asarray(scores), jnp.asarray(mask))
        assert got.dtype == torch.int32
        pairs.append((got.numpy(), np.asarray(want)))
    err, frac = pooled(pairs)
    record_property("mismatch_frac", frac)
    assert err <= parity.MAX_WEIGHT_DIFF
    assert frac <= parity.MAX_MISMATCH_FRAC


def test_quantizer_matches_pallas_kernel_interpret(record_property):
    """The CPU side of kernel K2 (plan_block) against the TPU kernel run
    in interpret mode."""
    pairs = []
    for seed, (G, E) in enumerate(SHAPES):
        scores, mask = score_case(100 + seed, G, E)
        got = plan_weights_cuda(torch.from_numpy(scores),
                                torch.from_numpy(mask))
        want = jax_plan_kernel(jnp.asarray(scores), jnp.asarray(mask),
                               interpret=True)
        pairs.append((got.numpy(), np.asarray(want)))
    err, frac = pooled(pairs)
    record_property("mismatch_frac", frac)
    assert err <= parity.MAX_WEIGHT_DIFF
    assert frac <= parity.MAX_MISMATCH_FRAC


def test_all_masked_rows_give_zeros_not_nan():
    scores = torch.tensor([[1.0, 2.0, 3.0], [0.5, -1.0, 4.0]])
    mask = torch.zeros((2, 3), dtype=torch.bool)
    p = masked_softmax(scores, mask)
    assert torch.equal(p, torch.zeros_like(p))
    for fn in (plan_weights, plan_block):
        w = fn(scores, mask)
        assert torch.equal(w, torch.zeros((2, 3), dtype=torch.int32))
    want = jax_masked_softmax(jnp.asarray(scores.numpy()),
                              jnp.asarray(mask.numpy()))
    assert np.array_equal(p.numpy(), np.asarray(want))


def test_rounding_is_half_to_even():
    scores = torch.tensor([[0.5, 0.5, 9.0]])
    mask = torch.tensor([[True, True, False]])
    want = np.asarray(jax_plan_weights(jnp.asarray(scores.numpy()),
                                       jnp.asarray(mask.numpy())))
    for fn in (plan_weights, plan_block):
        got = fn(scores, mask)
        # 255 * 0.5 = 127.5 rounds to the even 128 (round-half-up
        # would give 128 too; 126.5 -> 126 below tells them apart)
        assert got.tolist() == [[128, 128, 0]]
        assert np.array_equal(got.numpy(), want)
    assert torch.round(torch.tensor([126.5])).item() == 126.0
    assert MAX_WEIGHT == 255.0


def test_bf16_scores_are_upcast():
    scores, mask = score_case(7, 16, 8)
    bf = torch.from_numpy(scores).to(torch.bfloat16)
    got = plan_weights(bf, torch.from_numpy(mask))
    assert torch.equal(got, plan_weights(bf.float(), torch.from_numpy(mask)))
    want = jax_plan_weights(jnp.asarray(scores).astype(jnp.bfloat16),
                            jnp.asarray(mask))
    assert parity.weights_close(got.numpy(), np.asarray(want))


def id_grids(seed, G=32, E=8, pool=12):
    rng = np.random.default_rng(seed)
    desired = np.full((G, E), -1, np.int32)
    current = np.full((G, E), -1, np.int32)
    for g in range(G):
        nd, nc = rng.integers(0, E + 1, 2)
        desired[g, :nd] = rng.choice(pool, nd, replace=False)
        current[g, :nc] = rng.choice(pool, nc, replace=False)
    current_w = rng.integers(0, 256, (G, E)).astype(np.int32)
    return desired, current, current_w


def test_membership_diff_matches_jax():
    for seed in range(3):
        desired, current, _ = id_grids(seed)
        got = tdiff.membership_diff(torch.from_numpy(desired),
                                    torch.from_numpy(current))
        want = jdiff.membership_diff(jnp.asarray(desired),
                                     jnp.asarray(current))
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))


def test_plan_observed_diff_matches_jax():
    for seed in range(3):
        desired, current, current_w = id_grids(10 + seed)
        got = tdiff.plan_observed_diff(torch.from_numpy(desired),
                                       torch.from_numpy(current),
                                       torch.from_numpy(current_w))
        want = jdiff.plan_observed_diff(jnp.asarray(desired),
                                        jnp.asarray(current),
                                        jnp.asarray(current_w))
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    assert tdiff.EMPTY == jdiff.EMPTY


def test_hash_ids_matches_jax():
    ids = [f"arn:aws:elasticloadbalancing:us-east-1:1:lb/net/lb{i}/x"
           for i in range(20)]
    got = tdiff.hash_ids(ids, device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(jdiff.hash_ids(ids)))


def test_hash_ids_runs_on_the_card_unless_asked(monkeypatch):
    """Like every entry point of the port, ``hash_ids`` defaults to the
    card and raises where there is none; the CPU only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        tdiff.hash_ids(["a"])
    assert tdiff.hash_ids(["a"], device="cpu").device.type == "cpu"
