"""The fused one-sweep flash backward (kernel K9) and its route, against
the JAX package, on the CPU.

- The route: the port's copy of the reference's gate
  (``ops/pallas_attention.py::_fused_bwd_eligible``, at the reference's
  own padded lengths from ``_resolve_blocks``) picks what the reference
  picks at every shape of a sweep that crosses each of its three
  limits: the 2 MiB dq budget, tp_q == tp_k, and 32 heads.
- The plain K9 against ``jax.vjp`` of the reference's flash attention at
  shapes where the reference runs ``_dqkv_kernel`` (interpret mode), at
  the reference's block, both on the same inputs made with numpy: dq,
  dk and dv within 2 bf16 ulps of the magnitude each sums
  (``parity.attention_close`` of ``flash_attention_bwd_magnitude``).
- The plain K9 against the plain two-sweep backward (K7, K8) on the
  same inputs: bit for bit (the same products in the same f32 order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_global_accelerator_controller_tpu.ops import pallas_attention as ref
from aws_global_accelerator_controller_tpu_torch import parity
from aws_global_accelerator_controller_tpu_torch.ops import (
    cuda_attention as ca,
)

TS = [1, 63, 64, 65, 1024, 1100, 2048, 2049, 4096, 4097, 8192]
DS = [16, 32, 128, 160, 256, 300]
HS = [1, 8, 32, 33, 8192]


def _reference_route(t, h, d):
    block_q, block_k = ref._resolve_blocks(t, t, None, None)
    tp_q = -(-t // block_q) * block_q
    tp_k = -(-t // block_k) * block_k
    dp = -(-d // ref._LANE) * ref._LANE
    return ref._fused_bwd_eligible(tp_q, tp_k, dp, h)


def test_gate_constants_are_the_reference_s():
    assert ca._FUSED_BWD_DQ_BYTES == ref._FUSED_BWD_DQ_BYTES
    assert ca._FUSED_BWD_MAX_HEADS == ref._FUSED_BWD_MAX_HEADS
    assert (ca._LANE, ca._SUBLANE) == (ref._LANE, ref._SUBLANE)


@pytest.mark.parametrize("t", TS)
def test_route_is_the_reference_s(t):
    """At every (D, heads) of the sweep: the reference's blocks, its
    route, and its ``backward_hw_matmul_factor``."""
    assert ca._reference_blocks(t) == ref._resolve_blocks(t, t, None, None)
    for d in DS:
        for h in HS:
            want = _reference_route(t, h, d)
            assert ca.fused_bwd_route(t, h, d) == want, (t, d, h)
            assert ca.backward_hw_matmul_factor(t, h, d) == \
                ref.backward_hw_matmul_factor(t, h, d) == (
                    3.5 if want else 4.5), (t, d, h)


def test_route_where_the_port_s_own_block_would_differ():
    """D = 300, T = 1100: the reference pads T to 2048 (its 1024 block),
    3 MiB of dq, so it takes the two sweeps, though at the port's 64-row
    block the dq would take 1.7 MiB."""
    assert ref._resolve_blocks(1100, 1100, None, None) == (1024, 1024)
    assert not ca.fused_bwd_route(1100, 8, 300)
    assert ca.fused_bwd_route(1024, 8, 300)
    assert ca.fused_bwd_route(4096, 32, 128)
    assert not ca.fused_bwd_route(4097, 32, 128)


def _bf16_pair(rng, shape):
    a = jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                    jnp.bfloat16)
    return a, torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [16, 32, 40])
@pytest.mark.parametrize("T", [64, 72, 130])
@pytest.mark.parametrize("S", [8, 32])
def test_dqkv_plain_matches_jax_fused_vjp(S, T, D, causal):
    """``jax.vjp`` of the reference's flash attention runs its fused
    ``_dqkv_kernel`` at these shapes; the plain K9, at the reference's
    block on the plain K6b's stats, gives the same dq, dk and dv within
    2 bf16 ulps of what each sums, and equals the plain two-sweep
    backward bit for bit."""
    rng = np.random.default_rng(S * T + D + causal)
    (jq, q), (jk, k), (jv, v), (jdo, do) = (_bf16_pair(rng, (T, S, D))
                                            for _ in range(4))
    assert _reference_route(T, S, D) and ca.fused_bwd_route(T, S, D)
    block, _ = ref._resolve_blocks(T, T, None, None)
    _, vjp = jax.vjp(lambda *x: ref.flash_attention(*x, causal=causal),
                     jq, jk, jv)
    o, m, l = ca.flash_attention_stats_plain(q, k, v, causal, block)
    dvec = ca.attention_dvec(o, do)
    got = ca.flash_bwd_dqkv_plain(q, k, v, do, m, l, dvec, causal, block,
                                  block)
    mags = ca.flash_attention_bwd_magnitude(q, k, v, o, do, m, l, causal)
    for name, g, w, mag in zip(("dq", "dk", "dv"), got, vjp(jdo), mags):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == (T, S, D)
        assert parity.attention_close(
            g.float().numpy(), np.asarray(w.astype(jnp.float32)),
            mag.numpy()), name
    sweeps = ca.flash_attention_bwd_plain(q, k, v, o, do, m, l, causal,
                                          block, block)
    assert all(torch.equal(a, b) for a, b in zip(got, sweeps))


@pytest.mark.parametrize("S,fused", [(32, True), (33, False)])
def test_backward_takes_the_reference_route_on_the_cpu(monkeypatch, S,
                                                       fused):
    """``flash_attention_bwd`` on CPU tensors runs the plain K9 where the
    gate holds and the plain K7 and K8 where it does not."""
    calls = []
    for name in ("flash_bwd_dqkv_plain", "flash_bwd_dq_plain",
                 "flash_bwd_dkv_plain"):
        real = getattr(ca, name)
        monkeypatch.setattr(ca, name, lambda *a, _f=real, _n=name, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    rng = np.random.default_rng(S)
    q, k, v, do = (_bf16_pair(rng, (64, S, 16))[1] for _ in range(4))
    o, m, l = ca.flash_attention_stats(q, k, v)
    grads = ca.flash_attention_bwd(q, k, v, o, do, m, l)
    assert calls == (["flash_bwd_dqkv_plain"] if fused
                     else ["flash_bwd_dq_plain", "flash_bwd_dkv_plain"])
    assert all(g.shape == (64, S, 16) for g in grads)
