"""The port's ring attention against the JAX package's, on the CPU.

- Kernel K6b-ring's plain version (``flash_attention_stats_ring_plain``)
  against the reference's public ``flash_attention_stats``, f32 q against
  bf16 k and v.  On the CPU the reference takes its pallas-interpret rung
  (``compat/capability.py:338-351``): the Pallas ``_stats_kernel`` itself
  runs in interpret mode (``test_reference_runs_the_pallas_kernel``
  asserts that rung), rounding p to v's dtype as the port does.
- ``make_ring_attention`` (contiguous; einsum and flash local; seq 2 and
  4; forward and gradients) and ``make_last_attention`` (forward and
  gradients) on gloo ranks, against the reference's over a JAX mesh of
  the same shape (the 8 virtual CPU devices of ``tests/conftest.py``) and
  against the dense oracles on the gathered inputs.  One world of 4 rank
  processes runs every scenario (``torch_ranks.py``); the ranks import no
  JAX, the JAX side runs here.

Tolerances, each stated where it is used.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from aws_global_accelerator_controller_tpu.compat import registry
from aws_global_accelerator_controller_tpu.compat.capability import (
    RUNG_INTERPRET,
)
from aws_global_accelerator_controller_tpu.models.temporal import (
    attention_last_reference as jax_last_reference,
)
from aws_global_accelerator_controller_tpu.ops.pallas_attention import (
    flash_attention_stats as jax_flash_attention_stats,
)
from aws_global_accelerator_controller_tpu.parallel.ring_attention import (
    attention_reference as jax_attention_reference,
    make_last_attention as jax_make_last_attention,
    make_ring_attention as jax_make_ring_attention,
)
from aws_global_accelerator_controller_tpu_torch import parity
from aws_global_accelerator_controller_tpu_torch.ops.cuda_attention import (
    BLOCK_K,
    flash_attention_stats_ring,
    flash_attention_stats_ring_plain,
)
from aws_global_accelerator_controller_tpu_torch.parallel.ring_attention \
    import attention_reference
from torch_ranks import run_world

WORLD = 4


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(torch.bfloat16)


def _np(x) -> np.ndarray:
    """A torch tensor or a JAX array as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _jax(x: torch.Tensor):
    """A bf16 or f32 tensor as the JAX array of the same values and dtype."""
    arr = jnp.asarray(x.float().numpy())
    return arr.astype(jnp.bfloat16) if x.dtype == torch.bfloat16 else arr


# ---------------------------------------------------------------------------
# the kernel's plain version against the reference's stats kernel
# ---------------------------------------------------------------------------


def test_reference_runs_the_pallas_kernel():
    """Off the TPU the reference's ``flash_attention_stats`` takes the
    pallas-interpret rung: the Pallas kernel, interpreted, not the dense
    stats (``_dense_reference_stats``)."""
    assert registry.attention_rung() == RUNG_INTERPRET


@pytest.mark.parametrize("D", [16, 20])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk", [(64, 64), (128, 128), (64, 128),
                                   (128, 64)])
def test_ring_stats_plain_matches_the_reference_kernel(tq, tk, causal, D):
    """o / l, m and l of the plain K6b-ring against the reference's
    ``flash_attention_stats`` on the same f32 q and bf16 k, v.

    Both round p to bf16 against the running max, over K blocks of
    :data:`BLOCK_K` here and ``_resolve_blocks``' (T rounded to 16, at
    most 1024) there, so o and l may differ in their last ulps: o / l
    within 2 bf16 ulps of the magnitude it averages (the same attention
    over |v|, ``parity.attention_close``), l within 1e-5 relative (f32
    sums of the same p in another order).  m is one row max of s: the f32
    product of f32 q' and bf16 k in another summation order moves it by
    at most D f32 ulps of the largest |q'| . |k| (2**-24 D of it);
    rounding q' to bf16 would move it by about 2**-9 of |s|, hundreds of
    times that.
    """
    rng = np.random.default_rng(tq * 7 + tk + D + int(causal))
    H = 3
    q = rng.standard_normal((H, tq, D), dtype=np.float32)
    k, v = (_bf16(rng.standard_normal((H, tk, D), dtype=np.float32))
            for _ in range(2))
    want = [np.asarray(x, np.float64) for x in jax_flash_attention_stats(
        jnp.asarray(q), _jax(k), _jax(v), causal=causal)]
    qt = torch.from_numpy(q)
    got = [x.double().numpy() for x in flash_attention_stats_ring(
        qt, k, v, causal)]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert got[0].dtype == np.float64
    o, m, l = got
    wo, wm, wl = want
    mag_o, _, mag_l = flash_attention_stats_ring_plain(qt, k, v.abs(),
                                                       causal, BLOCK_K)
    mag = (mag_o / mag_l[..., None]).double().numpy()
    assert parity.attention_close(o / l[..., None], wo / wl[..., None], mag)
    np.testing.assert_allclose(l, wl, rtol=1e-5, atol=0)
    s_mag = (qt.abs() * D ** -0.5) @ k.float().abs().transpose(1, 2)
    m_tol = D * 2.0 ** -24 * float(s_mag.max())
    assert np.abs(m - wm).max() <= m_tol
    # the contract: q' is not rounded to bf16, which moves m past m_tol
    s = ((qt * D ** -0.5).to(torch.bfloat16).float()
         @ k.float().transpose(1, 2))
    if causal:
        s = torch.where(torch.ones(tq, tk, dtype=torch.bool).tril(), s,
                        -1e30)
    assert np.abs(s.amax(dim=-1).double().numpy() - wm).max() > m_tol


def test_ring_stats_plain_is_its_own_wrapper_on_the_cpu():
    """On CPU tensors the wrapper runs the plain version at BLOCK_K, which
    takes any float q (rounding none of it) and returns f32."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 70, 20), dtype=np.float32))
    k, v = (_bf16(rng.standard_normal((2, 90, 20), dtype=np.float32))
            for _ in range(2))
    got = flash_attention_stats_ring(q, k, v, causal=True)
    want = flash_attention_stats_ring_plain(q, k, v, True, BLOCK_K)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [x.dtype for x in got] == [torch.float32] * 3
    assert tuple(got[0].shape) == (2, 70, 20)


# ---------------------------------------------------------------------------
# the ring and the last-query merge on gloo ranks
# ---------------------------------------------------------------------------

# (name, mesh, local, causal, T, H, D): "seq" is a 1-D ring of every rank;
# "data_seq" is data 2 x seq 2, the heads split over data
RING_CASES = [
    ("seq4_einsum", "seq", "einsum", True, 64, 3, 16),
    ("seq4_flash", "seq", "flash", True, 64, 3, 16),
    ("seq2_einsum", "data_seq", "einsum", True, 64, 6, 16),
    ("seq2_flash", "data_seq", "flash", True, 64, 6, 16),
    ("seq2_flash_full", "data_seq", "flash", False, 64, 6, 20),
]
LAST_CASES = [("last_seq4", "seq", 32, 8, 16),
              ("last_seq2", "data_seq", 32, 8, 16)]


def _jax_mesh(kind: str):
    devs = np.asarray(jax.devices()[:WORLD])
    if kind == "seq":
        return Mesh(devs, ("seq",)), None
    return Mesh(devs.reshape(2, 2), ("data", "seq")), "data"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every scenario on one world of 4 gloo ranks: (inputs, results)."""
    rng = np.random.default_rng(0)
    ring, last = [], []
    for name, mesh, local, causal, T, H, D in RING_CASES:
        q, k, v, w = (torch.from_numpy(rng.standard_normal(
            (T, H, D), dtype=np.float32)) for _ in range(4))
        # bf16 as the model runs it, and f32 (exact against the oracle)
        for suffix, dt in (("", torch.bfloat16), ("_f32", torch.float32)):
            ring.append(dict(name=name + suffix, mesh=mesh, local=local,
                             causal=causal, q=q.to(dt), k=k.to(dt),
                             v=v.to(dt), w=w))
    for name, mesh, T, H, D in LAST_CASES:
        k, v = (torch.from_numpy(rng.standard_normal((T, H, D),
                                                     dtype=np.float32))
                for _ in range(2))
        q, w = (torch.from_numpy(rng.standard_normal((H, D),
                                                     dtype=np.float32))
                for _ in range(2))
        last.append(dict(name=name, mesh=mesh, q=q, k=k, v=v, w=w))
    inputs = {"ring": ring, "last": last}
    results = run_world("ring", WORLD, inputs,
                        tmp_path_factory.mktemp("ring_world"))
    return inputs, results


def _assemble(results, case, key, shape, rows=True):
    """A global [T, H, D] (``rows``) or [H, D] array from every rank's
    block of ``key``; q_last's gradient, which every seq rank holds a
    share of, is summed over the seq ranks."""
    out = np.zeros(shape)
    for res in results:
        c = res["coords"][case["mesh"]]
        blk = res[case["name"]][key].float().numpy()
        if rows:
            t = blk.shape[0]
            h = blk.shape[1]
            out[c["seq"] * t:(c["seq"] + 1) * t,
                c.get("data", 0) * h:(c.get("data", 0) + 1) * h] = blk
        else:
            h = blk.shape[0]
            out[c.get("data", 0) * h:(c.get("data", 0) + 1) * h] += blk
    return out


@pytest.mark.parametrize("name", [c[0] for c in RING_CASES])
def test_ring_matches_the_reference_ring(world, name):
    """The port's ring on gloo ranks against the reference's
    ``make_ring_attention`` on a JAX mesh of the same shape (same local
    attend): o within 2 bf16 ulps of the magnitude it averages
    (``parity.attention_close``: both round o to bf16 from f32 sums in
    other orders, and the flash local rounds p); dq, dk, dv, f32 einsums
    rounded to bf16 on both sides, within 2 bf16 ulps of the largest
    |gradient| of their head (the sums cancel, so an element's own ulp
    is no yardstick)."""
    inputs, results = world
    case = next(c for c in inputs["ring"] if c["name"] == name)
    q, k, v, w = (case[x] for x in ("q", "k", "v", "w"))
    jmesh, head_axis = _jax_mesh(case["mesh"])
    fn = jax_make_ring_attention(jmesh, "seq", causal=case["causal"],
                                 local=case["local"], head_axis=head_axis)
    want_o, vjp = jax.vjp(fn, _jax(q), _jax(k), _jax(v))
    want_grads = vjp(_jax(w).astype(jnp.bfloat16))
    shape = tuple(q.shape)
    got_o = _assemble(results, case, "o", shape)
    mag = attention_reference(q, k, v.abs(), causal=case["causal"]).numpy()
    assert parity.attention_close(got_o, _np(want_o), mag)
    for key, want in zip(("dq", "dk", "dv"), want_grads):
        got = _assemble(results, case, key, shape)
        want = _np(want)
        head_max = np.abs(want).max(axis=(0, 2), keepdims=True)
        assert np.all(np.abs(got - want)
                      <= 2 * parity.bf16_ulp(head_max)), key


@pytest.mark.parametrize("name", [c[0] for c in RING_CASES])
def test_ring_matches_dense_attention(world, name):
    """The ring on f32 inputs against the dense oracle on the gathered
    inputs, o and dq, dk, dv against dense autograd, within rtol 1e-4,
    atol 1e-5: both are f32 throughout (with f32 v the flash local rounds
    p to f32, that is not at all), the ring folding blocks with the
    online softmax.  (On bf16 inputs the ring, like the reference's,
    rounds o and the cotangent to bf16 and takes dvec from that o; its
    gradients then move by a few 1e-3 from dense f32 autograd, so the
    bf16 runs are held to the reference's ring above.)"""
    inputs, results = world
    case = next(c for c in inputs["ring"] if c["name"] == name + "_f32")
    leaves = [case[x].clone().requires_grad_(True) for x in ("q", "k", "v")]
    want = attention_reference(*leaves, causal=case["causal"])
    (want * case["w"]).sum().backward()
    shape = tuple(case["q"].shape)
    np.testing.assert_allclose(_assemble(results, case, "o", shape),
                               want.detach().numpy(), rtol=1e-4, atol=1e-5)
    for key, leaf in zip(("dq", "dk", "dv"), leaves):
        np.testing.assert_allclose(_assemble(results, case, key, shape),
                                   leaf.grad.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    # the oracle the reference's tests use agrees with the port's
    np.testing.assert_allclose(
        want.detach().numpy(),
        _np(jax_attention_reference(*(_jax(case[x]) for x in "qkv"),
                                    causal=case["causal"])),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", [c[0] for c in LAST_CASES])
def test_last_attention_matches_the_reference(world, name):
    """``make_last_attention`` on gloo ranks against the reference's over
    a JAX mesh of the same shape and against the dense last-row oracle:
    the row within rtol 1e-5, atol 1e-6 (the reference's own tolerance,
    ``tests/test_sharded_temporal.py:188``), identical on every seq rank.
    Gradients of sum(out * w) against the reference's ``jax.vjp`` within
    rtol 1e-4, atol 1e-6: each seq rank counts the loss 1 / n_seq times
    and the all-gather's backward sums every rank's gradient into the
    owner's stats, so a backward that dropped the sum, or a loss counted
    n_seq times, is off by a factor of n_seq."""
    inputs, results = world
    case = next(c for c in inputs["last"] if c["name"] == name)
    q, k, v, w = (case[x] for x in ("q", "k", "v", "w"))
    jmesh, head_axis = _jax_mesh(case["mesh"])
    fn = jax_make_last_attention(jmesh, "seq", head_axis)
    want, vjp = jax.vjp(fn, *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want_grads = [_np(g) for g in vjp(jnp.asarray(w.numpy()))]
    H, D = q.shape
    outs = {}
    for res in results:
        c = res["coords"][case["mesh"]]
        outs.setdefault(c.get("data", 0), []).append(
            res[name]["out"].numpy())
    for rows in outs.values():
        assert all(np.array_equal(rows[0], r) for r in rows)
    got = np.concatenate([outs[d][0] for d in sorted(outs)])
    np.testing.assert_allclose(got, _np(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got, _np(jax_last_reference(*(jnp.asarray(x.numpy())
                                      for x in (q, k, v)))),
        rtol=1e-5, atol=1e-6)
    got_grads = [_assemble(results, case, "dq", (H, D), rows=False),
                 _assemble(results, case, "dk", tuple(k.shape)),
                 _assemble(results, case, "dv", tuple(v.shape))]
    for key, g, wg in zip(("dq", "dk", "dv"), got_grads, want_grads):
        np.testing.assert_allclose(g, wg, rtol=1e-4, atol=1e-6,
                                   err_msg=key)
