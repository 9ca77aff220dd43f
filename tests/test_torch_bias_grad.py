"""The bias gradient of the port's ``bf16_linear`` against ``jax.vjp``, on
the CPU, bit for bit.

The reference adds a bf16 bias to a bf16 product (``models/traffic.py``,
``models/temporal.py``'s dense head); the transpose of that add is a bf16
``reduce_sum`` of the cotangent over the leading axes, which XLA's CPU
backend takes as f32 adds each rounded to bf16, in windows of 32 a
reduced axis while one exceeds 32, then row-major.  The port's bias
gradient on CPU tensors (``ops/cuda_mlp.py::xla_cpu_bf16_sum``) takes
the same order, so the two agree in every bit; autograd's own sum (f32,
rounded once) does not (``test_xla_order_is_not_autograds_sum``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_global_accelerator_controller_tpu_torch.ops.cuda_mlp import (
    bf16_linear,
    xla_cpu_bf16_sum,
)

#: [..., H] shapes of ``h``: one reduced axis (the MLP's rows) and two
#: (the temporal head's [T, S]), each below, at and past one or two
#: levels of 32-wide windows
SHAPES = [(2560, 1), (40, 32), (33, 5), (8192, 2), (2, 17, 8),
          (64, 40, 1), (100, 37, 3), (1100, 40, 4), (64, 40, 32)]


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int16).numpy()


def _jax_bias_grad(h, b, ct) -> np.ndarray:
    _, vjp = jax.vjp(lambda h, b: h + b, *(jnp.asarray(a, jnp.bfloat16)
                                            for a in (h, b)))
    gb = vjp(jnp.asarray(ct, jnp.bfloat16))[1]
    return np.asarray(gb).view(np.int16)


def _port_bias_grad(h, b, ct) -> torch.Tensor:
    th = torch.from_numpy(h).to(torch.bfloat16)
    tb = torch.from_numpy(b).to(torch.bfloat16).requires_grad_(True)
    w = torch.eye(th.shape[-1], dtype=torch.bfloat16)
    bf16_linear(th, w, tb).backward(torch.from_numpy(ct).to(torch.bfloat16))
    return tb.grad


def _case(shape, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    # terms of two scales, so that small ones fall below a large sum's ulp
    ct = (rng.standard_normal(shape)
          * rng.choice([1.0, 1e-3], shape)).astype(np.float32)
    return h, b, ct


def test_smallest_input_matches_jax():
    """h bf16 [3, 1], cotangent [1, 2^-8, 2^-8]: each add rounds back to
    1.0 in bf16, where one f32 sum gives 1.0078125."""
    h = np.zeros((3, 1), np.float32)
    b = np.zeros(1, np.float32)
    ct = np.array([[1.0], [2.0 ** -8], [2.0 ** -8]], np.float32)
    got = _port_bias_grad(h, b, ct)
    assert float(got[0]) == 1.0
    assert np.array_equal(_bits(got), _jax_bias_grad(h, b, ct))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bias_grad_matches_jax_bit_for_bit(shape):
    h, b, ct = _case(shape, sum(shape))
    assert np.array_equal(_bits(_port_bias_grad(h, b, ct)),
                          _jax_bias_grad(h, b, ct))


def test_bf16_linear_grads_match_jax_vjp():
    """Through the whole ``x @ w + b`` of the MLP's first layer: the bias
    gradient bit for bit, and x's and w's as XLA's bf16 dots give them."""
    rng = np.random.default_rng(5)
    x, w, b, ct = (rng.standard_normal(s).astype(np.float32)
                   for s in ((40, 8), (8, 32), (32,), (40, 32)))
    jx, jw, jb, jct = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b, ct))
    _, vjp = jax.vjp(lambda x, w, b: x @ w + b, jx, jw, jb)
    want = vjp(jct)
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
              for a in (x, w, b)]
    bf16_linear(*leaves).backward(torch.from_numpy(ct).to(torch.bfloat16))
    for leaf, ref in zip(leaves, want):
        assert np.array_equal(_bits(leaf.grad), np.asarray(ref).view(np.int16))


def test_xla_order_is_not_autograds_sum():
    """The case this order exists for: at these shapes autograd's f32 sum
    differs from the reference in some bits, the port's order in none."""
    differ = 0
    for shape in SHAPES:
        h, b, ct = _case(shape, sum(shape))
        want = _jax_bias_grad(h, b, ct)
        g = torch.from_numpy(ct).to(torch.bfloat16)
        lead = tuple(range(g.dim() - 1))
        differ += int((_bits(g.sum(lead)) != want).sum())
        assert np.array_equal(_bits(xla_cpu_bf16_sum(g, lead)), want)
    assert differ > 0

