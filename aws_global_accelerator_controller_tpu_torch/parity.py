"""The tolerances the port is held to, against its kernels' plain
versions on the card and against the JAX package on the CPU.

- Ids, masks, memberships and splices are exact.
- Integer weights may differ by one unit at the x255 rounding boundary,
  where another exp or summation order moves the product across .5, on
  at most 0.5% of the cells: the drift the JAX package accepts between
  its own fused kernel and its XLA path (``ops/pallas_mlp.py:19-25``).
- Float scores agree within 2 bf16 ulps (each matmul rounds to bf16, so
  a different f32 summation order can move a score by one bf16 step).
- Attention outputs (kernel K6a) agree within 2 bf16 ulps of the
  magnitude they average, sum_j w_j |v_j| (:func:`attention_close`), not
  of themselves: p is rounded to bf16 before p.v, and another f32 order
  of the scores can round one p the other way (a change of one bf16 ulp
  of w_j |v_j|); where the sum cancels to near zero that is many ulps of
  the output but never more than one of the magnitude.
- Gradients through the flash kernels agree with dense autograd through
  the attention oracle within rtol 5e-2, atol 5e-3 (:func:`grads_close`):
  the JAX package's own flash-vs-dense gradient tolerance
  (``tests/test_temporal_model.py:121-142``).  The flash backward rounds
  p and ds to bf16 before its products, dense autograd does not.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

MAX_WEIGHT_DIFF = 1
MAX_MISMATCH_FRAC = 0.005
MAX_SCORE_ULPS = 2
GRAD_RTOL = 5e-2
GRAD_ATOL = 5e-3


def weight_mismatch(got, want) -> Tuple[int, float]:
    """(max |got - want|, fraction of cells that differ) of two integer
    weight arrays."""
    d = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    if d.size == 0:
        return 0, 0.0
    return int(d.max()), float((d > 0).mean())


def weights_close(got, want) -> bool:
    err, frac = weight_mismatch(got, want)
    return err <= MAX_WEIGHT_DIFF and frac <= MAX_MISMATCH_FRAC


def bf16_ulp(x) -> np.ndarray:
    """The spacing of bfloat16 numbers (8-bit significand) at ``x``."""
    a = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def scores_close(got, want, ulps: int = MAX_SCORE_ULPS,
                 scale=None) -> bool:
    """|got - want| <= ``ulps`` bf16 ulps of |want| elementwise, or of
    ``scale`` (broadcast) where that is larger."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ref = np.abs(want)
    if scale is not None:
        ref = np.maximum(ref, np.abs(np.asarray(scale, np.float64)))
    return bool(np.all(np.abs(got - want) <= ulps * bf16_ulp(ref)))


def attention_close(got, want, magnitude, ulps: int = MAX_SCORE_ULPS) -> bool:
    """Attention outputs within ``ulps`` bf16 ulps of ``magnitude``, the
    same attention over |v| (sum_j w_j |v_j|)."""
    return scores_close(got, want, ulps, scale=magnitude)


def grad_error(got, want) -> float:
    """max |got - want| / (GRAD_ATOL + GRAD_RTOL |want|): <= 1 passes."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if want.size == 0:
        return 0.0
    return float((np.abs(got - want)
                  / (GRAD_ATOL + GRAD_RTOL * np.abs(want))).max())


def grads_close(got, want) -> bool:
    """A gradient within rtol :data:`GRAD_RTOL`, atol :data:`GRAD_ATOL`."""
    return grad_error(got, want) <= 1.0
