"""Training machinery the model families share: the masked cross-entropy,
the two Adam optimizers and the train step (the JAX package's
``models/common.py``).

The optimizers are plain functions on tensors under ``torch.no_grad()``
and reproduce the reference's arithmetic, bit for bit on the CPU:

- :func:`adam` is ``optax.adam`` (optax 0.2.6, ``scale_by_adam`` then
  ``scale_by_learning_rate``): moments in the params' dtype (bf16 here),
  each update rounded to it, the Python constants rounded to it first as
  JAX's weak types are; the bias correction 1 - b**count computed in f32
  and cast to the moment's dtype before the division; m / (sqrt(v) +
  eps) scaled by -lr; and ``optax.apply_updates``, (p + u) in p's dtype.
- :func:`flat_adam` is the reference's ``flat_adam`` (``:31-92``): f32
  moments over one vector raveled in ``ravel_pytree``'s order (dict keys
  sorted), the step cast to the grads' dtype.

How XLA on the CPU computes, and so how these functions do:

- every elementwise op runs in float32 (a bf16 op on f32 copies of its
  operands, rounded once to bf16), with subnormal operands read as zero
  and subnormal results flushed to zero (:func:`_flush` after each op;
  the grads and params are flushed on the way in);
- sqrt is correctly rounded; torch's float32 sqrt on the CPU is not
  always (one ulp off on about 0.6% of values in [0, 1e-3)), so the sqrt
  is taken in float64 and rounded to float32, which is exact;
- ``b ** count`` is the C library's ``powf`` (:func:`_bias`).

Divisions divide by a tensor, never by a Python number (the CUDA kernel
for a scalar divisor multiplies by its reciprocal, which is not the
reference's division).  The same code runs on the card.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from ..ops.weights import masked_softmax

Params = Dict[str, torch.Tensor]


def masked_ce_loss(scores: torch.Tensor, mask: torch.Tensor,
                   target: torch.Tensor) -> torch.Tensor:
    """Cross-entropy between masked_softmax(scores) and the target weight
    distribution, averaged over groups with >= 1 valid endpoint.

    scores and target are [..., G, E], mask [G, E] (or broadcast to
    them); leading dims are batch dims with one loss each, so [G, E]
    inputs give a scalar and [T, G, E] inputs the per-step losses [T].
    """
    p = masked_softmax(scores, mask)
    ce = -torch.where(mask, target * torch.log(p + 1e-9), 0.0).sum(dim=-1)
    valid = mask.any(dim=-1).expand_as(ce)
    return (torch.where(valid, ce, 0.0).sum(dim=-1)
            / valid.sum(dim=-1).clamp_min(1))


class Optimizer(NamedTuple):
    """An optax-style pair: ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, state)``."""
    init: Callable
    update: Callable


class AdamState(NamedTuple):
    count: int
    mu: Params      # first moment, the params' dtype
    nu: Params      # second moment, the params' dtype


class FlatAdamState(NamedTuple):
    count: int
    mu: torch.Tensor      # first moment, f32, one raveled vector
    nu: torch.Tensor      # second moment, f32, one raveled vector


def _const(x: float, like: torch.Tensor) -> float:
    """The Python constant ``x`` as a number of ``like``'s dtype (JAX
    converts a weak-typed scalar to the array's dtype before the op)."""
    return float(torch.tensor(x, dtype=like.dtype))


_TINY = float(np.finfo(np.float32).tiny)


def _flush(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) with its subnormal values replaced by a zero of the
    same sign, as XLA's CPU backend flushes denormals."""
    return torch.where(x.abs() < _TINY, x * 0, x)


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An op's float32 result, flushed, rounded to ``dtype`` and carried
    on in float32 (exact) for the next op."""
    return _flush(x).to(dtype).float()


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt of a float32 tensor, through
    float64 (a square root rounded twice, 53 then 24 bits, is rounded
    once)."""
    return torch.sqrt(x.double()).float()


def _divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d (float32) as a true division by a 0-dim tensor on x's
    device."""
    return x / x.new_full((), d)


def _bias(decay: float, count: int) -> float:
    """1 - decay**count in float32.  numpy's float32 scalar power is the
    C library's ``powf``, which is what XLA's CPU backend calls for a
    float32 pow (its vectorized array power is not, and differs in the
    last bit at some counts)."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """``optax.adam``: per-param moments in the params' dtype."""

    def init(params: Params) -> AdamState:
        def zeros():
            return {k: torch.zeros_like(p) for k, p in params.items()}
        return AdamState(0, zeros(), zeros())

    @torch.no_grad()
    def update(grads: Params, state: AdamState, params=None):
        count = state.count + 1
        c1, c2 = _bias(b1, count), _bias(b2, count)
        mu, nu, updates = {}, {}, {}
        for k, grad in grads.items():
            rnd = functools.partial(_rounded, dtype=grad.dtype)
            g = _flush(grad.float())
            m = rnd(rnd(_const(1 - b1, grad) * g)
                    + rnd(_const(b1, grad) * state.mu[k].float()))
            v = rnd(rnd(_const(1 - b2, grad) * rnd(g * g))
                    + rnd(_const(b2, grad) * state.nu[k].float()))
            m_hat = rnd(_divide(m, _const(c1, grad)))
            v_hat = rnd(_divide(v, _const(c2, grad)))
            u = rnd(m_hat / rnd(rnd(_sqrt(v_hat)) + _const(eps, grad)))
            updates[k] = rnd(_const(-learning_rate, grad) * u).to(grad.dtype)
            mu[k], nu[k] = m.to(grad.dtype), v.to(grad.dtype)
        return updates, AdamState(count, mu, nu)

    return Optimizer(init, update)


def ravel(tree: Params) -> torch.Tensor:
    """One vector of the values of ``tree``, keys sorted (the order of
    ``jax.flatten_util.ravel_pytree`` on a dict)."""
    return torch.cat([tree[k].reshape(-1) for k in sorted(tree)])


def unravel(flat: torch.Tensor, like: Params) -> Params:
    """The inverse of :func:`ravel` onto the shapes of ``like``."""
    out, i = {}, 0
    for k in sorted(like):
        n = like[k].numel()
        out[k] = flat[i:i + n].reshape(like[k].shape)
        i += n
    return out


def flat_adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8) -> Optimizer:
    """Adam over one raveled f32 vector (the reference's ``flat_adam``)."""

    def init(params: Params) -> FlatAdamState:
        flat = ravel(params)
        return FlatAdamState(0, torch.zeros(flat.shape, device=flat.device),
                             torch.zeros(flat.shape, device=flat.device))

    @torch.no_grad()
    def update(grads: Params, state: FlatAdamState, params=None):
        flat_g = ravel(grads)
        g = _flush(flat_g.float())
        count = state.count + 1
        mu = _flush(_flush(b1 * state.mu) + _flush((1.0 - b1) * g))
        nu = _flush(_flush(b2 * state.nu)
                    + _flush((1.0 - b2) * _flush(g * g)))
        mu_hat = _flush(_divide(mu, _bias(b1, count)))
        nu_hat = _flush(_divide(nu, _bias(b2, count)))
        step = _flush(_flush(-learning_rate * mu_hat)
                      / _flush(_sqrt(nu_hat) + eps))
        return (unravel(step.to(flat_g.dtype), grads),
                FlatAdamState(count, mu, nu))

    return Optimizer(init, update)


def make_optimizer(name: str, learning_rate: float) -> Optimizer:
    """``"adam"`` (per-param state) or ``"flat_adam"`` (one raveled
    vector), as the reference's ``make_optimizer``."""
    if name == "flat_adam":
        return flat_adam(learning_rate)
    if name == "adam":
        return adam(learning_rate)
    raise ValueError(f"unknown optimizer {name!r}")


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> Params:
    """``optax.apply_updates``: (p + u) in p's dtype, computed in float32
    on flushed operands and flushed (the optimizers' arithmetic)."""
    return {k: _flush(_flush(p.float()) + _flush(updates[k].float()))
            .to(torch.promote_types(p.dtype, updates[k].dtype)).to(p.dtype)
            for k, p in params.items()}


def value_and_grad(loss_fn: Callable, params: Params, *data):
    """(loss at ``params``, its gradient with respect to every param):
    zeros for a param the loss does not reach, as ``jax.grad`` gives."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        loss = loss_fn(leaves, *data)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(params.items(), grads)}


class TrainableModel:
    """Optimizer plumbing over a subclass's ``loss(params, *data)``; the
    subclass sets ``self.optimizer`` (:func:`make_optimizer`)."""

    optimizer: Optimizer

    def loss(self, params: Params, *data) -> torch.Tensor:
        raise NotImplementedError

    def init_opt_state(self, params: Params):
        return self.optimizer.init(params)

    def train_step_with(self, loss_fn: Callable, params: Params, opt_state,
                        *data):
        """(new params, new optimizer state, loss at ``params``): the one
        optimizer-update implementation every family shares."""
        loss, grads = value_and_grad(loss_fn, params, *data)
        updates, opt_state = self.optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    def train_step(self, params: Params, opt_state, *data):
        return self.train_step_with(self.loss, params, opt_state, *data)
