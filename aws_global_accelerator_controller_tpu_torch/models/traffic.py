"""Traffic policy model: endpoint telemetry -> endpoint weights.

The counterpart of the JAX package's ``models/traffic.py``: a small MLP
(F=8 -> H=128 -> H=128 -> 1, bfloat16) scores each endpoint from its
telemetry, and the weight planner turns the scores of a group into
Global Accelerator weights.  Inputs are [G, E, F] features with a
[G, E] validity mask.  The model is plain methods over a params dict;
the params' device is where it runs.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..device import Device, resolve_device
from ..ops.cuda_mlp import dense_scores, forward_cuda, score_rows_cuda
from ..ops.weights import plan_weights
from .common import TrainableModel, make_optimizer, masked_ce_loss

Params = Dict[str, torch.Tensor]

FEATURE_DIM = 8
HIDDEN_DIM = 128


class Batch(NamedTuple):
    features: torch.Tensor  # [G, E, F] bfloat16
    mask: torch.Tensor      # [G, E] bool
    target: torch.Tensor    # [G, E] float32 target distribution


class TrafficPolicyModel(TrainableModel):
    """``serve`` picks the inference path of :meth:`forward`:

    - ``auto`` (default): kernel K3 (``ops.cuda_mlp.forward_cuda``:
      three matmuls, masked softmax and weight quantisation in one
      kernel) for CUDA inputs, :meth:`forward_dense` for CPU inputs;
    - ``dense``: always :meth:`forward_dense`;
    - ``fused``: always ``forward_cuda``, whose CPU version is the same
      math in plain PyTorch.

    Training (``train_step``, ``optimizer`` ``adam`` or ``flat_adam``)
    always takes the dense path, as in the reference: the kernel's
    integer weights have no gradient.
    """

    def __init__(self, feature_dim: int = FEATURE_DIM,
                 hidden_dim: int = HIDDEN_DIM, learning_rate: float = 1e-3,
                 serve: str = "auto", optimizer: str = "adam"):
        if serve not in ("auto", "dense", "fused"):
            raise ValueError(f"unknown serve impl {serve!r}")
        self.feature_dim = feature_dim
        self.hidden_dim = hidden_dim
        self.serve = serve
        self.optimizer = make_optimizer(optimizer, learning_rate)

    def init_params(self, generator: torch.Generator,
                    device: Device = "cuda") -> Params:
        """Normal weights scaled by 1/sqrt(fan_in), zero biases, bfloat16
        (the shapes and scales of the JAX model's init; torch's numbers
        differ from ``jax.random``'s for the same seed)."""
        dev = resolve_device(device)
        f, h = self.feature_dim, self.hidden_dim

        def normal(shape, fan_in):
            w = torch.randn(shape, generator=generator) / math.sqrt(fan_in)
            return w.to(torch.bfloat16).to(dev)

        def zeros(n):
            return torch.zeros((n,), dtype=torch.bfloat16, device=dev)

        return {"w1": normal((f, h), f), "b1": zeros(h),
                "w2": normal((h, h), h), "b2": zeros(h),
                "w3": normal((h, 1), h), "b3": zeros(1)}

    # -- forward --------------------------------------------------------

    def scores(self, params: Params, features: torch.Tensor) -> torch.Tensor:
        """[G, E, F] -> [G, E] float32 scores (dense matmuls)."""
        return dense_scores(params, features)

    def score_rows(self, params: Params, rows: torch.Tensor) -> torch.Tensor:
        """[N, F] packed endpoint rows -> [N] float32 scores: the fleet
        planner's scoring entry, one row per valid endpoint.  A row
        scores the same whatever else is in the batch (on the card the
        kernel's MLP guarantees it), which the incremental planner's
        bit-exactness against the full repack needs."""
        return score_rows_cuda(params, rows)

    def forward(self, params: Params, features: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """[G, E, F] + mask -> int32 GA weights [G, E] (see ``serve``)."""
        use_fused = (self.serve == "fused"
                     or (self.serve == "auto" and features.is_cuda))
        if use_fused:
            return forward_cuda(params, features, mask)
        return self.forward_dense(params, features, mask)

    def forward_dense(self, params: Params, features: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
        """The plain forward: dense scores, then ``plan_weights``."""
        return plan_weights(self.scores(params, features), mask)

    def loss(self, params: Params, batch: Batch) -> torch.Tensor:
        """Masked cross-entropy between the planned distribution and the
        target weight distribution (``models/common.py``)."""
        return masked_ce_loss(self.scores(params, batch.features),
                              batch.mask, batch.target)


def synthetic_batch(rng: np.random.Generator, groups: int = 64,
                    endpoints: int = 32, feature_dim: int = FEATURE_DIM,
                    device: Device = "cuda") -> Batch:
    """Random fleet telemetry with a plausible target (weight ~ capacity
    among healthy endpoints), drawn from numpy's ``rng``."""
    dev = resolve_device(device)
    features = rng.standard_normal(
        (groups, endpoints, feature_dim)).astype(np.float32)
    healthy = rng.random((groups, endpoints)) < 0.9
    mask = rng.random((groups, endpoints)) < 0.8
    raw = np.where(mask & healthy, np.exp(features[..., 0]), 0.0)
    denom = raw.sum(axis=-1, keepdims=True)
    target = np.where(denom > 0, raw / np.maximum(denom, 1e-9), 0.0)
    return Batch(
        features=torch.from_numpy(features).to(torch.bfloat16).to(dev),
        mask=torch.from_numpy(mask).to(dev),
        target=torch.from_numpy(target.astype(np.float32)).to(dev))
