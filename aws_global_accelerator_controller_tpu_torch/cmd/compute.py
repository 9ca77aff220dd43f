"""The port's compute commands: ``plan``.

``python -m aws_global_accelerator_controller_tpu_torch plan --groups N
--endpoints E --hidden H --seed S [--device cpu|cuda]
[--serve auto|dense|fused]`` plans Global Accelerator endpoint weights
for a synthetic fleet with the traffic MLP and prints one JSON object
with the keys of the JAX package's ``plan`` command, ``device`` in
place of ``rung``.  The params come from the port's own generator, so
the weights for a seed differ from the JAX package's.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.traffic import TrafficPolicyModel, synthetic_batch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m aws_global_accelerator_controller_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    plan = sub.add_parser(
        "plan", help="Plan GA endpoint weights for a fleet (JSON out)")
    plan.add_argument("--groups", type=int, default=8,
                      help="Endpoint groups in the synthetic fleet.")
    plan.add_argument("--endpoints", type=int, default=16,
                      help="Endpoints per group.")
    plan.add_argument("--hidden", type=int, default=128,
                      help="Model hidden width (the fused kernel takes "
                           "<= 128; use --serve dense above).")
    plan.add_argument("--seed", type=int, default=0,
                      help="Seed of the params and the synthetic "
                           "telemetry.")
    plan.add_argument("--device", default="cuda",
                      help="'cuda' (default) or 'cpu'.")
    plan.add_argument("--serve", choices=("auto", "dense", "fused"),
                      default="auto",
                      help="auto: the fused kernel on CUDA, dense on the "
                           "CPU.")
    return parser


def plan(args: argparse.Namespace) -> dict:
    """The ``plan`` command's result (what it prints)."""
    dev = resolve_device(args.device)
    model = TrafficPolicyModel(hidden_dim=args.hidden, serve=args.serve)
    params = model.init_params(torch.Generator().manual_seed(args.seed),
                               device=dev)
    batch = synthetic_batch(np.random.default_rng(args.seed + 1),
                            groups=args.groups, endpoints=args.endpoints,
                            device=dev)
    weights = model.forward(params, batch.features, batch.mask)
    return {
        "groups": args.groups,
        "endpoints": args.endpoints,
        "device": str(dev),
        # int weights in [0, 255], 0 on padded slots
        "weights": weights.cpu().tolist(),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "plan":
        json.dump(plan(args), sys.stdout)
        print()
    return 0
