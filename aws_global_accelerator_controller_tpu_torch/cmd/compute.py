"""The port's compute commands: ``plan`` and ``eval``.

``python -m aws_global_accelerator_controller_tpu_torch plan [--model
mlp|temporal] --groups N --endpoints E --hidden H [--window T] --seed S
[--device cpu|cuda] [--serve auto|dense|fused]`` plans Global
Accelerator endpoint weights for a synthetic fleet and prints one JSON
object with the keys of the JAX package's ``plan`` command, ``device``
in place of ``rung``.  ``--serve`` picks the traffic MLP's path (mlp
only); the temporal model plans through its O(T) last-query path, which
runs no kernel.

``python -m aws_global_accelerator_controller_tpu_torch eval [--model
mlp|temporal] [--supervision last|sequence] --batches N ...`` scores
freshly initialised params on held-out synthetic batches and prints the
keys of the JAX package's ``eval`` (mean loss, plan L1 against the
target, the uniform plan's L1), ``device`` in place of ``rung``.  Under
``--model temporal --supervision sequence`` the loss runs the flash
kernel K6a once per batch.

The params come from the port's own generator (``torch.Generator``
seeded with ``--seed``) and the telemetry from numpy, so the numbers for
a seed differ from the JAX package's.  Checkpoints (``--ckpt``) wait for
the training slice.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.temporal import TemporalTrafficModel, synthetic_window
from ..models.traffic import TrafficPolicyModel, synthetic_batch

#: offset of the held-out batches' numpy stream from the seed's
EVAL_STREAM = 10_000


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m aws_global_accelerator_controller_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    plan = sub.add_parser(
        "plan", help="Plan GA endpoint weights for a fleet (JSON out)")
    plan.add_argument("--model", choices=("mlp", "temporal"), default="mlp",
                      help="Model family.")
    plan.add_argument("--groups", type=int, default=8,
                      help="Endpoint groups in the synthetic fleet.")
    plan.add_argument("--endpoints", type=int, default=16,
                      help="Endpoints per group.")
    plan.add_argument("--hidden", type=int, default=128,
                      help="Model hidden width (the fused MLP kernel "
                           "takes <= 128; use --serve dense above).")
    plan.add_argument("--window", type=int, default=64,
                      help="Telemetry window length (temporal model).")
    plan.add_argument("--seed", type=int, default=0,
                      help="Seed of the params and the synthetic "
                           "telemetry.")
    plan.add_argument("--device", default="cuda",
                      help="'cuda' (default) or 'cpu'.")
    plan.add_argument("--serve", choices=("auto", "dense", "fused"),
                      default="auto",
                      help="mlp only. auto: the fused kernel on CUDA, "
                           "dense on the CPU.")

    ev = sub.add_parser(
        "eval", help="Evaluate fresh params on held-out synthetic fleets "
                     "(JSON out)")
    ev.add_argument("--model", choices=("mlp", "temporal"), default="mlp",
                    help="Model family.")
    ev.add_argument("--batches", type=int, default=16,
                    help="Held-out batches to average over.")
    ev.add_argument("--groups", type=int, default=64,
                    help="Endpoint groups per eval batch.")
    ev.add_argument("--endpoints", type=int, default=16,
                    help="Endpoints per group.")
    ev.add_argument("--hidden", type=int, default=128,
                    help="Model hidden width.")
    ev.add_argument("--window", type=int, default=64,
                    help="Telemetry window length (temporal); the default "
                         "reaches the flash kernel (FLASH_MIN_WINDOW).")
    ev.add_argument("--supervision", choices=("last", "sequence"),
                    default="last",
                    help="Temporal objective to evaluate under.")
    ev.add_argument("--seed", type=int, default=0,
                    help="Seed of the params; eval batches use a numpy "
                         "stream disjoint from it.")
    ev.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'.")
    return parser


def plan(args: argparse.Namespace) -> dict:
    """The ``plan`` command's result (what it prints)."""
    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(args.seed)
    rng = np.random.default_rng(args.seed + 1)
    if args.model == "temporal":
        model = TemporalTrafficModel(hidden_dim=args.hidden)
        params = model.init_params(gen, device=dev)
        window, batch = synthetic_window(
            rng, steps=args.window, groups=args.groups,
            endpoints=args.endpoints, device=dev)
        weights = model.forward(params, window, batch.mask)
    else:
        model = TrafficPolicyModel(hidden_dim=args.hidden, serve=args.serve)
        params = model.init_params(gen, device=dev)
        batch = synthetic_batch(rng, groups=args.groups,
                                endpoints=args.endpoints, device=dev)
        weights = model.forward(params, batch.features, batch.mask)
    return {
        "groups": args.groups,
        "endpoints": args.endpoints,
        "device": str(dev),
        # int weights in [0, 255], 0 on padded slots
        "weights": weights.cpu().tolist(),
    }


def plan_l1(weights: torch.Tensor, mask: torch.Tensor,
            target: torch.Tensor):
    """(L1 of the normalised weight plan, L1 of the uniform plan) against
    the target distribution, each averaged over groups with a valid
    endpoint (the JAX ``run_eval``'s ``plan_l1``)."""
    w = weights.float()
    denom = torch.where(mask, w, 0.0).sum(dim=-1, keepdim=True)
    p = torch.where(mask & (denom > 0), w / denom.clamp_min(1.0), 0.0)
    valid = mask.sum(dim=-1, keepdim=True)
    uniform = torch.where(mask, 1.0 / valid.clamp_min(1), 0.0)
    l1 = ((p - target).abs() * mask).sum(dim=-1)
    u1 = ((uniform - target).abs() * mask).sum(dim=-1)
    any_valid = mask.any(dim=-1)
    n = any_valid.sum().clamp_min(1)
    return (torch.where(any_valid, l1, 0.0).sum() / n,
            torch.where(any_valid, u1, 0.0).sum() / n)


def evaluate(args: argparse.Namespace) -> dict:
    """The ``eval`` command's result (what it prints)."""
    if args.batches < 1:
        raise SystemExit("--batches must be >= 1")
    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(args.seed)
    temporal = args.model == "temporal"
    if temporal:
        model = TemporalTrafficModel(hidden_dim=args.hidden,
                                     supervision=args.supervision)
    else:
        model = TrafficPolicyModel(hidden_dim=args.hidden)
    params = model.init_params(gen, device=dev)
    losses, l1s, u1s = [], [], []
    for i in range(args.batches):
        rng = np.random.default_rng((args.seed, EVAL_STREAM, i))
        if temporal:
            window, batch = synthetic_window(
                rng, steps=args.window, groups=args.groups,
                endpoints=args.endpoints,
                per_step=args.supervision == "sequence", device=dev)
            loss = model.loss(params, window, batch)
            weights = model.forward(params, window, batch.mask)
            # plan quality is a last-step notion
            target = (batch.target[-1] if args.supervision == "sequence"
                      else batch.target)
        else:
            batch = synthetic_batch(rng, groups=args.groups,
                                    endpoints=args.endpoints, device=dev)
            loss = model.loss(params, batch)
            weights = model.forward(params, batch.features, batch.mask)
            target = batch.target
        l1, u1 = plan_l1(weights, batch.mask, target)
        losses.append(float(loss))
        l1s.append(float(l1))
        u1s.append(float(u1))
    return {
        "model": args.model,
        "step": 0,
        "batches": args.batches,
        "mean_loss": round(float(np.mean(losses)), 6),
        "plan_l1": round(float(np.mean(l1s)), 6),
        "uniform_l1": round(float(np.mean(u1s)), 6),
        "beats_uniform": bool(np.mean(l1s) < np.mean(u1s)),
        "device": str(dev),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "plan":
        if args.model == "temporal" and args.serve != "auto":
            parser.error("--serve applies to --model mlp only")
        out = plan(args)
    else:
        out = evaluate(args)
    json.dump(out, sys.stdout)
    print()
    return 0
