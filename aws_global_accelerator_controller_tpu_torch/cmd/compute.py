"""The port's compute commands: ``plan``, ``eval`` and ``train``.

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

``python -m aws_global_accelerator_controller_tpu_torch train [--model
mlp|temporal] [--supervision last|sequence] [--remat] [--optimizer
adam|flat_adam] [--attention-chunk HEADS] [--guard] [--eval-every N]
--steps N ...`` fits freshly initialised params on synthetic batches
(the JAX package's ``train`` loop, ``compute.py:621-781``, without its
checkpoints) and prints the reference's keys (``step``, ``model``,
``loss``, ``preempted`` when a SIGTERM or SIGINT stopped it), ``device``
in place of ``backend`` and ``rung``.  A loss line goes to stderr every
``steps // 10`` steps.  Under ``--model temporal --supervision
sequence`` a step runs the flash kernels K6b, K7 and K8 once each; with
``--attention-chunk HEADS`` it splits the streams into calls of at most
HEADS heads, and a call of at most 32 takes the fused one-sweep
backward K9 in place of K7 and K8 (the reference's route), so at the
defaults ``--attention-chunk 32`` runs 256 calls each of K6b and K9 a
step.

The params come from the port's own generator (``torch.Generator``
seeded with ``--seed``) and the telemetry from numpy, so the numbers for
a seed differ from the JAX package's.  Checkpoints (``--ckpt``) wait for
a checkpointer of the port's own.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.temporal import TemporalTrafficModel, synthetic_window
from ..models.traffic import TrafficPolicyModel, synthetic_batch
from ..signals import ScopedStopSignal

#: offset of the held-out batches' numpy stream from the seed's
EVAL_STREAM = 10_000
#: offset of the training batches' stream: (seed, step) alone would meet
#: the held-out stream at step EVAL_STREAM (numpy's seed sequence pads
#: its entropy with zeros, so (s, 10000) and (s, 10000, 0) are one seed)
TRAIN_STREAM = 20_000
#: restores after a non-finite loss before ``--guard`` gives up
MAX_RESTORES = 5


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
                      help="Model hidden width.")
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

    tr = sub.add_parser(
        "train", help="Train fresh params on synthetic fleets (JSON out)")
    tr.add_argument("--model", choices=("mlp", "temporal"), default="mlp",
                    help="Model family.")
    tr.add_argument("--supervision", choices=("last", "sequence"),
                    default="last",
                    help="Temporal objective: last = final-step scores "
                         "(O(T) last-query attention, no kernel); sequence "
                         "= every step (the flash kernels K6b, K7, K8).")
    tr.add_argument("--remat", action="store_true",
                    help="Temporal sequence supervision: recompute the "
                         "head's [T, S, H] hidden in the backward instead "
                         "of keeping it (same numbers, less memory).")
    tr.add_argument("--attention-chunk", type=int, default=0,
                    dest="attention_chunk", metavar="HEADS",
                    help="Temporal: split the G*E streams axis into chunks "
                         "of at most HEADS per flash call (exact: "
                         "attention is per-head independent).  Chunks of "
                         "<=32 ride the fused one-sweep flash backward "
                         "(K9), which wide stream counts otherwise "
                         "exceed.  0 = one call (default).")
    tr.add_argument("--optimizer", choices=("adam", "flat_adam"),
                    default="adam",
                    help="adam = per-param state (optax.adam's "
                         "arithmetic); flat_adam = one raveled f32 vector.")
    tr.add_argument("--guard", action="store_true",
                    help="Check every loss; on a non-finite one discard "
                         "the step, re-initialise the params, go on with "
                         f"the next batch, and abort after {MAX_RESTORES} "
                         "restores.  The reported step counts applied "
                         "updates.")
    tr.add_argument("--window", type=int, default=64,
                    help="Telemetry window length (temporal); the default "
                         "reaches the flash kernels (FLASH_MIN_WINDOW).")
    tr.add_argument("--steps", type=int, default=100,
                    help="Optimisation steps to run.")
    tr.add_argument("--eval-every", type=int, default=0, dest="eval_every",
                    help="Log the loss of one fixed held-out batch every N "
                         "applied steps (0 disables).")
    tr.add_argument("--groups", type=int, default=256,
                    help="Endpoint groups per synthetic batch.")
    tr.add_argument("--endpoints", type=int, default=32,
                    help="Endpoints per group.")
    tr.add_argument("--hidden", type=int, default=128,
                    help="Model hidden width.")
    tr.add_argument("--lr", type=float, default=1e-3,
                    help="Adam learning rate.")
    tr.add_argument("--seed", type=int, default=0,
                    help="Seed of the params and of the batches' numpy "
                         "streams.")
    tr.add_argument("--device", default="cuda",
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


def train(args: argparse.Namespace) -> dict:
    """The ``train`` command's result (what it prints)."""
    temporal = args.model == "temporal"
    if not temporal and args.attention_chunk:
        raise SystemExit(
            "--attention-chunk applies to the temporal family only "
            f"(got --model {args.model})")
    if args.attention_chunk < 0:
        raise SystemExit("--attention-chunk must be >= 0")
    dev = resolve_device(args.device)
    if temporal:
        model = TemporalTrafficModel(
            hidden_dim=args.hidden, learning_rate=args.lr,
            supervision=args.supervision, remat=args.remat,
            attention_chunk=args.attention_chunk, optimizer=args.optimizer)
    else:
        model = TrafficPolicyModel(hidden_dim=args.hidden,
                                   learning_rate=args.lr,
                                   optimizer=args.optimizer)

    def fresh():
        params = model.init_params(torch.Generator().manual_seed(args.seed),
                                   device=dev)
        return params, model.init_opt_state(params)

    def data(rng):
        """The loss's data arguments: (window, batch) or (batch,)."""
        if temporal:
            return synthetic_window(
                rng, steps=args.window, groups=args.groups,
                endpoints=args.endpoints,
                per_step=args.supervision == "sequence", device=dev)
        return (synthetic_batch(rng, groups=args.groups,
                                endpoints=args.endpoints, device=dev),)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    params, opt_state = fresh()
    eval_data = (data(np.random.default_rng((args.seed, EVAL_STREAM, 0)))
                 if args.eval_every > 0 else None)
    restores = step = 0
    loss = None          # the last applied step's loss, never non-finite
    preempted = False
    with ScopedStopSignal() as stop:
        for batch_idx in range(args.steps):
            if stop.is_set():
                preempted = True
                log(f"stop signal: exiting at step {step}")
                break
            rng = np.random.default_rng((args.seed, TRAIN_STREAM, batch_idx))
            new_params, new_opt, new_loss = model.train_step(
                params, opt_state, *data(rng))
            if args.guard and not math.isfinite(float(new_loss)):
                restores += 1
                log(f"non-finite loss on batch {batch_idx + 1} (restore "
                    f"{restores}/{MAX_RESTORES})")
                if restores > MAX_RESTORES:
                    raise SystemExit(
                        f"training diverged: {MAX_RESTORES} restores "
                        f"exhausted at batch {batch_idx + 1}")
                step = 0
                params, opt_state = fresh()
                continue
            params, opt_state, loss = new_params, new_opt, new_loss
            step += 1
            if eval_data is not None and step % args.eval_every == 0:
                with torch.no_grad():
                    held_out = float(model.loss(params, *eval_data))
                log(f"step {step} eval_loss {held_out:.5f}")
            if (batch_idx + 1) % max(1, args.steps // 10) == 0:
                log(f"step {step} loss {float(loss):.5f}")
    return {"step": step, "model": args.model,
            "loss": float(loss) if loss is not None else None,
            "device": str(dev), **({"preempted": True} if preempted else {})}


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "plan":
        if args.model == "temporal" and args.serve != "auto":
            parser.error("--serve applies to --model mlp only")
        out = plan(args)
    elif args.command == "train":
        out = train(args)
    else:
        out = evaluate(args)
    json.dump(out, sys.stdout)
    print()
    return 0
