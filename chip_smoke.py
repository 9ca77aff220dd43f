#!/usr/bin/env python3
"""Drive the PyTorch port's weight-planning, temporal and training paths
on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit (``nvcc``).  It builds the port's kernels from
``aws_global_accelerator_controller_tpu_torch/csrc`` and then:

1. runs the ``plan`` command (16384 groups x 16 endpoints, the fused MLP
   kernel) and checks its weights against the same command on the CPU;
   its first use of the card runs the device probe;
2. plans a 16384-group fleet with ``WholeFleetPlanner`` (cap 16, mean
   occupancy 2.5) and checks it against the same planner on the CPU;
3. builds a 1,000,000-group resident fleet over 128 shards (cap 4),
   plans it, runs three waves of 1% clustered churn and one clean wave
   through ``ResidentFleetPlanner``, and checks the resident plan
   bit for bit against a full repack (``verify_full_repack``);
4. runs ``plan --model temporal`` at its defaults against the same
   command on the CPU; serving plans through the O(T) last-query path,
   so it must launch no flash attention, as in the reference;
5. runs ``eval --model temporal --supervision sequence`` at its defaults
   (16 batches of a 64-step window over 64 x 16 endpoint streams, D = 32)
   against the same command on the CPU: exactly one flash-attention
   launch per batch;
6. runs ``scores_seq`` of a temporal model with D = 128, hidden 256 on a
   2048-step window of 8 x 16 streams once through the flash kernel and
   holds it against the dense reference attention on the card;
7. runs ``train --model temporal --supervision sequence`` at its
   defaults (a 64-step window over 256 x 32 streams, D = 32, hidden 128)
   for 10 steps: exactly one launch each of the flash forward with stats
   (K6b) and the backward sweeps (K7, K8) a step, and none of the plain
   forward (K6a) or of K9; then the same command for 3 steps on the
   card and on the CPU, whose final losses must agree within
   ``TRAIN_LOSS_RTOL``;
8. runs one ``train_step`` at the production temporal shape (phase 6's)
   with adam: one K6b, K7 and K8 launch; every parameter's gradient held
   to the same gradient through the dense reference attention within
   the JAX package's flash-vs-dense tolerance (``parity.grads_close``);
   then times three steps;
9. runs ``train --model temporal --supervision sequence
   --attention-chunk 32`` at phase 7's defaults for 10 steps: the 8192
   streams in 256 calls of 32 heads a step, each with one launch of K6b
   and of the fused one-sweep backward (K9), the reference's route for a
   call of at most 32 heads, and none of K6a, K7 or K8; then 3 steps on
   the card against 3 on the CPU (``TRAIN_LOSS_RTOL``); its time a step
   is recorded beside phase 7's (the same command, unchunked);
10. runs one ``train_step`` at phase 8's shape with ``attention_chunk=
    32``: 4 calls, 4 launches each of K6b and K9, none of K7 or K8; every
    parameter's gradient held to the unchunked model's (K7 and K8) on
    the card (``parity.grads_close``, and bit for bit); then times both
    models' steps;
11. runs ``train --model mlp`` for 3 steps on the card and on the CPU
    (dense, as in the reference: no kernel);
12. trains ``TemporalTrafficModel(head="fused", supervision="sequence")``
    at the train command's default shape for 10 steps on the card: one
    launch each of the fused score head's forward (K10) and backward
    (K11) a step, beside K6b, K7 and K8; then 3 steps on the card
    against 3 on the CPU (``head="fused_always"``, the kernels' plain
    versions), and one batch's loss and gradients against the dense head
    on the card; and times 10 steps of the dense-head model beside it;
13. holds every kernel against its plain PyTorch version on the card, at
    the shapes the paths give it and at widths past one tile (K3 at
    H = 256, the flash kernels at D = 160), and times both (and, where
    one exists, a PyTorch call computing the same function; for K9 also
    K7 + K8 on its inputs); then times the flash kernel against the
    dense reference attention at short windows (the
    ``FLASH_MIN_WINDOW`` crossover).

Before each of phases 1-12 every launch count is set to 0; after each
the script fails unless every kernel that phase runs was launched (and,
for the flash and head kernels, launched exactly as often as the path
calls them: K9 only in phases 9 and 10, the head kernels only in phase
12).  Phase 3 reads its counts after the last churn wave, demands
that the churn waves alone launched each of their kernels, and reports
the full repack's launches apart.

Output: the card's name and power limit, one line per phase, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
Any failed check raises, and the script exits non-zero without the last
line; so it does where no CUDA device is visible.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "aws_global_accelerator_controller_tpu_torch"
SRC = f"{PKG}/csrc"
REF = "aws_global_accelerator_controller_tpu"

# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core and
# f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

RESIDENT_GROUPS = 1_000_000
RESIDENT_SHARDS = 128
RESIDENT_CAP = 4
RESIDENT_DIRT = 0.01        # fraction of the fleet churned per wave
RESIDENT_WAVES = 3
#: kernels every churn wave runs: row scoring, quantizer, dirty-row splice
WAVE_KERNELS = ("fused_mlp_scores", "plan_weights", "row_splice")
FLEET_GROUPS = 16384
FLEET_CAP = 16
FLEET_SHARDS = 8
F = 8
#: the eval command's default batch count: one flash launch per batch
EVAL_BATCHES = 16
#: the repo's production temporal shape (bench.py:2221-2223): a 2048-step
#: window over 8 x 16 endpoint streams, embed 128, hidden 256
SEQ_WINDOW, SEQ_GROUPS, SEQ_ENDPOINTS = 2048, 8, 16
SEQ_EMBED, SEQ_HIDDEN = 128, 256
#: the JAX package's flash-vs-reference tolerance
#: (tests/test_temporal_model.py:41-42)
SEQ_TOL = 2e-2
#: steps of the train phase on the card, and of its card-vs-CPU check
TRAIN_STEPS, TRAIN_CHECK_STEPS = 10, 3
#: card vs CPU final loss of ``train --steps 3``: the loss after two
#: updates.  The kernels and the CPU's plain versions sum in other f32
#: orders, so a few bf16 params land one ulp apart after an update (a
#: near-zero gradient can even flip its Adam step); on the CPU, the same
#: mechanism moves the port's 3-step loss from the JAX package's by at
#: most 6e-5 relative (tests/test_torch_train.py), and 1e-3 leaves room
#: for the larger default batch's other sums
TRAIN_LOSS_RTOL = 1e-3
#: steps timed after the production-shape train step
SEQ_TRAIN_TIMED_STEPS = 3
#: the flash kernels' launch-count names
K6A, K6B, K7, K8, K9 = ("flash_attention", "flash_attention_stats",
                        "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dqkv")
#: heads a flash call in the chunked train phases: the reference's gate
#: of its fused backward (``_FUSED_BWD_MAX_HEADS``), what
#: ``--attention-chunk`` is for
ATTENTION_CHUNK = 32
#: the fused score head's launch-count names
K10, K11 = "score_head_fwd", "score_head_bwd"
#: widths past one tile of the kernels: K3's hidden layer, the flash
#: kernels' heads
WIDE_HIDDEN, WIDE_HEAD = 256, 160


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


def time_eager(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean ms per call of ``fn`` launched from Python (CUDA events):
    what a caller pays per call, host launch overhead included."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_device(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device ms per call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed, so host launch overhead drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms


def timings(kernel, plain, library=None, iters: int = 20,
            eager_iters: int = 50) -> dict:
    """Device and eager ms of a kernel's wrapper, its plain version and,
    where there is one, a PyTorch call computing the same function."""
    return {"ms": time_device(kernel, iters),
            "plain_ms": time_device(plain, iters),
            "library_ms": time_device(library, iters) if library else None,
            "eager_ms": time_eager(kernel, eager_iters),
            "plain_eager_ms": time_eager(plain, eager_iters)}


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    """(least time in ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _host(x):
    import numpy as np

    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def check_weights(name: str, got, want) -> tuple:
    """Integer weights within the port's tolerance (parity.py)."""
    from aws_global_accelerator_controller_tpu_torch import parity

    err, frac = parity.weight_mismatch(_host(got), _host(want))
    check(parity.weights_close(_host(got), _host(want)),
          f"{name}: max |dw| {err}, mismatch fraction {frac} (allowed "
          f"{parity.MAX_WEIGHT_DIFF}, {parity.MAX_MISMATCH_FRAC})")
    return err, frac


def check_scores(name: str, got, want) -> float:
    """Float scores within the port's tolerance (parity.py)."""
    from aws_global_accelerator_controller_tpu_torch import parity

    err = float(abs(_host(got) - _host(want)).max())
    check(parity.scores_close(_host(got), _host(want)),
          f"{name}: scores differ by more than {parity.MAX_SCORE_ULPS} "
          f"bf16 ulps (max |ds| {err})")
    return err


# ---------------------------------------------------------------------------
# fleet generators (numpy, from a seed)
# ---------------------------------------------------------------------------


def _arn(i: int, j: int) -> str:
    return (f"arn:aws:elasticloadbalancing:us-east-1:1:"
            f"loadbalancer/net/lb{i}-{j}/x")


def fleet_plan_groups(groups: int, shards: int, seed: int = 0):
    """The whole-fleet shape: 1-4 endpoints a group (mean 2.5), 20% of
    groups with an observed endpoint missing, every group model-planned
    and rescored."""
    import numpy as np

    from aws_global_accelerator_controller_tpu_torch.reconcile.columnar \
        import GroupState

    rng = np.random.default_rng(seed)
    out = []
    for i in range(groups):
        ne = 1 + (i % 4)
        desired = [_arn(i, j) for j in range(ne)]
        observed = desired[1:] if i % 5 == 0 and ne > 1 else list(desired)
        out.append(GroupState(
            key=f"default/b{i}", group_arn=f"eg-{i}", desired=desired,
            observed=observed,
            observed_weights=[int(w) for w in
                              rng.integers(0, 256, len(observed))],
            features=rng.standard_normal((ne, F)).astype(np.float32),
            shard=i % shards))
    return out


class ResidentFleetGen:
    """The resident-wave shape: contiguous key blocks per shard, 1-4
    endpoints a group, version 0 with 20% observed drift, later versions
    with drift resolved and observed weights re-rolled.  In later
    versions every fourth group also carries fresh features, so the
    churn waves rescore rows as well as re-diff them."""

    def __init__(self, groups: int, shards: int, seed: int = 0):
        import numpy as np

        self.groups, self.shards = groups, shards
        self.rng = np.random.default_rng(seed)
        self.ne = 1 + (np.arange(groups) % 4)
        self.feats = self.rng.standard_normal(
            (groups, 4, F)).astype(np.float32)
        self.w0 = self.rng.integers(0, 256, (groups, 4))

    def group(self, i: int, version: int):
        from aws_global_accelerator_controller_tpu_torch.reconcile.columnar \
            import GroupState

        nd = int(self.ne[i])
        desired = [_arn(i, j) for j in range(nd)]
        feats = self.feats[i, :nd]
        if version == 0:
            observed = (desired[1:] if i % 5 == 0 and nd > 1
                        else list(desired))
            obs_w = [int(w) for w in self.w0[i, :len(observed)]]
        else:
            observed = list(desired)
            obs_w = [int(w) for w in
                     self.rng.integers(0, 256, len(observed))]
            if i % 4 == 0:
                feats = self.rng.standard_normal((nd, F)).astype(
                    feats.dtype)
        return GroupState(
            key=f"default/b{i}", group_arn=f"eg-{i}", desired=desired,
            observed=observed, observed_weights=obs_w, features=feats,
            fingerprint=version * self.groups + i + 1,
            shard=(i * self.shards) // self.groups)


# ---------------------------------------------------------------------------
# phase 1: every kernel against its plain version
# ---------------------------------------------------------------------------


def _record(name, source, replaces, shape, err, frac, times, bound):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "mismatch_frac": frac, **times, "bound_ms": bound[0],
            "bound_by": bound[1], "shape": shape}


def _k1():
    import torch

    from aws_global_accelerator_controller_tpu_torch.device import (
        probe_double,
        probe_double_reference,
    )

    x = torch.randn(8, 128, device="cuda")
    got, want = probe_double(x), probe_double_reference(x)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "probe_double disagrees with 2 * x")
    return _record(
        "probe_double", f"{SRC}/probe.cu",
        f"{REF}/compat/capability.py:215", "8x128", 0.0, 0.0,
        timings(lambda: probe_double(x), lambda: probe_double_reference(x),
                lambda: torch.mul(x, 2.0)),
        bound_ms(x.numel() * 8, x.numel(), F32_FLOP_PER_S))


def _k2_one(G, E, seed):
    import torch

    from aws_global_accelerator_controller_tpu_torch.ops.cuda_weights \
        import plan_block, plan_weights_cuda

    g = torch.Generator(device="cuda").manual_seed(seed)
    scores = torch.randn(G, E, device="cuda", generator=g) * 3
    lengths = torch.randint(0, E + 1, (G, 1), device="cuda", generator=g)
    mask = torch.arange(E, device="cuda")[None, :] < lengths   # ragged
    mask[::7] = False                                           # all-masked
    got, want = plan_weights_cuda(scores, mask), plan_block(scores, mask)
    torch.cuda.synchronize()
    err, frac = check_weights(f"plan_weights {G}x{E}", got, want)
    check(bool((got[~mask] == 0).all().item())
          and bool((got[::7] == 0).all().item()),
          f"plan_weights {G}x{E}: masked cells or all-masked rows nonzero")
    masked = scores.masked_fill(~mask, float("-inf"))
    # per cell: read 4 + 1 bytes, write 4; max, sub, exp, sum, exp, div,
    # mul, round: ~8 f32 operations
    return _record(
        "plan_weights", f"{SRC}/plan_weights.cu",
        f"{REF}/ops/pallas_weights.py:47", f"{G}x{E}", err, frac,
        timings(lambda: plan_weights_cuda(scores, mask),
                lambda: plan_block(scores, mask),
                # softmax + scale + round: three launches, no masking
                # of all-masked rows (they come out NaN)
                lambda: torch.round(torch.softmax(masked, dim=-1) * 255)),
        bound_ms(G * E * 9, G * E * 8, F32_FLOP_PER_S))


def _other_shape(main: dict, *others: dict) -> dict:
    same = ("name", "route", "source", "replaces", "launches")
    main["at_other_shapes"] = [{k: v for k, v in other.items()
                                if k not in same} for other in others]
    for other in others:
        main["max_abs_err"] = max(main["max_abs_err"], other["max_abs_err"])
        main["mismatch_frac"] = max(main["mismatch_frac"],
                                    other["mismatch_frac"])
    return main


def _k2():
    return _other_shape(_k2_one(FLEET_GROUPS, FLEET_CAP, 1),
                        _k2_one(RESIDENT_GROUPS, RESIDENT_CAP, 2))


def _mlp_params(seed, H=128):
    import torch

    from aws_global_accelerator_controller_tpu_torch.models.traffic import (
        TrafficPolicyModel,
    )

    return TrafficPolicyModel(hidden_dim=H).init_params(
        torch.Generator().manual_seed(seed), device="cuda")


def _mlp_flops(rows, H=128):
    return 2.0 * rows * (F * H + H * H + H)


def _k3(H=128):
    import torch

    from aws_global_accelerator_controller_tpu_torch.ops.cuda_mlp import (
        forward_cuda,
        forward_reference,
    )

    G, E = FLEET_GROUPS, FLEET_CAP
    params = _mlp_params(3, H)
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(G, E, F, device="cuda", generator=g).to(torch.bfloat16)
    mask = torch.rand(G, E, device="cuda", generator=g) < 0.8
    mask[::5] = False
    got = forward_cuda(params, x, mask)
    want = forward_reference(params, x, mask)
    torch.cuda.synchronize()
    err, frac = check_weights("fused_mlp_plan", got, want)
    wbytes = sum(p.numel() * 2 for p in params.values())
    return _record(
        "fused_mlp_plan", f"{SRC}/mlp.cu",
        f"{REF}/ops/pallas_mlp.py:49", f"{G}x{E}x{F}, H={H}", err, frac,
        timings(lambda: forward_cuda(params, x, mask),
                lambda: forward_reference(params, x, mask)),
        bound_ms(G * E * (F * 2 + 1 + 4) + wbytes, _mlp_flops(G * E, H),
                 BF16_FLOP_PER_S))


def _k3_scores(H=128):
    import torch

    from aws_global_accelerator_controller_tpu_torch.ops.cuda_mlp import (
        dense_scores,
        score_rows_cuda,
    )

    N = 65536   # the whole-fleet phase's packed rows: 8 shards x 8192
    params = _mlp_params(4, H)
    g = torch.Generator(device="cuda").manual_seed(4)
    rows = torch.randn(N, F, device="cuda", generator=g)
    got, want = score_rows_cuda(params, rows), dense_scores(params, rows)
    torch.cuda.synchronize()
    err = check_scores("fused_mlp_scores", got, want)
    # bit-identical whatever the batch: score a slice alone
    part = score_rows_cuda(params, rows[1000:1037])
    check(torch.equal(part, got[1000:1037]),
          "fused_mlp_scores: a row's score depends on its batch")
    wbytes = sum(p.numel() * 2 for p in params.values())
    rec = _record(
        "fused_mlp_scores", f"{SRC}/mlp.cu", f"{REF}/ops/pallas_mlp.py:49",
        f"{N}x{F}, H={H}", err, float((got != want).float().mean().item()),
        timings(lambda: score_rows_cuda(params, rows),
                lambda: dense_scores(params, rows)),
        bound_ms(N * (F * 4 + 4) + wbytes, _mlp_flops(N, H),
                 BF16_FLOP_PER_S))
    rec["note"] = ("K3's row-scoring entry: score_rows "
                   f"({REF}/models/traffic.py:89), XLA matmuls in the JAX "
                   "package")
    return rec


def _k4_one(S, cap, W, K, seed):
    import numpy as np
    import torch

    from aws_global_accelerator_controller_tpu_torch.parallel import fleet
    from aws_global_accelerator_controller_tpu_torch.parallel.fleet import (
        row_splice,
        row_splice_reference,
    )

    rng = np.random.default_rng(seed)
    lin_np = rng.choice(S * cap, size=K, replace=False).astype(np.int32)
    lin_np[-16:] = lin_np[0]            # pad rows repeat row 0's target
    rows = torch.from_numpy(
        rng.integers(0, 1 << 30, (K, W)).astype(np.int32)).cuda()
    rows[-16:] = rows[0]
    lin = torch.from_numpy(lin_np).cuda()
    base = torch.from_numpy(
        rng.integers(0, 1 << 30, (S * cap, W)).astype(np.int32)).cuda()
    got = row_splice(base.clone(), lin, rows)
    want = row_splice_reference(base.clone(), lin, rows)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"row_splice [{S * cap}, {W}] disagrees")
    dst = base.clone()
    lin64 = lin.long()
    # the wrapper's bounds check reads lin's range back to the host,
    # which a CUDA graph cannot capture: the device time is the bare
    # kernel's, the eager time the wrapper's, check included
    times = timings(lambda: fleet._SPLICE(dst.device, dst, lin, rows, K, W),
                    lambda: row_splice_reference(dst, lin, rows),
                    lambda: dst.index_copy_(0, lin64, rows))
    times["eager_ms"] = time_eager(lambda: row_splice(dst, lin, rows))
    return _record(
        "row_splice", f"{SRC}/row_splice.cu",
        f"{REF}/parallel/fleet.py:258", f"{K} rows into {S * cap}x{W}",
        0.0, 0.0, times, bound_ms(K * (W * 8 + 4), 0.0, F32_FLOP_PER_S))


def _k4():
    cap = -(-RESIDENT_GROUPS // RESIDENT_SHARDS)
    return _other_shape(
        _k4_one(RESIDENT_SHARDS, cap, RESIDENT_CAP, 10_000, 5),
        _k4_one(RESIDENT_SHARDS, cap, 1, 10_000, 6))


def _k6a_one(T, S, D, seed, iters=20, eager_iters=50):
    import numpy as np
    import torch

    from aws_global_accelerator_controller_tpu_torch import parity
    from aws_global_accelerator_controller_tpu_torch.ops.cuda_attention \
        import BLOCK_K, flash_attention, flash_attention_plain

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(T, S, D, device="cuda", generator=g)
               .to(torch.bfloat16) for _ in range(3))
    got = flash_attention(q, k, v)
    want = flash_attention_plain(q, k, v, True, BLOCK_K)
    mag = flash_attention_plain(q, k, v.abs(), True, BLOCK_K)
    torch.cuda.synchronize()
    got_h, want_h, mag_h = (_host(x.float()) for x in (got, want, mag))
    check(bool(np.isfinite(got_h).all()),
          f"flash_attention T={T} S={S} D={D}: non-finite output")
    diff = np.abs(got_h - want_h)
    ulps_of_mag = float((diff / parity.bf16_ulp(
        np.maximum(np.abs(want_h), np.abs(mag_h)))).max())
    check(parity.attention_close(got_h, want_h, mag_h),
          f"flash_attention T={T} S={S} D={D}: {ulps_of_mag} bf16 ulps of "
          f"the magnitude from its plain version (allowed "
          f"{parity.MAX_SCORE_ULPS})")
    # the yardstick: PyTorch's fused attention on head-major copies
    qh, kh, vh = (x.transpose(0, 1).unsqueeze(0).contiguous()
                  for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rec = _record(
        "flash_attention", f"{SRC}/flash_attention.cu",
        f"{REF}/ops/pallas_attention.py:287", f"T={T} S={S} D={D}",
        float(diff.max()), float((diff > 0).mean()),
        timings(lambda: flash_attention(q, k, v),
                lambda: flash_attention_plain(q, k, v, True, BLOCK_K),
                lambda: sdpa(qh, kh, vh, is_causal=True), iters=iters,
                eager_iters=eager_iters),
        # q, k, v read and o written once; 4 D flops per live
        # (query, key) pair, T (T + 1) / 2 of them per head
        bound_ms(4 * T * S * D * 2, 2.0 * D * S * T * (T + 1),
                 BF16_FLOP_PER_S))
    rec["max_ulps_of_magnitude"] = ulps_of_mag
    rec["max_ulps_of_output"] = float((diff / parity.bf16_ulp(want_h)).max())
    return rec


def _k6a():
    return _other_shape(_k6a_one(64, 1024, 32, 7),
                        _k6a_one(SEQ_WINDOW, SEQ_GROUPS * SEQ_ENDPOINTS,
                                 SEQ_EMBED, 8, iters=5, eager_iters=5),
                        _k6a_one(1024, 64, WIDE_HEAD, 11, iters=5,
                                 eager_iters=5))


def _check_close(name: str, got, want, mag) -> tuple:
    """(max |d|, fraction that differs, max |d| in bf16 ulps of
    max(|want|, |mag|)): finite, and within 2 bf16 ulps of the magnitude
    (``parity.attention_close``)."""
    import numpy as np

    from aws_global_accelerator_controller_tpu_torch import parity

    got_h, want_h, mag_h = (_host(x.float()) for x in (got, want, mag))
    check(bool(np.isfinite(got_h).all()), f"{name}: non-finite output")
    diff = np.abs(got_h - want_h)
    ulps = float((diff / parity.bf16_ulp(
        np.maximum(np.abs(want_h), np.abs(mag_h)))).max())
    check(parity.attention_close(got_h, want_h, mag_h),
          f"{name}: {ulps} bf16 ulps of the magnitude from its plain "
          f"version (allowed {parity.MAX_SCORE_ULPS})")
    return float(diff.max()), float((diff > 0).mean()), ulps


def _flash_train_rows(T, S, D, seed, iters=20, eager_iters=50):
    """K6b, K7 and K8 at one shape: each against its plain version at
    the kernels' block on the same inputs (the backward on K6b's own o,
    m, l and a random bf16 cotangent), and timed beside its plain
    version and PyTorch's SDPA (forward; backward, which gives dq, dk
    and dv together, as fwd+bwd minus fwd)."""
    import torch

    from aws_global_accelerator_controller_tpu_torch.ops import (
        cuda_attention as ca,
    )

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(T, S, D, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    shape = f"T={T} S={S} D={D}"
    blk = ca.BLOCK_K

    # K6b
    o, m, l = ca.flash_attention_stats(q, k, v)
    po, pm, pl = ca.flash_attention_stats_plain(q, k, v, True, blk)
    mag = ca.flash_attention_plain(q, k, v.abs(), True, blk)
    torch.cuda.synchronize()
    err, frac, ulps = _check_close(f"flash_attention_stats {shape}", o, po,
                                   mag)
    check(torch.equal(o, ca.flash_attention_forward(q, k, v)),
          f"flash_attention_stats {shape}: o differs from K6a's")
    stats_err = max(float((m - pm).abs().max()), float((l - pl).abs().max()))
    check(bool(torch.allclose(m, pm, rtol=1e-5, atol=1e-5)
               and torch.allclose(l, pl, rtol=1e-5, atol=1e-5)),
          f"flash_attention_stats {shape}: m, l off by {stats_err}")
    heads = [x.transpose(0, 1).unsqueeze(0).contiguous() for x in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = T * (T + 1) / 2 * S          # live (query, key) pairs
    fwd = _record(
        "flash_attention_stats", f"{SRC}/flash_attention.cu",
        f"{REF}/ops/pallas_attention.py:301", shape, err, frac,
        timings(lambda: ca.flash_attention_stats(q, k, v),
                lambda: ca.flash_attention_stats_plain(q, k, v, True, blk),
                lambda: sdpa(*heads, is_causal=True), iters=iters,
                eager_iters=eager_iters),
        # q, k, v read, o, m, l written; 2 products of 2 D flops a pair
        bound_ms(8 * T * S * D + 8 * T * S, 4.0 * D * pairs,
                 BF16_FLOP_PER_S))
    fwd["max_ulps_of_magnitude"] = ulps
    fwd["stats_max_abs_err"] = stats_err

    # K7 and K8 on K6b's o, m, l
    dvec = ca.attention_dvec(o, do)
    dq = ca.flash_bwd_dq(q, k, v, do, m, l, dvec)
    dk, dv = ca.flash_bwd_dkv(q, k, v, do, m, l, dvec)
    want_dq = ca.flash_bwd_dq_plain(q, k, v, do, m, l, dvec, True, blk, blk)
    want_dk, want_dv = ca.flash_bwd_dkv_plain(q, k, v, do, m, l, dvec, True,
                                              blk)
    mag_dq, mag_dk, mag_dv = ca.flash_attention_bwd_magnitude(
        q, k, v, o, do, m, l)
    torch.cuda.synchronize()
    dq_err, dq_frac, dq_ulps = _check_close(f"flash_bwd_dq {shape}", dq,
                                            want_dq, mag_dq)
    dk_err, dk_frac, dk_ulps = _check_close(f"flash_bwd_dkv dk {shape}", dk,
                                            want_dk, mag_dk)
    dv_err, dv_frac, dv_ulps = _check_close(f"flash_bwd_dkv dv {shape}", dv,
                                            want_dv, mag_dv)
    again = ca.flash_attention_bwd(q, k, v, o, do, m, l)
    check(all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv))),
          f"flash backward {shape}: two runs differ")
    del mag_dq, mag_dk, mag_dv, want_dq, want_dk, want_dv, again

    leaves = [x.requires_grad_(True) for x in heads]
    dout = do.transpose(0, 1).unsqueeze(0).contiguous()
    sdpa_fwd_bwd = time_device(lambda: torch.autograd.grad(
        sdpa(*leaves, is_causal=True), leaves, dout), iters)
    sdpa_fwd = time_device(lambda: sdpa(*leaves, is_causal=True), iters)
    library = {"library_ms": sdpa_fwd_bwd - sdpa_fwd,
               "library_fwd_bwd_ms": sdpa_fwd_bwd,
               "library_note": "SDPA backward (fwd+bwd minus fwd): dq, dk "
                               "and dv together, to compare with K7 + K8"}
    stats_bytes = 12 * T * S            # m, l, dvec read
    k7 = _record(
        "flash_bwd_dq", f"{SRC}/flash_attention_bwd.cu",
        f"{REF}/ops/pallas_attention.py:455", shape, dq_err, dq_frac,
        {**timings(lambda: ca.flash_bwd_dq(q, k, v, do, m, l, dvec),
                   lambda: ca.flash_bwd_dq_plain(q, k, v, do, m, l, dvec),
                   iters=iters, eager_iters=eager_iters), **library},
        # q, k, v, do read, dq written; 3 products
        bound_ms(10 * T * S * D + stats_bytes, 6.0 * D * pairs,
                 BF16_FLOP_PER_S))
    k7["max_ulps_of_magnitude"] = dq_ulps
    k8 = _record(
        "flash_bwd_dkv", f"{SRC}/flash_attention_bwd.cu",
        f"{REF}/ops/pallas_attention.py:707", shape, max(dk_err, dv_err),
        max(dk_frac, dv_frac),
        {**timings(lambda: ca.flash_bwd_dkv(q, k, v, do, m, l, dvec),
                   lambda: ca.flash_bwd_dkv_plain(q, k, v, do, m, l, dvec),
                   iters=iters, eager_iters=eager_iters), **library},
        # q, k, v, do read, dk, dv written; 4 products
        bound_ms(12 * T * S * D + stats_bytes, 8.0 * D * pairs,
                 BF16_FLOP_PER_S))
    k8["max_ulps_of_magnitude"] = max(dk_ulps, dv_ulps)
    return fwd, k7, k8


def _flash_train():
    """K6b, K7, K8 at the train command's default shape, at the
    production shape and at a head width of 160 (two column chunks); the
    first is each row's main shape."""
    main = _flash_train_rows(64, 256 * 32, 32, 9)
    other = _flash_train_rows(SEQ_WINDOW, SEQ_GROUPS * SEQ_ENDPOINTS,
                              SEQ_EMBED, 10, iters=5, eager_iters=5)
    wide = _flash_train_rows(1024, 64, WIDE_HEAD, 12, iters=5,
                             eager_iters=5)
    return [_other_shape(a, b, c) for a, b, c in zip(main, other, wide)]


def _k9_one(T, S, D, seed, iters=20, eager_iters=50):
    """K9 at one shape, on K6b's o, m, l and a random bf16 cotangent:
    against its plain version at the kernels' block (dq, dk, dv within 2
    bf16 ulps of what each sums), two runs held bit for bit, and against
    K7 and K8 on the same inputs, within the same tolerance and bit for
    bit (K9 does their products in their f32 order); timed beside its
    plain version, K7 + K8 and PyTorch's SDPA backward."""
    import torch

    from aws_global_accelerator_controller_tpu_torch.ops import (
        cuda_attention as ca,
    )

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(T, S, D, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    shape = f"T={T} S={S} D={D}"
    o, m, l = ca.flash_attention_stats(q, k, v)
    dvec = ca.attention_dvec(o, do)
    got = ca.flash_bwd_dqkv(q, k, v, do, m, l, dvec)
    want = ca.flash_bwd_dqkv_plain(q, k, v, do, m, l, dvec)
    sweeps = (ca.flash_bwd_dq(q, k, v, do, m, l, dvec),
              *ca.flash_bwd_dkv(q, k, v, do, m, l, dvec))
    mags = ca.flash_attention_bwd_magnitude(q, k, v, o, do, m, l)
    torch.cuda.synchronize()
    errs, sweep_ulps = [], []
    for name, a, b, c, mag in zip(("dq", "dk", "dv"), got, want, sweeps,
                                  mags):
        errs.append(_check_close(f"flash_bwd_dqkv {name} {shape}", a, b,
                                 mag))
        sweep_ulps.append(_check_close(
            f"flash_bwd_dqkv {name} {shape} vs K7, K8", a, c, mag)[2])
    again = ca.flash_bwd_dqkv(q, k, v, do, m, l, dvec)
    check(all(torch.equal(a, b) for a, b in zip(again, got)),
          f"flash_bwd_dqkv {shape}: two runs differ")
    same_as_sweeps = all(torch.equal(a, b) for a, b in zip(got, sweeps))
    check(same_as_sweeps,
          f"flash_bwd_dqkv {shape}: not bit for bit K7's and K8's")
    del want, sweeps, mags, again

    heads = [x.transpose(0, 1).unsqueeze(0).contiguous().requires_grad_(True)
             for x in (q, k, v)]
    dout = do.transpose(0, 1).unsqueeze(0).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_fwd_bwd = time_device(lambda: torch.autograd.grad(
        sdpa(*heads, is_causal=True), heads, dout), iters)
    sdpa_fwd = time_device(lambda: sdpa(*heads, is_causal=True), iters)
    pairs = T * (T + 1) / 2 * S          # live (query, key) pairs
    # the backward's matmul passes beyond the forward's two (QK^T, PV)
    # on this route: 5 products of 2 D flops a live pair
    check(ca.fused_bwd_route(T, S, D),
          f"flash_bwd_dqkv {shape}: not on the reference's fused route")
    bwd_flops = (ca.backward_hw_matmul_factor(T, S, D) - 1) * 4.0 * D * pairs
    rec = _record(
        K9, f"{SRC}/flash_attention_dqkv.cu",
        f"{REF}/ops/pallas_attention.py:585", shape,
        max(e[0] for e in errs), max(e[1] for e in errs),
        {**timings(lambda: ca.flash_bwd_dqkv(q, k, v, do, m, l, dvec),
                   lambda: ca.flash_bwd_dqkv_plain(q, k, v, do, m, l,
                                                   dvec),
                   iters=iters, eager_iters=eager_iters),
         "k7_k8_ms": time_device(lambda: (
             ca.flash_bwd_dq(q, k, v, do, m, l, dvec),
             ca.flash_bwd_dkv(q, k, v, do, m, l, dvec)), iters),
         "library_ms": sdpa_fwd_bwd - sdpa_fwd,
         "library_fwd_bwd_ms": sdpa_fwd_bwd,
         "library_note": "SDPA backward (fwd+bwd minus fwd): dq, dk and "
                         "dv together"},
        # q, k, v, do, m, l, dvec read, dq, dk, dv written
        bound_ms(14 * T * S * D + 12 * T * S, bwd_flops, BF16_FLOP_PER_S))
    rec["max_ulps_of_magnitude"] = max(e[2] for e in errs)
    rec["max_ulps_of_magnitude_vs_k7_k8"] = max(sweep_ulps)
    rec["bit_identical_to_k7_k8"] = same_as_sweeps
    rec["dq_workspace_floats"] = ca._dqkv_workspace_floats(
        T, S, -(-D // ca.HEAD_DIM_MULTIPLE) * ca.HEAD_DIM_MULTIPLE)
    return rec


def _k9():
    """K9 at a chunk of the train command's default shape, at a chunk
    of the production shape and at a head width of 160 (in two
    128-column chunks)."""
    return _other_shape(_k9_one(64, ATTENTION_CHUNK, 32, 15),
                        _k9_one(SEQ_WINDOW, ATTENTION_CHUNK, SEQ_EMBED, 16,
                                iters=3, eager_iters=5),
                        _k9_one(1024, ATTENTION_CHUNK, WIDE_HEAD, 17,
                                iters=3, eager_iters=5))


def _head_inputs(T, S, D, H, seed):
    """x [T, S, D] bf16 (unit normal, as an attended representation),
    the head's params at the model's init scales with small random
    biases, and an f32 cotangent ds [T, S]."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    bf = torch.bfloat16
    return (randn(T, S, D).to(bf), (randn(D, H) / math.sqrt(D)).to(bf),
            (randn(H) * 0.1).to(bf), (randn(H, 1) / math.sqrt(H)).to(bf),
            (randn(1) * 0.1).to(bf), randn(T, S) / (T * S))


def _head_rows_one(T, S, D, H, seed, iters=20, eager_iters=50):
    """K10 and K11 at one shape, each against its plain version on the
    same inputs (scores and dx within 2 bf16 ulps of what each sums,
    ``score_head_magnitude`` and ``score_head_dx_magnitude``; the weight
    gradients, sums over every row that cancel, within
    ``score_head_weight_grad_limits``), K11 run twice and held bit for
    bit, and both timed beside their plain
    versions and beside the dense head in torch (bf16 cuBLAS GEMMs:
    its forward for K10, its forward+backward minus its forward for K11)
    and the port's own dense head (what ``head="reference"`` runs)."""
    import torch

    from aws_global_accelerator_controller_tpu_torch.ops import (
        cuda_head as ch,
    )

    x, w1, b1, w2, b2, ds = _head_inputs(T, S, D, H, seed)
    params = (w1, b1, w2, b2)
    shape = f"T={T} S={S} D={D} H={H}"
    got = ch.score_head_forward(x, *params)
    want = ch.score_head_plain(x, *params)
    mag = ch.score_head_magnitude(x, *params)
    torch.cuda.synchronize()
    err, frac, ulps = _check_close(f"score_head {shape}", got, want, mag)
    grads = ch.score_head_bwd(x, *params, ds)
    want_g = ch.score_head_bwd_plain(x, *params, ds)
    dx_mag = ch.score_head_dx_magnitude(x, *params, ds)
    limits = ch.score_head_weight_grad_limits(x, *params, ds)
    torch.cuda.synchronize()
    bwd = [_check_close(f"score_head_bwd dx {shape}", grads[0], want_g[0],
                        dx_mag)]
    weight_errs = {}
    for name, g, w, lim in zip(("dw1", "db1", "dw2", "db2"), grads[1:],
                               want_g[1:], limits):
        check(bool(torch.isfinite(g.float()).all()),
              f"score_head_bwd {name} {shape}: non-finite output")
        weight_errs[name] = ch.weight_grad_error(g, w, lim)
        check(weight_errs[name] <= 1.0,
              f"score_head_bwd {name} {shape}: {weight_errs[name]} times "
              f"its limit from its plain version")
        diff = (g.float() - w.float()).abs()
        bwd.append((float(diff.max()), float((diff > 0).float().mean()),
                    0.0))
    again = ch.score_head_bwd(x, *params, ds)
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          f"score_head_bwd {shape}: two runs differ")
    del want_g, dx_mag, limits, again

    def dense(xx, ww1, bb1, ww2, bb2):
        return (torch.relu(xx @ ww1 + bb1) @ ww2 + bb2)[..., 0].float()

    leaves = [t.clone().requires_grad_(True) for t in (x, *params)]
    library = {}
    for key, fn in (("library", dense), ("port_dense", ch.score_head_plain)):
        fwd = time_device(lambda: fn(*leaves), iters)
        fwd_bwd = time_device(lambda: torch.autograd.grad(
            fn(*leaves), leaves, ds), iters)
        library[key] = (fwd, fwd_bwd)
    N = T * S
    fwd_rec = _record(
        "score_head_fwd", f"{SRC}/score_head.cu",
        f"{REF}/ops/pallas_head.py:72", shape, err, frac,
        {**timings(lambda: ch.score_head_forward(x, *params),
                   lambda: ch.score_head_plain(x, *params),
                   lambda: dense(x, *params), iters=iters,
                   eager_iters=eager_iters),
         "library_note": "dense head in torch, bf16 cuBLAS GEMMs",
         "port_dense_ms": library["port_dense"][0]},
        # x read, scores written; 2 N D H + 2 N H flops
        bound_ms(2 * N * D + 4 * N, 2.0 * N * H * (D + 1), BF16_FLOP_PER_S))
    fwd_rec["max_ulps_of_magnitude"] = ulps
    bwd_rec = _record(
        "score_head_bwd", f"{SRC}/score_head.cu",
        f"{REF}/ops/pallas_head.py:90", shape,
        max(b[0] for b in bwd), max(b[1] for b in bwd),
        {**timings(lambda: ch.score_head_bwd(x, *params, ds),
                   lambda: ch.score_head_bwd_plain(x, *params, ds),
                   iters=iters, eager_iters=eager_iters),
         "library_ms": library["library"][1] - library["library"][0],
         "library_fwd_bwd_ms": library["library"][1],
         "library_note": "dense head in torch, bf16 cuBLAS GEMMs: "
                         "forward+backward minus forward",
         "port_dense_ms": library["port_dense"][1]
         - library["port_dense"][0]},
        # x and ds read, dx written; h again, dw1 and dx: 6 N D H flops
        bound_ms(4 * N * D + 4 * N, 6.0 * N * D * H, BF16_FLOP_PER_S))
    bwd_rec["dx_max_ulps_of_magnitude"] = bwd[0][2]
    bwd_rec["weight_grad_error_over_limit"] = weight_errs
    return fwd_rec, bwd_rec


def _head_rows():
    """K10 and K11 at the train command's default shape (the main one)
    and at the reference's own head shape, T = 2048, S = 128, D = 128,
    H = 256 (``ops/pallas_head.py:10-13``)."""
    main = _head_rows_one(64, 256 * 32, 32, 128, 13)
    other = _head_rows_one(SEQ_WINDOW, SEQ_GROUPS * SEQ_ENDPOINTS,
                           SEQ_EMBED, SEQ_HIDDEN, 14, iters=5,
                           eager_iters=10)
    return [_other_shape(a, b) for a, b in zip(main, other)]


def phase_kernels() -> list:
    return [_k1(), _k2(), _other_shape(_k3(), _k3(WIDE_HIDDEN)),
            _other_shape(_k3_scores(), _k3_scores(WIDE_HIDDEN)), _k4(),
            _k6a(), *_flash_train(), _k9(), *_head_rows()]


def phase_flash_crossover(S: int = 1024, D: int = 32,
                          windows=(8, 16, 32, 64, 128, 256)) -> dict:
    """Device ms of the flash kernel and of the dense reference attention
    (what the temporal model runs below ``FLASH_MIN_WINDOW``) on the same
    bf16 q, k, v at short windows, S = 1024 streams of D = 32 (the eval
    command's width): the data for re-deriving the crossover on the
    card."""
    import torch

    from aws_global_accelerator_controller_tpu_torch.ops.cuda_attention \
        import flash_attention
    from aws_global_accelerator_controller_tpu_torch.parallel \
        .ring_attention import attention_reference

    rows = []
    for T in windows:
        g = torch.Generator(device="cuda").manual_seed(T)
        q, k, v = (torch.randn(T, S, D, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(3))
        rows.append({"T": T,
                     "flash_ms": time_device(lambda: flash_attention(q, k, v)),
                     "reference_ms": time_device(
                         lambda: attention_reference(q, k, v, causal=True))})
    return {"phase": "flash_crossover", "streams": S, "embed_dim": D,
            "windows": rows}


# ---------------------------------------------------------------------------
# phases 2-4: the planning path through its entry points
# ---------------------------------------------------------------------------


def run_cli(argv) -> tuple:
    """(the JSON a port command printed, its wall ms)."""
    from aws_global_accelerator_controller_tpu_torch.cmd.compute import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    ms = (time.perf_counter() - t0) * 1e3
    check(rc == 0, f"{' '.join(argv)} exited {rc}")
    return json.loads(buf.getvalue()), ms


def _plan_vs_cpu(name, argv, device, groups, endpoints, launch_counts):
    """Run a ``plan`` command on ``device`` and on the CPU, check the
    weights' shape, range and sums and their agreement.
    ``launch_counts`` is read right after the path ran, before any
    comparison or timing launches a kernel."""
    import torch

    out, ms = run_cli([*argv, "--device", device])
    launches = launch_counts() if launch_counts else {}
    w = torch.tensor(out["weights"], dtype=torch.int32)
    check(tuple(w.shape) == (groups, endpoints),
          f"{name}: weights shape {tuple(w.shape)}")
    check(bool(((w >= 0) & (w <= 255)).all().item()),
          f"{name}: weights outside [0, 255]")
    sums = w.sum(dim=1)
    check(bool(((sums == 0) | ((sums - 255).abs() <= endpoints)).all()
               .item()), f"{name}: a group's weights do not sum to ~255")
    ref, _ = run_cli([*argv, "--device", "cpu"])
    err, frac = check_weights(f"{name} vs cpu", w,
                              torch.tensor(ref["weights"],
                                           dtype=torch.int32))
    return {"phase": name, "device": out["device"], "groups": groups,
            "endpoints": endpoints, "ms": ms, "max_abs_err_vs_cpu": err,
            "mismatch_frac_vs_cpu": frac, "launches": launches}


def phase_plan(device: str, groups: int = FLEET_GROUPS,
               endpoints: int = FLEET_CAP, launch_counts=None) -> dict:
    """The ``plan`` command on ``device``, checked against the same
    command on the CPU."""
    return _plan_vs_cpu(
        "plan", ["plan", "--groups", str(groups), "--endpoints",
                 str(endpoints), "--seed", "0"],
        device, groups, endpoints, launch_counts)


def phase_temporal_plan(device: str, groups: int = 8, endpoints: int = 16,
                        window: int = 64, launch_counts=None) -> dict:
    """``plan --model temporal`` on ``device`` (the sizes default to the
    command's own), checked against the same command on the CPU."""
    return _plan_vs_cpu(
        "temporal_plan", ["plan", "--model", "temporal", "--groups",
                          str(groups), "--endpoints", str(endpoints),
                          "--window", str(window), "--seed", "0"],
        device, groups, endpoints, launch_counts)


def phase_temporal_eval(device: str, batches: int = EVAL_BATCHES,
                        groups: int = 64, endpoints: int = 16,
                        hidden: int = 128, window: int = 64,
                        launch_counts=None) -> dict:
    """``eval --model temporal --supervision sequence`` on ``device``
    (the sizes default to the command's own), checked against the same
    command on the CPU: mean loss within 1e-3 relative, plan L1 within
    1e-3, the same verdict against the uniform plan."""
    argv = ["eval", "--model", "temporal", "--supervision", "sequence",
            "--batches", str(batches), "--groups", str(groups),
            "--endpoints", str(endpoints), "--hidden", str(hidden),
            "--window", str(window), "--seed", "0"]
    out, ms = run_cli([*argv, "--device", device])
    launches = launch_counts() if launch_counts else {}
    ref, ref_ms = run_cli([*argv, "--device", "cpu"])
    for k in ("mean_loss", "plan_l1", "uniform_l1"):
        check(math.isfinite(out[k]), f"temporal_eval: {k} = {out[k]}")
    loss_rel = abs(out["mean_loss"] - ref["mean_loss"]) / abs(
        ref["mean_loss"])
    l1_err = abs(out["plan_l1"] - ref["plan_l1"])
    check(loss_rel <= 1e-3, f"temporal_eval: mean_loss {out['mean_loss']} "
          f"vs {ref['mean_loss']} on the CPU")
    check(l1_err <= 1e-3, f"temporal_eval: plan_l1 {out['plan_l1']} vs "
          f"{ref['plan_l1']} on the CPU")
    check(out["beats_uniform"] == ref["beats_uniform"],
          "temporal_eval: beats_uniform differs from the CPU's")
    return {"phase": "temporal_eval", **out, "ms": ms, "cpu_ms": ref_ms,
            "cpu": {k: ref[k] for k in ("mean_loss", "plan_l1",
                                        "uniform_l1", "beats_uniform")},
            "mean_loss_rel_err_vs_cpu": loss_rel,
            "plan_l1_err_vs_cpu": l1_err, "launches": launches}


def phase_temporal_seq(device: str, steps: int = SEQ_WINDOW,
                       groups: int = SEQ_GROUPS,
                       endpoints: int = SEQ_ENDPOINTS,
                       embed_dim: int = SEQ_EMBED,
                       hidden_dim: int = SEQ_HIDDEN,
                       launch_counts=None) -> dict:
    """``scores_seq`` through the flash path once on ``device``, held to
    the dense reference attention on the same device (rtol = atol =
    ``SEQ_TOL``)."""
    import numpy as np
    import torch

    from aws_global_accelerator_controller_tpu_torch.device import (
        resolve_device,
    )
    from aws_global_accelerator_controller_tpu_torch.models.temporal import (
        TemporalTrafficModel,
        synthetic_window,
    )

    dev = resolve_device(device)
    kw = dict(embed_dim=embed_dim, hidden_dim=hidden_dim,
              supervision="sequence")
    model = TemporalTrafficModel(attention="flash", **kw)
    params = model.init_params(torch.Generator().manual_seed(0), device=dev)
    window, _ = synthetic_window(np.random.default_rng(0), steps=steps,
                                 groups=groups, endpoints=endpoints,
                                 per_step=True, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    seq = model.scores_seq(params, window)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts() if launch_counts else {}
    ref = TemporalTrafficModel(attention="reference", **kw).scores_seq(
        params, window)
    got_h, ref_h = _host(seq), _host(ref)
    check(got_h.shape == (steps, groups, endpoints),
          f"temporal_seq: scores shape {got_h.shape}")
    check(bool(np.isfinite(got_h).all()), "temporal_seq: non-finite scores")
    err = float(np.abs(got_h - ref_h).max())
    check(bool(np.allclose(got_h, ref_h, rtol=SEQ_TOL, atol=SEQ_TOL)),
          f"temporal_seq: flash vs reference attention max |ds| {err} "
          f"(rtol = atol = {SEQ_TOL})")
    return {"phase": "temporal_seq", "device": str(dev), "steps": steps,
            "streams": groups * endpoints, "embed_dim": embed_dim,
            "hidden_dim": hidden_dim, "ms": ms,
            "max_abs_err_vs_reference": err, "launches": launches}


def _train_argv(model: str, groups: int, endpoints: int, hidden: int,
                window: int) -> list:
    argv = ["train", "--model", model, "--groups", str(groups),
            "--endpoints", str(endpoints), "--hidden", str(hidden),
            "--seed", "0"]
    if model == "temporal":
        argv += ["--supervision", "sequence", "--window", str(window)]
    return argv


def _train_vs_cpu(name, argv, device, steps, launch_counts):
    """``train`` on ``device`` for ``steps`` (its launches read right
    after), then for ``TRAIN_CHECK_STEPS`` on ``device`` and on the CPU:
    finite losses, the right step counts, and the two short runs' final
    losses within ``TRAIN_LOSS_RTOL``."""
    out, ms = run_cli([*argv, "--steps", str(steps), "--device", device])
    launches = launch_counts() if launch_counts else {}
    short, short_ms = run_cli([*argv, "--steps", str(TRAIN_CHECK_STEPS),
                               "--device", device])
    cpu, cpu_ms = run_cli([*argv, "--steps", str(TRAIN_CHECK_STEPS),
                           "--device", "cpu"])
    for run, n in ((out, steps), (short, TRAIN_CHECK_STEPS),
                   (cpu, TRAIN_CHECK_STEPS)):
        check(run["step"] == n and run["loss"] is not None
              and math.isfinite(run["loss"]) and "preempted" not in run,
              f"{name}: {run}")
    rel = abs(short["loss"] - cpu["loss"]) / abs(cpu["loss"])
    check(rel <= TRAIN_LOSS_RTOL,
          f"{name}: loss after {TRAIN_CHECK_STEPS} steps {short['loss']} "
          f"vs {cpu['loss']} on the CPU (rtol {TRAIN_LOSS_RTOL})")
    return {"phase": name, **out, "steps": steps, "ms": ms,
            # the two runs on the card differ only in their step count
            "ms_per_step": (ms - short_ms) / (steps - TRAIN_CHECK_STEPS),
            "check_steps": TRAIN_CHECK_STEPS, "check_loss": short["loss"],
            "cpu_loss": cpu["loss"], "cpu_ms": cpu_ms,
            "loss_rel_err_vs_cpu": rel, "launches": launches}


def phase_temporal_train(device: str, steps: int = TRAIN_STEPS,
                         groups: int = 256, endpoints: int = 32,
                         hidden: int = 128, window: int = 64,
                         launch_counts=None) -> dict:
    """``train --model temporal --supervision sequence`` on ``device``
    (the sizes default to the command's own), checked against the CPU;
    ``batch_ms`` is what one step's numpy batch and its upload take of
    ``ms_per_step``."""
    import numpy as np

    from aws_global_accelerator_controller_tpu_torch.device import (
        resolve_device,
    )
    from aws_global_accelerator_controller_tpu_torch.models.temporal import (
        synthetic_window,
    )

    out = _train_vs_cpu(
        "temporal_train",
        _train_argv("temporal", groups, endpoints, hidden, window), device,
        steps, launch_counts)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    for i in range(3):
        w, b = synthetic_window(np.random.default_rng(i), steps=window,
                                groups=groups, endpoints=endpoints,
                                per_step=True, device=dev)
        _host(b.target[0, 0, :1])            # waits for the upload
    out["batch_ms"] = (time.perf_counter() - t0) * 1e3 / 3
    return out


def phase_temporal_chunk_train(device: str, steps: int = TRAIN_STEPS,
                               groups: int = 256, endpoints: int = 32,
                               hidden: int = 128, window: int = 64,
                               chunk: int = ATTENTION_CHUNK,
                               unchunked_ms_per_step=None,
                               launch_counts=None) -> dict:
    """``train --model temporal --supervision sequence --attention-chunk
    32`` on ``device`` (the other sizes default to the command's own),
    checked against the CPU; ``unchunked_ms_per_step`` is the same
    command's unchunked time, as ``phase_temporal_train`` measured it in
    this run, recorded beside the chunked one."""
    argv = _train_argv("temporal", groups, endpoints, hidden, window)
    out = _train_vs_cpu("temporal_chunk_train",
                        [*argv, "--attention-chunk", str(chunk)], device,
                        steps, launch_counts)
    out["attention_chunk"] = chunk
    out["calls_per_step"] = -(-groups * endpoints // chunk)
    out["unchunked_ms_per_step"] = unchunked_ms_per_step
    return out


def phase_mlp_train(device: str, steps: int = TRAIN_STEPS,
                    groups: int = 256, endpoints: int = 32,
                    hidden: int = 128, launch_counts=None) -> dict:
    """``train --model mlp`` on ``device`` (the sizes default to the
    command's own), checked against the CPU."""
    return _train_vs_cpu(
        "mlp_train", _train_argv("mlp", groups, endpoints, hidden, 0),
        device, steps, launch_counts)


def phase_temporal_train_seq(device: str, steps: int = SEQ_WINDOW,
                             groups: int = SEQ_GROUPS,
                             endpoints: int = SEQ_ENDPOINTS,
                             embed_dim: int = SEQ_EMBED,
                             hidden_dim: int = SEQ_HIDDEN,
                             timed_steps: int = SEQ_TRAIN_TIMED_STEPS,
                             launch_counts=None) -> dict:
    """One adam ``train_step`` of the sequence-supervised temporal model
    on ``device``; every parameter's gradient held to the gradient
    through the dense reference attention (``parity.grads_close``); then
    ``timed_steps`` more steps timed."""
    import numpy as np
    import torch

    from aws_global_accelerator_controller_tpu_torch import parity
    from aws_global_accelerator_controller_tpu_torch.device import (
        resolve_device,
    )
    from aws_global_accelerator_controller_tpu_torch.models.common import (
        value_and_grad,
    )
    from aws_global_accelerator_controller_tpu_torch.models.temporal import (
        TemporalTrafficModel,
        synthetic_window,
    )

    dev = resolve_device(device)
    kw = dict(embed_dim=embed_dim, hidden_dim=hidden_dim,
              supervision="sequence")
    model = TemporalTrafficModel(**kw)
    params = model.init_params(torch.Generator().manual_seed(0), device=dev)
    window, batch = synthetic_window(np.random.default_rng(0), steps=steps,
                                     groups=groups, endpoints=endpoints,
                                     per_step=True, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    state = model.init_opt_state(params)
    sync()
    t0 = time.perf_counter()
    new, state, loss = model.train_step(params, state, window, batch)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts() if launch_counts else {}
    check(math.isfinite(float(loss)), f"temporal_train_seq: loss {loss}")
    check(all(bool(torch.isfinite(x.float()).all()) for x in new.values()),
          "temporal_train_seq: non-finite params after the step")
    _, grads = value_and_grad(model.loss, params, window, batch)
    _, ref = value_and_grad(
        TemporalTrafficModel(attention="reference", **kw).loss, params,
        window, batch)
    errs = {k: parity.grad_error(_host(g.float()), _host(ref[k].float()))
            for k, g in grads.items()}
    check(all(e <= 1.0 for e in errs.values()),
          f"temporal_train_seq: flash vs reference gradients (error / "
          f"tolerance, rtol {parity.GRAD_RTOL} atol {parity.GRAD_ATOL}): "
          f"{errs}")
    del grads, ref
    sync()
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        new, state, loss = model.train_step(new, state, window, batch)
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3 / max(timed_steps, 1)
    check(math.isfinite(float(loss)), f"temporal_train_seq: loss {loss}")
    return {"phase": "temporal_train_seq", "device": str(dev),
            "steps": steps, "streams": groups * endpoints,
            "embed_dim": embed_dim, "hidden_dim": hidden_dim,
            "loss": float(loss), "first_step_ms": ms,
            "ms_per_step": step_ms, "timed_steps": timed_steps,
            "grad_error_vs_reference": errs, "launches": launches}


def phase_temporal_chunk_train_seq(device: str, steps: int = SEQ_WINDOW,
                                   groups: int = SEQ_GROUPS,
                                   endpoints: int = SEQ_ENDPOINTS,
                                   embed_dim: int = SEQ_EMBED,
                                   hidden_dim: int = SEQ_HIDDEN,
                                   chunk: int = ATTENTION_CHUNK,
                                   timed_steps: int = SEQ_TRAIN_TIMED_STEPS,
                                   launch_counts=None) -> dict:
    """One adam ``train_step`` at ``phase_temporal_train_seq``'s shape
    with ``attention_chunk=chunk`` on ``device`` (128 streams: 4 calls,
    each backward on K9); every parameter's gradient held to the
    unchunked model's (one call, the backward on K7 and K8) within the
    gradient tolerance (``parity.grads_close``) and, on the card, bit for
    bit (each head's K6b does not depend on the call's other heads, and
    K9 does K7's and K8's products in their f32 order); then
    ``timed_steps`` steps of each model timed."""
    import numpy as np
    import torch

    from aws_global_accelerator_controller_tpu_torch import parity
    from aws_global_accelerator_controller_tpu_torch.device import (
        resolve_device,
    )
    from aws_global_accelerator_controller_tpu_torch.models.common import (
        value_and_grad,
    )
    from aws_global_accelerator_controller_tpu_torch.models.temporal import (
        TemporalTrafficModel,
        synthetic_window,
    )

    dev = resolve_device(device)
    kw = dict(embed_dim=embed_dim, hidden_dim=hidden_dim,
              supervision="sequence")
    chunked = TemporalTrafficModel(attention_chunk=chunk, **kw)
    whole = TemporalTrafficModel(**kw)
    params = chunked.init_params(torch.Generator().manual_seed(0),
                                 device=dev)
    window, batch = synthetic_window(np.random.default_rng(0), steps=steps,
                                     groups=groups, endpoints=endpoints,
                                     per_step=True, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    new, _, loss = chunked.train_step(
        params, chunked.init_opt_state(params), window, batch)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts() if launch_counts else {}
    check(math.isfinite(float(loss)),
          f"temporal_chunk_train_seq: loss {loss}")
    check(all(bool(torch.isfinite(x.float()).all()) for x in new.values()),
          "temporal_chunk_train_seq: non-finite params after the step")
    c_loss, c_grads = value_and_grad(chunked.loss, params, window, batch)
    w_loss, w_grads = value_and_grad(whole.loss, params, window, batch)
    errs = {k: parity.grad_error(_host(g.float()),
                                 _host(w_grads[k].float()))
            for k, g in c_grads.items()}
    check(all(e <= 1.0 for e in errs.values()),
          f"temporal_chunk_train_seq: chunked (K9) vs unchunked (K7, K8) "
          f"gradients (error / tolerance, rtol {parity.GRAD_RTOL} atol "
          f"{parity.GRAD_ATOL}): {errs}")
    equal = all(torch.equal(g, w_grads[k]) for k, g in c_grads.items())
    check(equal or dev.type != "cuda",
          "temporal_chunk_train_seq: chunked (K9) and unchunked (K7, K8) "
          "gradients differ on the card")
    loss_rel = abs(float(c_loss) - float(w_loss)) / abs(float(w_loss))
    check(loss_rel <= 1e-4, f"temporal_chunk_train_seq: chunked loss "
          f"{float(c_loss)} vs unchunked {float(w_loss)}")
    del c_grads, w_grads

    def step_ms(model):
        p, state = params, model.init_opt_state(params)
        p, state, _ = model.train_step(p, state, window, batch)   # warm
        sync()
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            p, state, lo = model.train_step(p, state, window, batch)
        sync()
        check(math.isfinite(float(lo)),
              f"temporal_chunk_train_seq: loss {lo}")
        return (time.perf_counter() - t0) * 1e3 / max(timed_steps, 1)

    return {"phase": "temporal_chunk_train_seq", "device": str(dev),
            "steps": steps, "streams": groups * endpoints,
            "attention_chunk": chunk, "embed_dim": embed_dim,
            "hidden_dim": hidden_dim, "loss": float(loss),
            "first_step_ms": ms, "ms_per_step": step_ms(chunked),
            "unchunked_ms_per_step": step_ms(whole),
            "timed_steps": timed_steps, "loss_rel_err_vs_unchunked":
            loss_rel, "grad_error_vs_unchunked": errs,
            "grads_equal_to_unchunked": equal, "launches": launches}


def phase_temporal_fused_train(device: str, steps: int = TRAIN_STEPS,
                               groups: int = 256, endpoints: int = 32,
                               hidden: int = 128, window: int = 64,
                               embed_dim: int = 32,
                               check_steps: int = TRAIN_CHECK_STEPS,
                               launch_counts=None) -> dict:
    """``TemporalTrafficModel(head="fused", supervision="sequence")``
    trained with adam through its model API (the CLI selects no head, as
    in the reference) at the train command's default shape on
    ``device``, on the train command's batch stream: ``steps`` steps
    timed, then ``check_steps`` steps on ``device`` and on the CPU with
    ``head="fused_always"`` (the kernels' plain versions), final losses
    within ``TRAIN_LOSS_RTOL``; one batch's loss (rtol 1e-4) and
    gradients (``parity.grads_close``) against the dense head on
    ``device``; and ``steps`` steps of the dense-head model timed beside
    it."""
    import numpy as np
    import torch

    from aws_global_accelerator_controller_tpu_torch import parity
    from aws_global_accelerator_controller_tpu_torch.cmd.compute import (
        TRAIN_STREAM,
    )
    from aws_global_accelerator_controller_tpu_torch.device import (
        resolve_device,
    )
    from aws_global_accelerator_controller_tpu_torch.models.common import (
        value_and_grad,
    )
    from aws_global_accelerator_controller_tpu_torch.models.temporal import (
        TemporalTrafficModel,
        synthetic_window,
    )

    dev = resolve_device(device)
    cpu = torch.device("cpu")
    kw = dict(embed_dim=embed_dim, hidden_dim=hidden,
              supervision="sequence")
    fused = TemporalTrafficModel(head="fused", **kw)
    dense = TemporalTrafficModel(**kw)
    init = fused.init_params(torch.Generator().manual_seed(0), device=cpu)

    def batch(step, d):
        return synthetic_window(np.random.default_rng((0, TRAIN_STREAM,
                                                       step)),
                                steps=window, groups=groups,
                                endpoints=endpoints, per_step=True,
                                device=d)

    def sync(d):
        if d.type == "cuda":
            torch.cuda.synchronize(d)

    def train(model, d, n):
        """(final loss, wall ms) of ``n`` steps from ``init`` on ``d``."""
        params = {k: v.to(d) for k, v in init.items()}
        state = model.init_opt_state(params)
        sync(d)
        t0 = time.perf_counter()
        for step in range(n):
            params, state, loss = model.train_step(params, state,
                                                   *batch(step, d))
        loss = float(loss)
        sync(d)
        check(math.isfinite(loss), f"temporal_fused_train: loss {loss}")
        return loss, (time.perf_counter() - t0) * 1e3

    loss, ms = train(fused, dev, steps)
    launches = launch_counts() if launch_counts else {}
    check_loss, check_ms = train(fused, dev, check_steps)
    cpu_loss, cpu_ms = train(TemporalTrafficModel(head="fused_always", **kw),
                             cpu, check_steps)
    rel = abs(check_loss - cpu_loss) / abs(cpu_loss)
    check(rel <= TRAIN_LOSS_RTOL,
          f"temporal_fused_train: loss after {check_steps} steps "
          f"{check_loss} vs {cpu_loss} on the CPU (rtol {TRAIN_LOSS_RTOL})")
    params = {k: v.to(dev) for k, v in init.items()}
    w, b = batch(0, dev)
    f_loss, f_grads = value_and_grad(fused.loss, params, w, b)
    d_loss, d_grads = value_and_grad(dense.loss, params, w, b)
    head_rel = abs(float(f_loss) - float(d_loss)) / abs(float(d_loss))
    errs = {k: parity.grad_error(_host(g.float()), _host(d_grads[k].float()))
            for k, g in f_grads.items()}
    head_size = {k: float(d_grads[k].float().abs().max())
                 for k in ("w1", "b1", "w2", "b2")}
    check(head_rel <= 1e-4, f"temporal_fused_train: fused-head loss "
          f"{float(f_loss)} vs dense {float(d_loss)}")
    check(all(e <= 1.0 for e in errs.values()),
          f"temporal_fused_train: fused vs dense head gradients (error / "
          f"tolerance, rtol {parity.GRAD_RTOL} atol {parity.GRAD_ATOL}): "
          f"{errs}")
    del f_grads, d_grads, params
    dense_loss, dense_ms = train(dense, dev, steps)
    per_step = (ms - check_ms) / max(steps - check_steps, 1)
    return {"phase": "temporal_fused_train", "device": str(dev),
            "steps": steps, "streams": groups * endpoints, "window": window,
            "embed_dim": embed_dim, "hidden_dim": hidden, "loss": loss,
            "ms": ms, "ms_per_step": per_step, "check_steps": check_steps,
            "check_loss": check_loss, "cpu_loss": cpu_loss,
            "cpu_ms": cpu_ms, "loss_rel_err_vs_cpu": rel,
            "loss_rel_err_vs_dense_head": head_rel,
            "grad_error_vs_dense_head": errs,
            "head_grad_max_abs": head_size, "dense_head_loss": dense_loss,
            "dense_head_ms": dense_ms,
            "dense_head_ms_per_step": dense_ms / max(steps, 1),
            "fused_head_ms_per_step": ms / max(steps, 1),
            "launches": launches}


def _compare_fleet(name, got, want):
    import numpy as np

    check(np.array_equal(got.to_add, want.to_add)
          and np.array_equal(got.to_remove, want.to_remove),
          f"{name}: memberships differ")
    err, frac = check_weights(name, got.desired_w, want.desired_w)
    differ = got.desired_w != want.desired_w
    check(not bool(((got.to_reweight != want.to_reweight) & ~differ).any()),
          f"{name}: to_reweight differs where the weights agree")
    return err, frac


def phase_fleet(device: str, groups: int = FLEET_GROUPS,
                shards: int = FLEET_SHARDS, cap: int = FLEET_CAP,
                launch_counts=None) -> dict:
    """``WholeFleetPlanner`` on ``device`` (one warm and one timed
    pass), checked against the same planner and params on the CPU."""
    from aws_global_accelerator_controller_tpu_torch.parallel.fleet_plan \
        import WholeFleetPlanner
    from aws_global_accelerator_controller_tpu_torch.reconcile.columnar \
        import pack_fleet

    t0 = time.perf_counter()
    fleet = pack_fleet(fleet_plan_groups(groups, shards), endpoints_cap=cap,
                       shards=shards)
    pack_ms = (time.perf_counter() - t0) * 1e3
    planner = WholeFleetPlanner(seed=0, device=device)
    planner.plan(fleet)                      # warm
    t0 = time.perf_counter()
    result = planner.plan(fleet)
    plan_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    intents = result.intents()
    decode_ms = (time.perf_counter() - t0) * 1e3
    out = {"phase": "whole_fleet", "device": result.device,
           "groups": groups, "shards": shards, "endpoints_cap": cap,
           "mean_occupancy": result.stats["live_endpoints"] / groups,
           "pack_ms": pack_ms, "plan_ms": plan_ms, "decode_ms": decode_ms,
           "mutating_groups": sum(1 for i in intents if i.ops),
           "launches": launch_counts() if launch_counts else {}}
    if planner.device.type == "cuda":
        fn, rows, rest = planner.prepare(fleet)
        out["device_pass_ms"] = time_device(
            lambda: fn(planner.params, rows, *rest))
        out["device_pass_eager_ms"] = time_eager(
            lambda: fn(planner.params, rows, *rest), iters=20)
        ref = WholeFleetPlanner(params=planner.params, device="cpu")
        err, frac = _compare_fleet("whole fleet vs cpu", result,
                                   ref.plan(fleet))
        out["max_abs_err_vs_cpu"], out["mismatch_frac_vs_cpu"] = err, frac
    check(out["mutating_groups"] > 0, "whole fleet: no mutation planned")
    return out


def phase_resident(device: str, groups: int = RESIDENT_GROUPS,
                   shards: int = RESIDENT_SHARDS, cap: int = RESIDENT_CAP,
                   launch_counts=None) -> dict:
    """Resident waves on ``device``: build, cold wave, churn waves, a
    clean wave that must not touch the device, then the full-repack
    bit-match."""
    from aws_global_accelerator_controller_tpu_torch.parallel.fleet_plan \
        import ResidentFleetPlanner
    from aws_global_accelerator_controller_tpu_torch.reconcile.resident \
        import ResidentFleet

    gen = ResidentFleetGen(groups, shards)
    t0 = time.perf_counter()
    fleet = ResidentFleet(shards=shards, endpoints_cap=cap, feature_dim=F,
                          groups_per_shard=-(-groups // shards))
    for i in range(groups):
        fleet.upsert(gen.group(i, 0))
    build_s = time.perf_counter() - t0
    planner = ResidentFleetPlanner(fleet, seed=0, device=device)
    t0 = time.perf_counter()
    cold = planner.plan_wave()
    cold_ms = (time.perf_counter() - t0) * 1e3
    check(cold.device_call and cold.dirty_groups == groups,
          "resident: the cold wave did not plan every group")
    after_cold = launch_counts() if launch_counts else None
    n_mut = max(1, int(groups * RESIDENT_DIRT))
    rows = []
    for wv in range(RESIDENT_WAVES):
        start = (groups // 3 + wv * n_mut) % (groups - n_mut)
        t0 = time.perf_counter()
        for i in range(start, start + n_mut):
            fleet.upsert(gen.group(i, wv + 1))
        ingest_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        w = planner.plan_wave()
        plan_ms = (time.perf_counter() - t0) * 1e3
        check(w.device_call and w.dirty_groups == n_mut,
              f"resident wave {wv}: {w.dirty_groups} dirty groups")
        rows.append({"dirty_shards": w.dirty_shards,
                     "dirty_groups": w.dirty_groups,
                     "ingest_ms": ingest_ms, "plan_ms": plan_ms,
                     "rescored_groups": w.stats["rescored_groups"],
                     "reweights": w.stats["reweights"]})
        check(w.stats["rescored_groups"] > 0,
              f"resident wave {wv}: no group rescored")
        planner.flush_complete()
    # the waves' launches, read before the oracle pass launches its own
    launches = launch_counts() if launch_counts else {}
    churn = {k: v - after_cold[k] for k, v in launches.items()} \
        if launch_counts else {}
    if launch_counts and planner.device.type == "cuda":
        missing = [k for k in WAVE_KERNELS if churn.get(k, 0) == 0]
        check(not missing,
              f"resident: the churn waves never launched {missing}")
    calls = planner.device_calls
    clean = planner.plan_wave()
    check(not clean.device_call and planner.device_calls == calls,
          "resident: a clean wave touched the device")
    if launch_counts:
        check(launch_counts() == launches,
              "resident: a clean wave launched a kernel")
    t0 = time.perf_counter()
    verdict = planner.verify_full_repack()
    verify_s = time.perf_counter() - t0
    verify_launches = {k: v - launches[k]
                       for k, v in launch_counts().items()} \
        if launch_counts else {}
    check(verdict["match"] is True,
          f"resident: incremental plan differs from the full repack: "
          f"{verdict}")
    return {"phase": "resident", "device": str(planner.device),
            "groups": groups, "shards": shards, "endpoints_cap": cap,
            "dirt": RESIDENT_DIRT, "build_s": build_s,
            "cold_wave_ms": cold_ms, "waves": rows,
            "clean_wave_device_call": clean.device_call,
            "verify_full_repack": verdict, "verify_s": verify_s,
            "launches": launches,
            "churn_launches": {k: v for k, v in churn.items() if v},
            "verify_launches": {k: v for k, v in verify_launches.items()
                                if v}}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def run_path_phase(name, fn, expect, build, records, exact=None):
    """Zero the launch counts, drive one phase of the main path, and
    demand that each kernel in ``expect`` launched in it and each kernel
    in ``exact`` exactly that many times (the phase reads the counts
    right after its path ran); the phase's record goes into
    ``records`` under ``name``."""
    build.reset_launch_counts()
    out = fn(build.launch_counts)
    counts = {k: v for k, v in out["launches"].items() if v}
    out["launches"] = counts
    records[name] = out
    missing = [k for k in expect if counts.get(k, 0) == 0]
    check(not missing, f"{name}: kernels never launched: {missing}")
    for k, n in (exact or {}).items():
        check(counts.get(k, 0) == n,
              f"{name}: {k} launched {counts.get(k, 0)} times, not {n}")
    log(json.dumps(out))
    return counts


def main() -> int:
    if not (ROOT / PKG).is_dir():
        print(f"chip_smoke: {PKG}/ not found beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from aws_global_accelerator_controller_tpu_torch.kernels import build

    t_all = time.perf_counter()
    card = card_line()
    t0 = time.perf_counter()
    build.library()
    log(json.dumps({"phase": "build",
                    "seconds": time.perf_counter() - t0}))

    # the path first: its first use of the card runs the device probe
    # (K1), as in any fresh process
    totals, records = {}, {}
    train_once = {K6B: 1, K7: 1, K8: 1, K9: 0, K6A: 0}
    # flash calls a step with --attention-chunk: the train command's
    # default 256 x 32 streams, and the production shape's 8 x 16
    train_calls = 256 * 32 // ATTENTION_CHUNK
    seq_calls = SEQ_GROUPS * SEQ_ENDPOINTS // ATTENTION_CHUNK
    chunked_once = {K6B: train_calls, K9: train_calls, K7: 0, K8: 0,
                    K6A: 0}
    no_head = {K10: 0, K11: 0}
    path = (("plan", lambda c: phase_plan("cuda", launch_counts=c),
             ("probe_double", "fused_mlp_plan"), no_head),
            ("whole_fleet", lambda c: phase_fleet("cuda", launch_counts=c),
             ("fused_mlp_scores", "plan_weights"), no_head),
            ("resident", lambda c: phase_resident("cuda", launch_counts=c),
             WAVE_KERNELS, no_head),
            ("temporal_plan",
             lambda c: phase_temporal_plan("cuda", launch_counts=c),
             (), {K6A: 0, **no_head}),
            ("temporal_eval",
             lambda c: phase_temporal_eval("cuda", launch_counts=c),
             (K6A,), {K6A: EVAL_BATCHES, **no_head}),
            ("temporal_seq",
             lambda c: phase_temporal_seq("cuda", launch_counts=c),
             (K6A,), {K6A: 1, **no_head}),
            ("temporal_train",
             lambda c: phase_temporal_train("cuda", launch_counts=c),
             (K6B, K7, K8),
             {**{k: n * TRAIN_STEPS for k, n in train_once.items()},
              **no_head}),
            ("temporal_train_seq",
             lambda c: phase_temporal_train_seq("cuda", launch_counts=c),
             (K6B, K7, K8), {**train_once, **no_head}),
            ("temporal_chunk_train",
             lambda c: phase_temporal_chunk_train(
                 "cuda", launch_counts=c, unchunked_ms_per_step=records[
                     "temporal_train"]["ms_per_step"]),
             (K6B, K9),
             {**{k: n * TRAIN_STEPS for k, n in chunked_once.items()},
              **no_head}),
            ("temporal_chunk_train_seq",
             lambda c: phase_temporal_chunk_train_seq("cuda",
                                                      launch_counts=c),
             (K6B, K9), {K6B: seq_calls, K9: seq_calls, K7: 0, K8: 0,
                         K6A: 0, **no_head}),
            ("mlp_train", lambda c: phase_mlp_train("cuda", launch_counts=c),
             (), {**{k: 0 for k in train_once}, **no_head}),
            ("temporal_fused_train",
             lambda c: phase_temporal_fused_train("cuda", launch_counts=c),
             (K6B, K7, K8, K10, K11),
             {k: n * TRAIN_STEPS for k, n in
              {**train_once, K10: 1, K11: 1}.items()}))
    for name, fn, expect, exact in path:
        t0 = time.perf_counter()
        counts = run_path_phase(name, fn, expect, build, records, exact)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        log(json.dumps({"phase": name + "_wall",
                        "seconds": time.perf_counter() - t0}))

    t0 = time.perf_counter()
    kernels = phase_kernels()
    log(json.dumps(phase_flash_crossover()))
    log(json.dumps({"phase": "kernels",
                    "seconds": time.perf_counter() - t0}))

    for rec in kernels:
        rec["launches"] = totals.get(rec["name"], 0)
        check(rec["launches"] > 0, f"{rec['name']} not on the path")
        for k in ("ms", "plain_ms", "bound_ms", "library_ms"):
            v = rec[k]
            check(v is None or (math.isfinite(v) and v >= 0),
                  f"{rec['name']}: {k} = {v}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"phase": "total",
                    "seconds": time.perf_counter() - t_all}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
