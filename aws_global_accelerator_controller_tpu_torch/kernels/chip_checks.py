"""Checks of the kernels that need the card: two that need more than
one build, and a profile of the train step.

``ab TREE_A TREE_B``: device times of K3 (both entries, H = 128 and 256),
of K10 and K11 (the train command's default shape and the reference's
own head shape) and of K9 (32 heads at T = 64, 1024 and 1536 with
D = 32, and at T = 256 and 2048 with D = 128) in two checkouts, each in a fresh process
with its own build, in the order A, B, B, A, so that a drift of the
card's clock over the run falls on both alike.  This is how two
versions of a kernel are compared.

``faults``: plants faults in K11's weight-gradient sums and in K9's
sums, each in a copy of this checkout made in a temporary directory,
and demands that the kernel's card tests and ``chip_smoke.py``'s check
of it fail on every one, the latter at every shape where the fault
changes the result:

- K11 (the card test over many row tiles; ``chip_smoke.py`` at both
  shapes): ``half_partials``, the second kernel sums every other CTA's
  partial; ``first_tile_only``, each CTA adds only its first row tile
  into dw1, db1 and dw2; ``zero_weight_grads``, the weight gradients
  come out zero;
- K9 (the card tests of the fused backward, T up to 200 and T = 2048;
  ``chip_smoke.py`` at T = 2048 and T = 1024, which have
  several K blocks, and at T = 64 where the fault touches one):
  ``dq_skips_k_block_0``, dq misses the contribution of K block 0;
  ``dkv_first_q_block_only``, dk and dv sum over the first live q
  block only (no change where T has one block);
  ``dq_last_block_unscaled``, the last q block's dq is not scaled by
  D**-0.5.

``profile``: ``torch.profiler`` over ``--steps`` (3) sequence-supervised
train steps of the temporal model, by default at the train command's
defaults (``--window 64 --groups 256 --endpoints 32 --embed 32 --hidden
128``) with ``--chunks 0 32`` (unchunked and ``attention_chunk=32``),
after as many warm steps each, on batches made
beforehand: wall ms a step, the device's busy ms a step (the sum of
every kernel's device time) and the ops that take the most host and
device time.

``ring``, run by ``torch.distributed.run``: every rank of a 1-D seq ring
(gloo, host-staged) on ``--device`` attends its block of a causal
[T, H, D] bf16 q, k, v (made from ``--seed`` alike on every rank)
through ``make_ring_attention(local="flash")``, kernel K6b-ring, and
takes the gradients of sum(o * w); rank 0 gathers the blocks and holds
o against the dense ``attention_reference`` on the gathered inputs
(2 bf16 ulps of the magnitude) and against the ring with the einsum
local, and dq, dk, dv against dense autograd in f32 within 4 bf16 ulps
of each head's largest gradient (the ring, as the reference's, rounds o
and the cotangent to bf16 and takes dvec from them, which moves a
gradient by about an ulp of the largest terms it sums); rank s must
launch K6b-ring s + 1 times.  It prints one JSON object and exits
non-zero if a check fails.

``gloo``, run by ``torch.distributed.run`` on 2 ranks: whether gloo
takes CUDA tensors as they are (``all_reduce``, ``all_gather`` and a
``batch_isend_irecv`` hop), which decides whether the sharded path must
stage them through the host; each op's verdict (right, wrong, or
gloo's error) is printed by rank 0 as it comes.  A refused hop leaves
gloo's connection closed, and the run then ends non-zero.

Run from the root of a checkout, on a machine with one card::

    python3 -m aws_global_accelerator_controller_tpu_torch.kernels.chip_checks ab build/parent .
    python3 -m aws_global_accelerator_controller_tpu_torch.kernels.chip_checks faults [NAME ...]
    python3 -m aws_global_accelerator_controller_tpu_torch.kernels.chip_checks profile [--window T --chunks 0 32 ...]
    python3 -m torch.distributed.run --standalone --nproc-per-node 4 -m aws_global_accelerator_controller_tpu_torch.kernels.chip_checks ring --device cuda:0
    python3 -m torch.distributed.run --standalone --nproc-per-node 2 -m aws_global_accelerator_controller_tpu_torch.kernels.chip_checks gloo --device cuda:0

Each prints one JSON object a run (a train step setting), and ``faults``
exits non-zero if a fault went unnoticed.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PKG = "aws_global_accelerator_controller_tpu_torch"

# run inside a checkout: prints {row: device ms} of its kernels
_TIME = r"""
import json, torch, chip_smoke as cs
from aws_global_accelerator_controller_tpu_torch.ops.cuda_mlp import (
    forward_cuda, score_rows_cuda)
from aws_global_accelerator_controller_tpu_torch.ops import cuda_head as ch
from aws_global_accelerator_controller_tpu_torch.ops import cuda_attention as ca
from aws_global_accelerator_controller_tpu_torch.kernels import build
build.library()
out = {}
for H in (128, 256):
    p = cs._mlp_params(3, H)
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(cs.FLEET_GROUPS, cs.FLEET_CAP, cs.F, device="cuda",
                    generator=g).to(torch.bfloat16)
    m = torch.rand(cs.FLEET_GROUPS, cs.FLEET_CAP, device="cuda",
                   generator=g) < 0.8
    rows = torch.randn(65536, cs.F, device="cuda", generator=g)
    out[f"fused_mlp_plan H={H}"] = cs.time_device(
        lambda: forward_cuda(p, x, m))
    out[f"fused_mlp_scores H={H}"] = cs.time_device(
        lambda: score_rows_cuda(p, rows))
for T, S, D, H in ((64, 8192, 32, 128), (2048, 128, 128, 256)):
    x, w1, b1, w2, b2, ds = cs._head_inputs(T, S, D, H, 13)
    shape = f"T={T} S={S} D={D} H={H}"
    out["score_head_fwd " + shape] = cs.time_device(
        lambda: ch.score_head_forward(x, w1, b1, w2, b2))
    out["score_head_bwd " + shape] = cs.time_device(
        lambda: ch.score_head_bwd(x, w1, b1, w2, b2, ds))
for T, S, D in ((64, 32, 32), (1024, 32, 32), (1536, 32, 32),
                (256, 32, 128), (2048, 32, 128)):
    g = torch.Generator(device="cuda").manual_seed(15)
    q, k, v, do = (torch.randn(T, S, D, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    o, m, l = ca.flash_attention_stats(q, k, v)
    dvec = ca.attention_dvec(o, do)
    out[f"flash_bwd_dqkv T={T} S={S} D={D}"] = cs.time_device(
        lambda: ca.flash_bwd_dqkv(q, k, v, do, m, l, dvec))
print(json.dumps(out))
"""

# run inside a checkout: a kernel's check in chip_smoke.py at each shape
# of ``shapes`` (a call of ``fn`` each), one error line per failed shape
_SMOKE = r"""
import chip_smoke as cs
from aws_global_accelerator_controller_tpu_torch.kernels import build
build.library()
errors = []
for args in {shapes}:
    try:
        cs.{fn}(*args, iters=2, eager_iters=2)
    except cs.SmokeError as e:
        errors.append(str(e))
print("\n".join(errors))
raise SystemExit(1 if errors else 0)
"""

_HEAD_SRC = f"{PKG}/csrc/score_head.cu"
_DQKV_SRC = f"{PKG}/csrc/flash_attention_dqkv.cu"
#: name -> (source, a text of it once, the faulty replacement)
FAULTS = {
    "half_partials": (
        _HEAD_SRC,
        "for (int c = 0; c < ctas; ++c) s += partials[c * n + e];",
        "for (int c = 0; c < ctas; c += 2) s += partials[c * n + e];"),
    "first_tile_only": (
        _HEAD_SRC,
        "      for (int tile = tile0; tile < tile1; ++tile) {\n"
        "        const int row0 = tile * kBlock;\n"
        "        float acc",
        "      for (int tile = tile0; tile < min(tile1, tile0 + 1); ++tile) "
        "{\n"
        "        const int row0 = tile * kBlock;\n"
        "        float acc"),
    "zero_weight_grads": (_HEAD_SRC, "  out[e] = s;", "  out[e] = 0.f;"),
    "dq_skips_k_block_0": (
        _DQKV_SRC,
        "          mma_kn(acc, dsa[kk], ks, kStride, nt * 8, kk);",
        "          if (kb > 0) mma_kn(acc, dsa[kk], ks, kStride, nt * 8, "
        "kk);"),
    "dkv_first_q_block_only": (
        _DQKV_SRC,
        "            mma_kn(dva[nt], pa, dos, kStride, nt * 8, kq);\n"
        "            mma_kn(dka[nt], dsa, qs, kStride, nt * 8, kq);",
        "            if (qb == (causal ? kb : 0)) {\n"
        "            mma_kn(dva[nt], pa, dos, kStride, nt * 8, kq);\n"
        "            mma_kn(dka[nt], dsa, qs, kStride, nt * 8, kq);\n"
        "            }"),
    "dq_last_block_unscaled": (
        _DQKV_SRC,
        "pack_bf16(rows[8 * kDPad * r + col] * scale,\n"
        "                        rows[8 * kDPad * r + col + 1] * scale);",
        "pack_bf16(rows[8 * kDPad * r + col] * (qb == n_blocks - 1 ? 1.f : "
        "scale),\n"
        "                        rows[8 * kDPad * r + col + 1] * "
        "(qb == n_blocks - 1 ? 1.f : scale));"),
}
#: source -> (card tests (-k), chip_smoke function, its shapes, how many
#: of them each fault must fail)
CHECKS = {
    _HEAD_SRC: ("over_many_row_tiles", "_head_rows_one",
                ((64, 8192, 32, 128, 13), (2048, 128, 128, 256, 14)), 2),
    _DQKV_SRC: ("fused_backward_kernel", "_k9_one",
                ((64, 32, 32, 15), (2048, 32, 128, 16),
                 (1024, 32, 160, 17)), 2),
}


def _run(cmd, cwd, timeout=900):
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def ab(tree_a: str, tree_b: str) -> int:
    card = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], ROOT, timeout=60)
    print(json.dumps({"card": card.stdout.strip()}), flush=True)
    runs = []
    for name, tree in (("A", tree_a), ("B", tree_b), ("B", tree_b),
                       ("A", tree_a)):
        r = _run([sys.executable, "-c", _TIME], Path(tree).resolve())
        if r.returncode:
            print(r.stdout, r.stderr[-4000:], file=sys.stderr)
            return 1
        ms = json.loads(r.stdout.strip().splitlines()[-1])
        runs.append({"tree": name, "path": tree, "ms": ms})
        print(json.dumps(runs[-1]), flush=True)
    mean = {name: {k: sum(r["ms"][k] for r in runs if r["tree"] == name) / 2
                   for k in runs[0]["ms"]} for name in ("A", "B")}
    print(json.dumps({"mean_ms": mean}), flush=True)
    return 0


def _copy(dst: Path) -> None:
    shutil.copytree(ROOT / PKG, dst / PKG,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    (dst / "tests").mkdir()
    shutil.copy2(ROOT / "tests" / "test_torch_cuda.py",
                 dst / "tests" / "test_torch_cuda.py")


def faults(names=None) -> int:
    unnoticed = []
    for name in names or FAULTS:
        src_name, old, new = FAULTS[name]
        tests, fn, shapes, must_fail = CHECKS[src_name]
        with tempfile.TemporaryDirectory() as tmp:
            dst = Path(tmp)
            _copy(dst)
            src = dst / src_name
            text = src.read_text()
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the text to change is not in "
                                 f"{src_name} once")
            src.write_text(text.replace(old, new))
            test = _run([sys.executable, "-m", "pytest", "--noconftest",
                         "-q", "-p", "no:cacheprovider",
                         "tests/test_torch_cuda.py", "-k", tests], dst)
            smoke = _run([sys.executable, "-c",
                          _SMOKE.format(fn=fn, shapes=shapes)], dst)
            failed = [ln for ln in test.stdout.splitlines()
                      if "assert" in ln or ln.startswith("E ")]
            rec = {"fault": name, "card_test_rc": test.returncode,
                   "card_test": failed[-6:] or test.stdout[-600:],
                   "card_test_summary": test.stdout.strip().splitlines()[-1:],
                   "chip_smoke_rc": smoke.returncode,
                   "chip_smoke": smoke.stdout.strip().splitlines()
                   or smoke.stderr[-600:]}
            print(json.dumps(rec), flush=True)
            # 1: the tests failed (not 2-5: a usage or collection error);
            # the smoke check raised SmokeError at enough shapes
            if test.returncode != 1 or smoke.returncode != 1 or len(
                    rec["chip_smoke"]) < must_fail:
                unnoticed.append(name)
    print(json.dumps({"faults_unnoticed": unnoticed}), flush=True)
    return 1 if unnoticed else 0


def profile(steps: int = 3, top: int = 12, window: int = 64,
            groups: int = 256, endpoints: int = 32, embed: int = 32,
            hidden: int = 128, chunks=(0, 32)) -> int:
    import time

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from ..models.temporal import TemporalTrafficModel, synthetic_window

    def device_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) / 1e3

    batches = [synthetic_window(np.random.default_rng(i), steps=window,
                                groups=groups, endpoints=endpoints,
                                per_step=True, device="cuda")
               for i in range(steps)]
    for chunk in chunks:
        model = TemporalTrafficModel(embed_dim=embed, hidden_dim=hidden,
                                     supervision="sequence",
                                     attention_chunk=chunk)
        params = model.init_params(torch.Generator().manual_seed(0),
                                   device="cuda")
        state = model.init_opt_state(params)
        for w, b in batches:                                   # warm
            params, state, _ = model.train_step(params, state, w, b)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for w, b in batches:
                params, state, loss = model.train_step(params, state, w, b)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
        events = prof.key_averages()
        by_cpu = sorted(events, key=lambda e: e.self_cpu_time_total,
                        reverse=True)[:top]
        by_dev = sorted(events, key=device_ms, reverse=True)[:top]
        print(json.dumps({
            "window": window, "streams": groups * endpoints,
            "embed_dim": embed, "hidden_dim": hidden,
            "attention_chunk": chunk, "steps": steps, "loss": float(loss),
            "wall_ms_per_step": wall,
            # kernels only: an op's self device time repeats its kernels'
            "device_busy_ms_per_step": sum(
                device_ms(e) for e in events
                if e.device_type == DeviceType.CUDA) / steps,
            "top_self_cpu_ms_per_step": {
                e.key: [e.self_cpu_time_total / 1e3 / steps,
                        e.count // steps] for e in by_cpu},
            "top_self_device_ms_per_step": {
                e.key[:80]: [device_ms(e) / steps, e.count // steps]
                for e in by_dev}}), flush=True)
    return 0


def ring(device: str = "cuda", T: int = 512, H: int = 256, D: int = 32,
         seed: int = 0) -> int:
    import time

    import numpy as np
    import torch

    from .. import parity
    from ..parallel.distributed import join_world, staged_bytes
    from ..parallel.mesh import make_mesh
    from ..parallel.ring_attention import (
        attention_reference,
        make_ring_attention,
    )
    from .build import launch_counts, reset_launch_counts

    torch.backends.cuda.matmul.allow_tf32 = False     # f32 is f32
    with join_world(device) as world:
        mesh = make_mesh(world, ("seq",))
        n, s = mesh.shape["seq"], mesh.coords["seq"]
        g = torch.Generator().manual_seed(seed)
        q, k, v = (torch.randn(T, H, D, generator=g).to(torch.bfloat16)
                   for _ in range(3))
        w = torch.randn(T, H, D, generator=g)
        b = T // n
        rows = slice(s * b, (s + 1) * b)
        leaves = [x[rows].contiguous().to(world.device).requires_grad_(True)
                  for x in (q, k, v)]
        def sync():
            if world.device.type == "cuda":
                torch.cuda.synchronize(world.device)

        reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        o = make_ring_attention(mesh, causal=True, local="flash")(*leaves)
        (o.float() * w[rows].to(world.device)).sum().backward()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        launches = launch_counts()["flash_attention_stats_ring"]
        with torch.no_grad():
            o_einsum = make_ring_attention(mesh, causal=True,
                                           local="einsum")(*leaves)
        mine = [x.detach().cpu() for x in
                (o, *(t.grad for t in leaves), o_einsum)]
        blocks = mesh.all.gather_objects((s, launches, mine))
        if world.rank:
            return 0
        full = [torch.cat([blk[2][i] for blk in sorted(
            blocks, key=lambda blk: blk[0])]).float().numpy()
            for i in range(5)]
        dense = [x.float().to(world.device).requires_grad_(True)
                 for x in (q, k, v)]
        want = attention_reference(*dense, causal=True)
        (want * w.to(world.device)).sum().backward()
        mag = attention_reference(*(x.to(world.device) for x in (q, k)),
                                  v.abs().to(world.device),
                                  causal=True).cpu().numpy()
        want_o = want.detach().cpu().numpy()

        def ulps(got, ref):
            return float((np.abs(got - ref) / parity.bf16_ulp(
                np.maximum(np.abs(ref), mag))).max())

        grad_err = {}
        for name, got, leaf in zip(("dq", "dk", "dv"), full[1:4], dense):
            ref = leaf.grad.cpu().numpy()
            head_max = np.abs(ref).max(axis=(0, 2), keepdims=True)
            grad_err[name] = float((np.abs(got - ref)
                                    / parity.bf16_ulp(head_max)).max())
        out = {"phase": "ring_attention", "world": n, "T": T, "H": H,
               "D": D, "device": str(world.device),
               "ms_fwd_bwd_rank0": ms,
               "staged_bytes_rank0": staged_bytes(),
               "launches_by_seq_rank": {blk[0]: blk[1] for blk in blocks},
               "o_ulps_of_magnitude_vs_dense": ulps(full[0], want_o),
               "o_ulps_of_magnitude_vs_einsum_local": ulps(full[0],
                                                           full[4]),
               "grad_ulps_of_head_max_vs_dense": grad_err}
        print(json.dumps(out), flush=True)
        # on CPU ranks the wrapper runs the plain version: no launch
        on_card = world.device.type == "cuda"
        bad = [f"rank {r} launched K6b-ring {c} times, not {r + 1}"
               for r, c in out["launches_by_seq_rank"].items()
               if c != (r + 1 if on_card else 0)]
        bad += [f"o {key}: {u} ulps of the magnitude (allowed "
                f"{parity.MAX_SCORE_ULPS})" for key, u in out.items()
                if key.startswith("o_ulps") and not u <= parity.MAX_SCORE_ULPS]
        bad += [f"{name}: {e} ulps of its head's largest gradient "
                f"(allowed 4)" for name, e in grad_err.items()
                if not e <= 4]
        if bad:
            print("ring: " + "; ".join(bad), file=sys.stderr)
            return 1
        return 0


def gloo(device: str = "cuda") -> int:
    import torch
    import torch.distributed as dist

    from ..parallel.distributed import join_world

    with join_world(device) as world:
        r, n = world.rank, world.size

        def verdict(name, op, want):
            # gloo's refusal is the finding here, not a failure
            try:
                got = op()
                if world.device.type == "cuda":
                    torch.cuda.synchronize(world.device)
                said = "right" if torch.equal(got.cpu(), want) else "wrong"
            except Exception as e:          # noqa: BLE001
                said = f"refused: {type(e).__name__}: {str(e)[:300]}"
            if r == 0:
                print(json.dumps({"op": name, "device": str(world.device),
                                  "verdict": said}), flush=True)
            dist.barrier()

        x = torch.full((4,), float(r + 1), device=world.device)

        def all_reduce():
            y = x.clone()
            dist.all_reduce(y)
            return y

        def all_gather():
            got = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(got, x)
            return torch.stack(got)

        def hop():
            got = torch.empty_like(x)
            ops = [dist.P2POp(dist.isend, x, (r + 1) % n),
                   dist.P2POp(dist.irecv, got, (r - 1) % n)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            return got

        verdict("all_reduce", all_reduce,
                torch.full((4,), float(n * (n + 1) // 2)))
        verdict("all_gather", all_gather, torch.stack(
            [torch.full((4,), float(i + 1)) for i in range(n)]))
        verdict("batch_isend_irecv", hop,
                torch.full((4,), float((r - 1) % n + 1)))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_ab = sub.add_parser("ab", help="time the kernels of two checkouts")
    p_ab.add_argument("tree_a")
    p_ab.add_argument("tree_b")
    p_faults = sub.add_parser("faults",
                              help="plant faults in K11's and K9's sums")
    p_faults.add_argument("names", nargs="*", metavar="NAME",
                          help="faults to plant (default: all): "
                               + ", ".join(FAULTS))
    p_prof = sub.add_parser("profile",
                            help="profile the temporal train step")
    for flag, default in (("steps", 3), ("window", 64), ("groups", 256),
                          ("endpoints", 32), ("embed", 32),
                          ("hidden", 128)):
        p_prof.add_argument(f"--{flag}", type=int, default=default)
    p_prof.add_argument("--chunks", type=int, nargs="+", default=[0, 32],
                        metavar="HEADS",
                        help="attention_chunk settings to profile (0: "
                             "unchunked)")
    p_ring = sub.add_parser("ring", help="a ring of ranks on the card, "
                                         "under torch.distributed.run")
    p_ring.add_argument("--device", default="cuda")
    for flag, default in (("T", 512), ("H", 256), ("D", 32), ("seed", 0)):
        p_ring.add_argument(f"--{flag}", type=int, default=default)
    p_gloo = sub.add_parser("gloo", help="does gloo take CUDA tensors, "
                                         "under torch.distributed.run")
    p_gloo.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.cmd == "gloo":
        return gloo(args.device)
    if args.cmd == "ring":
        return ring(args.device, args.T, args.H, args.D, args.seed)
    if args.cmd == "profile":
        return profile(args.steps, window=args.window, groups=args.groups,
                       endpoints=args.endpoints, embed=args.embed,
                       hidden=args.hidden, chunks=args.chunks)
    unknown = [n for n in getattr(args, "names", []) if n not in FAULTS]
    if unknown:
        ap.error(f"unknown faults: {unknown}")
    if args.cmd == "ab":
        return ab(args.tree_a, args.tree_b)
    return faults(args.names)


if __name__ == "__main__":
    sys.exit(main())
