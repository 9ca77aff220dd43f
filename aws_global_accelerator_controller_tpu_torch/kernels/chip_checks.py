"""Two checks of the kernels that need the card and more than one build.

``ab TREE_A TREE_B``: device times of K3 (both entries, H = 128 and 256)
and of K10 and K11 (the train command's default shape and the
reference's own head shape) in two checkouts, each in a fresh process
with its own build, in the order A, B, B, A, so that a drift of the
card's clock over the run falls on both alike.  This is how two
versions of a kernel are compared.

``faults``: plants faults in K11's weight-gradient sums, each in a copy
of this checkout made in a temporary directory, and demands that the
card test over many row tiles and ``chip_smoke.py``'s K11 check (at
both of its shapes) fail on every one:

- ``half_partials``: the second kernel sums every other CTA's partial;
- ``first_tile_only``: each CTA adds only its first row tile into dw1,
  db1 and dw2;
- ``zero_weight_grads``: the weight gradients come out zero.

Run from the root of a checkout, on a machine with one card::

    python3 -m aws_global_accelerator_controller_tpu_torch.kernels.chip_checks ab build/parent .
    python3 -m aws_global_accelerator_controller_tpu_torch.kernels.chip_checks faults

Each prints one JSON object a run, and exits non-zero if a fault went
unnoticed.
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
print(json.dumps(out))
"""

# run inside a checkout: K11's check in chip_smoke.py at both shapes
_SMOKE_HEAD = r"""
import chip_smoke as cs
from aws_global_accelerator_controller_tpu_torch.kernels import build
build.library()
errors = []
for args in ((64, 8192, 32, 128, 13), (2048, 128, 128, 256, 14)):
    try:
        cs._head_rows_one(*args, iters=2, eager_iters=2)
    except cs.SmokeError as e:
        errors.append(str(e))
print("\n".join(errors))
raise SystemExit(1 if errors else 0)
"""

_SRC = f"{PKG}/csrc/score_head.cu"
FAULTS = {
    "half_partials": (
        "for (int c = 0; c < ctas; ++c) s += partials[c * n + e];",
        "for (int c = 0; c < ctas; c += 2) s += partials[c * n + e];"),
    "first_tile_only": (
        "      for (int tile = tile0; tile < tile1; ++tile) {\n"
        "        const int row0 = tile * kBlock;\n"
        "        float acc",
        "      for (int tile = tile0; tile < min(tile1, tile0 + 1); ++tile) "
        "{\n"
        "        const int row0 = tile * kBlock;\n"
        "        float acc"),
    "zero_weight_grads": ("  out[e] = s;", "  out[e] = 0.f;"),
}


def _run(cmd, cwd, timeout=900):
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def ab(tree_a: str, tree_b: str) -> int:
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


def faults() -> int:
    unnoticed = []
    for name, (old, new) in FAULTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            dst = Path(tmp)
            _copy(dst)
            src = dst / _SRC
            text = src.read_text()
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the text to change is not in "
                                 f"{_SRC} once")
            src.write_text(text.replace(old, new))
            test = _run([sys.executable, "-m", "pytest", "--noconftest",
                         "-q", "-p", "no:cacheprovider",
                         "tests/test_torch_cuda.py", "-k",
                         "over_many_row_tiles"], dst)
            smoke = _run([sys.executable, "-c", _SMOKE_HEAD], dst)
            failed = [ln for ln in test.stdout.splitlines()
                      if "assert" in ln or ln.startswith("E ")]
            rec = {"fault": name, "card_test_rc": test.returncode,
                   "card_test": failed[-6:] or test.stdout[-600:],
                   "chip_smoke_rc": smoke.returncode,
                   "chip_smoke": smoke.stdout.strip().splitlines()
                   or smoke.stderr[-600:]}
            print(json.dumps(rec), flush=True)
            # 1: the test failed (not 2-5: a usage or collection error);
            # the smoke check raised SmokeError at both shapes
            if test.returncode != 1 or smoke.returncode != 1 or len(
                    rec["chip_smoke"]) != 2:
                unnoticed.append(name)
    print(json.dumps({"faults_unnoticed": unnoticed}), flush=True)
    return 1 if unnoticed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_ab = sub.add_parser("ab", help="time the kernels of two checkouts")
    p_ab.add_argument("tree_a")
    p_ab.add_argument("tree_b")
    sub.add_parser("faults", help="plant faults in K11's sums")
    args = ap.parse_args(argv)
    if args.cmd == "ab":
        return ab(args.tree_a, args.tree_b)
    return faults()


if __name__ == "__main__":
    sys.exit(main())
