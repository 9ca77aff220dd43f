"""Rank processes for the port's multi-rank tests on the CPU.

    python tests/torch_ranks.py SUITE RANK WORLD DIR

joins a gloo world of WORLD ranks through a ``FileStore`` in DIR (never a
fixed TCP port: the suite runs under several workers at once), runs the
scenarios of SUITE on the inputs in ``DIR/inputs.pt`` and saves this
rank's results to ``DIR/rank{RANK}.pt``.  :func:`run_world` starts the
ranks from a test and returns every rank's results.  The rank processes
import torch and the port, never JAX: the JAX side of a comparison runs
in the test process.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
#: seconds a world may take before the test fails instead of hanging
TIMEOUT = 600


def run_world(suite: str, world: int, inputs: dict, workdir: Path) -> list:
    """Start ``world`` rank processes on ``inputs`` and return their
    results in rank order; fail with every rank's stderr if one fails."""
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, workdir / "inputs.pt")
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT"):
        env.pop(name, None)
    logs = [open(workdir / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, suite, str(r), str(world), str(workdir)],
        cwd=REPO, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        if p.returncode != 0:
            failed.append(f"rank {r} exited {p.returncode}:\n"
                          f"{log.read()[-4000:]}")
        log.close()
    assert not failed, "\n".join(failed)
    return [torch.load(workdir / f"rank{r}.pt") for r in range(world)]


# ---------------------------------------------------------------------------
# suites: fn(inputs, world) -> this rank's results (tensors, numbers, str)
# ---------------------------------------------------------------------------


def _block(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of a global [T, H, ...] tensor: its seq block of
    the rows and, on a mesh with a data axis, its data block of the
    heads."""
    n, i = mesh.shape["seq"], mesh.coords["seq"]
    x = x.chunk(n)[i]
    if "data" in mesh.shape:
        x = x.chunk(mesh.shape["data"], dim=1)[mesh.coords["data"]]
    return x.contiguous()


def ring_suite(inputs: dict, world) -> dict:
    """Each case of ``inputs["ring"]`` through ``make_ring_attention``
    (forward, and the backward of sum(o * w)) and each case of
    ``inputs["last"]`` through ``make_last_attention`` (forward, and the
    backward of sum(out * w) / n_seq, as a rank of the sharded planner
    counts a group's loss), on a 1-D seq mesh of every rank or on the
    2-D data x seq mesh (heads split over data)."""
    from aws_global_accelerator_controller_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from aws_global_accelerator_controller_tpu_torch.parallel \
        .ring_attention import make_last_attention, make_ring_attention

    meshes = {"seq": make_mesh(world, ("seq",)),
              "data_seq": make_mesh(world, ("data", "seq"))}
    out = {"coords": {k: m.coords for k, m in meshes.items()}}
    for case in inputs["ring"]:
        mesh = meshes[case["mesh"]]
        leaves = [_block(case[x], mesh).requires_grad_(True)
                  for x in ("q", "k", "v")]
        ring = make_ring_attention(mesh, "seq", causal=case["causal"],
                                   local=case["local"])
        o = ring(*leaves)
        (o.float() * _block(case["w"], mesh)).sum().backward()
        out[case["name"]] = {"o": o.detach(),
                             **{f"d{x}": t.grad for x, t in
                                zip("qkv", leaves)}}
    for case in inputs["last"]:
        mesh = meshes[case["mesh"]]
        q, w = case["q"], case["w"]
        if "data" in mesh.shape:      # q_last and w [H, D]: heads split
            n, i = mesh.shape["data"], mesh.coords["data"]
            q, w = (x.chunk(n)[i].contiguous() for x in (q, w))
        leaves = [q.clone().requires_grad_(True),
                  *(_block(case[x], mesh).requires_grad_(True)
                    for x in ("k", "v"))]
        got = make_last_attention(mesh, "seq")(*leaves)
        ((got * w).sum() / mesh.shape["seq"]).backward()
        out[case["name"]] = {"out": got.detach(),
                             **{f"d{x}": t.grad for x, t in
                                zip("qkv", leaves)}}
    return out


def _temporal(case: dict):
    from aws_global_accelerator_controller_tpu_torch.models.temporal import (
        TemporalTrafficModel,
    )

    return TemporalTrafficModel(feature_dim=8, embed_dim=16, hidden_dim=32,
                                **case.get("model", {}))


def _planner(case: dict, world):
    """(model, planner) of a case on the mesh of its shape, or (model,
    None) on a rank outside that mesh.  Every rank makes every mesh."""
    from aws_global_accelerator_controller_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from aws_global_accelerator_controller_tpu_torch.parallel.plan import (
        ShardedTemporalPlanner,
    )

    model = _temporal(case)
    mesh = make_mesh(world, shape=case["shape"])
    if mesh is None:
        return model, None
    return model, ShardedTemporalPlanner(model, mesh,
                                         local=case.get("local"))


def _shards(planner, case: dict):
    from aws_global_accelerator_controller_tpu_torch.models.traffic import (
        Batch,
    )

    return (planner.shard_window(case["window"]),
            planner.shard_batch(Batch(*case["batch"])))


def _params(case: dict, model):
    if "params" in case:
        return {k: v.clone() for k, v in case["params"].items()}
    return model.init_params(torch.Generator().manual_seed(case["seed"]),
                             device="cpu")


def sharded_suite(inputs: dict, world) -> dict:
    """``forward`` cases: the planner's gathered last-step scores and
    weights; ``train`` cases: the global loss of every step, and the
    final params and Adam state; ``grads`` cases: the global loss and
    gradient at the initial params and this rank's own scores; ``cli``:
    each argv through ``main()``, its stdout or its exit message."""
    from aws_global_accelerator_controller_tpu_torch.cmd.compute import (
        main as cli,
    )

    out = {"rank": world.rank, "forward": {}, "train": {}, "grads": {},
           "cli": []}
    for case in inputs["forward"]:
        model, planner = _planner(case, world)
        if planner is None:
            continue
        params = _params(case, model)
        window, batch = _shards(planner, case)
        with torch.no_grad():
            scores = planner.scores(params, window)
        out["forward"][case["name"]] = {
            "scores": planner.data.all_gather(scores).reshape(
                -1, scores.shape[-1]),
            "weights": planner.forward(params, window, batch.mask)}
    for case in inputs["train"]:
        model, planner = _planner(case, world)
        if planner is None:
            continue
        params = _params(case, model)
        opt = model.init_opt_state(params)
        window, batch = _shards(planner, case)
        losses = []
        for _ in range(case["steps"]):
            params, opt, loss = planner.train_step(params, opt, window,
                                                   batch)
            losses.append(float(loss))
        out["train"][case["name"]] = {
            "losses": losses, "local": planner.local, "params": params,
            "mu": opt.mu, "nu": opt.nu, "count": opt.count}
    for case in inputs["grads"]:
        model, planner = _planner(case, world)
        if planner is None:
            continue
        params = _params(case, model)
        window, batch = _shards(planner, case)
        loss, grads = planner.loss_and_grads(params, window, batch)
        with torch.no_grad():
            scores = (model.scores_seq(params, window.block,
                                       attend=planner._attend)
                      if model.supervision == "sequence"
                      else planner.scores(params, window))
        out["grads"][case["name"]] = {
            "loss": float(loss), "grads": grads, "scores": scores,
            "coords": planner.mesh.coords}
    for argv in inputs["cli"]:
        buf, error = io.StringIO(), None
        try:
            with contextlib.redirect_stdout(buf):
                cli(argv)
        except SystemExit as e:
            error = str(e)
        text = buf.getvalue()
        out["cli"].append({"json": json.loads(text) if text else None,
                           "stdout": text, "error": error})
    return out


def _group_states(specs):
    from aws_global_accelerator_controller_tpu_torch.reconcile.columnar \
        import GroupState

    return [GroupState(**{**s, "features": None if s["features"] is None
                          else s["features"].numpy()}) for s in specs]


def _plan_out(desired_w, to_add, to_remove, to_reweight, stats) -> dict:
    return {"desired_w": torch.as_tensor(desired_w),
            "to_add": torch.as_tensor(to_add),
            "to_remove": torch.as_tensor(to_remove),
            "to_reweight": torch.as_tensor(to_reweight), "stats": stats}


def _skip_a_hop(group, x: torch.Tensor) -> torch.Tensor:
    """A faulty ring, for the test to catch: one hop fewer than n - 1."""
    acc = blk = x
    for _ in range(group.size - 2):
        (blk,) = group.shift(blk)
        acc = acc + blk
    return acc


def fleet_suite(inputs: dict, world) -> dict:
    """``ring``: the stats ring's plain version on a data axis of each
    size of ``inputs["ring"]["sizes"]`` (rank i reducing tile i), and a
    ring that skips a hop; ``fleets``: each fleet through
    ``WholeFleetPlanner(world=...)`` (every rank plans; shards > 1 lay
    out over the first ``shards`` ranks); ``mesh22``: the sharded pass
    of ``make_fleet_pass`` on a data 2 x model 2 mesh, rank (d, m) on
    shard d, its own outputs."""
    from aws_global_accelerator_controller_tpu_torch.models.traffic import (
        TrafficPolicyModel,
    )
    from aws_global_accelerator_controller_tpu_torch.parallel.fleet_plan \
        import WholeFleetPlanner, _make_stats_ring, make_fleet_pass
    from aws_global_accelerator_controller_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from aws_global_accelerator_controller_tpu_torch.reconcile.columnar \
        import pack_fleet

    out = {"rank": world.rank, "ring": {}, "ring_skip": {}, "fleets": {}}
    tiles = inputs["ring"]["tiles"]
    for n in inputs["ring"]["sizes"]:
        mesh = make_mesh(world, ("data",), shape={"data": n})
        if mesh is None:
            continue
        group = mesh.groups["data"]
        tile = tiles[group.index]
        out["ring"][n] = _make_stats_ring(group, "cpu")(tile)
        out["ring_skip"][n] = _skip_a_hop(group, tile)
    model = TrafficPolicyModel()
    params = inputs["params"]
    planner = WholeFleetPlanner(model=model, params=params, world=world)
    for case in inputs["fleets"]:
        fleet = pack_fleet(_group_states(case["specs"]),
                           endpoints_cap=case["cap"], shards=case["shards"])
        res = planner.plan(fleet)
        out["fleets"][case["name"]] = {
            "layout": res.layout,
            **_plan_out(res.desired_w, res.to_add, res.to_remove,
                        res.to_reweight, res.stats)}
    case = inputs["mesh22"]
    mesh = make_mesh(world, ("data", "model"),
                     shape={"data": 2, "model": 2})
    fleet = pack_fleet(_group_states(case["specs"]),
                       endpoints_cap=case["cap"], shards=2)
    r = mesh.coords["data"]
    args = [torch.from_numpy(a[r].copy()) for a in (
        fleet.feat_rows, fleet.row_seg, fleet.row_slot, fleet.desired,
        fleet.observed, fleet.observed_w, fleet.cached_w, fleet.rescored,
        fleet.weight_mode, fleet.spec_w)]
    got = make_fleet_pass(model, mesh)(params, *args)
    out["mesh22"] = {"coords": mesh.coords, **_plan_out(*got)}
    return out


SUITES = {"ring": ring_suite, "sharded": sharded_suite, "fleet": fleet_suite}


def main() -> int:
    import torch.distributed as dist

    from aws_global_accelerator_controller_tpu_torch.parallel.distributed \
        import join_world

    suite, rank, world, workdir = (sys.argv[1], int(sys.argv[2]),
                                   int(sys.argv[3]), Path(sys.argv[4]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world)
    inputs = torch.load(workdir / "inputs.pt")
    with join_world("cpu") as w:
        result = SUITES[suite](inputs, w)
    torch.save(result, workdir / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
