"""Hygiene of the PyTorch port: it stands alone, and nothing falls back.

- No module of the port, and not ``chip_smoke.py``, imports ``jax``, the
  JAX package (``aws_global_accelerator_controller_tpu``), ``optax`` or
  ``orbax``, none of which the machine with the card has.
- The port imports with all of them made unimportable.
- With no CUDA device, an entry point called with its default device
  raises instead of running on the CPU; a kernel wrapper given a tensor
  that is neither on the CPU nor on CUDA raises too.
- CPU calls never build or launch a kernel.
- ``params_from_jax`` carries every bf16 bit pattern exactly.
"""
import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_global_accelerator_controller_tpu.models.traffic import (
    TrafficPolicyModel as JaxModel,
)
from aws_global_accelerator_controller_tpu_torch import device as tdevice
from aws_global_accelerator_controller_tpu_torch.cmd.compute import main
from aws_global_accelerator_controller_tpu_torch.kernels import build
from aws_global_accelerator_controller_tpu_torch.models.convert import (
    params_from_jax,
)
from aws_global_accelerator_controller_tpu_torch.models.temporal import (
    TemporalTrafficModel,
    synthetic_window,
)
from aws_global_accelerator_controller_tpu_torch.models.traffic import (
    TrafficPolicyModel,
    synthetic_batch,
)
from aws_global_accelerator_controller_tpu_torch.ops.cuda_attention import (
    flash_attention,
    flash_attention_stats,
    flash_attention_stats_ring,
    flash_bwd_dkv,
    flash_bwd_dq,
)
from aws_global_accelerator_controller_tpu_torch.ops.cuda_mlp import (
    forward_cuda,
    score_rows_cuda,
)
from aws_global_accelerator_controller_tpu_torch.ops.cuda_ring import (
    stats_ring_cuda,
)
from aws_global_accelerator_controller_tpu_torch.ops.cuda_weights import (
    plan_weights_cuda,
)
from aws_global_accelerator_controller_tpu_torch.parallel.distributed \
    import Group
from aws_global_accelerator_controller_tpu_torch.parallel.fleet import (
    row_splice,
)
from aws_global_accelerator_controller_tpu_torch.parallel.fleet_plan import (
    ResidentFleetPlanner,
    WholeFleetPlanner,
    _make_stats_ring,
)
from aws_global_accelerator_controller_tpu_torch.reconcile.resident import (
    ResidentFleet,
)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "aws_global_accelerator_controller_tpu_torch"
FORBIDDEN = {"jax", "aws_global_accelerator_controller_tpu", "optax",
             "orbax"}


def port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    sources = port_sources()
    assert len(sources) > 15
    bad = [(str(p.relative_to(REPO)), name) for p in sources
           for name in top_level_imports(p) if name in FORBIDDEN]
    assert bad == []


def test_port_imports_with_jax_unimportable():
    modules = [".".join(p.relative_to(REPO).with_suffix("").parts)
               for p in sorted(PORT.rglob("*.py"))
               if p.name != "__main__.py"]
    code = ("import importlib, sys\n"
            f"for name in {sorted(FORBIDDEN)!r}:\n"
            "    sys.modules[name] = None\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "loaded = {k.split('.')[0] for k, v in sys.modules.items() "
            "if v is not None}\n"
            f"assert not loaded & {FORBIDDEN!r}\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    DeviceError = tdevice.DeviceError
    with pytest.raises(DeviceError):
        tdevice.resolve_device()
    with pytest.raises(DeviceError):
        WholeFleetPlanner()
    with pytest.raises(DeviceError):
        ResidentFleetPlanner(ResidentFleet(shards=1, endpoints_cap=4))
    with pytest.raises(DeviceError):
        TrafficPolicyModel().init_params(torch.Generator())
    with pytest.raises(DeviceError):
        synthetic_batch(np.random.default_rng(0), 2, 2)
    with pytest.raises(DeviceError):
        params_from_jax({"b3": np.zeros(1, np.float32)})
    with pytest.raises(DeviceError):
        main(["plan", "--groups", "2", "--endpoints", "2"])
    with pytest.raises(DeviceError):
        TemporalTrafficModel().init_params(torch.Generator())
    with pytest.raises(DeviceError):
        synthetic_window(np.random.default_rng(0), 2, 2, 2)
    with pytest.raises(DeviceError):
        main(["eval", "--batches", "1"])
    with pytest.raises(DeviceError):
        main(["train", "--model", "temporal", "--steps", "1"])
    with pytest.raises(DeviceError):
        main(["train", "--model", "temporal", "--sharded", "--steps", "1"])
    with pytest.raises(DeviceError):
        main(["plan", "--model", "temporal", "--sharded"])
    with pytest.raises(DeviceError):
        tdevice.resolve_device("mps")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_other_devices():
    """A tensor that is not on the CPU goes to the kernel or raises:
    'meta' tensors stand in for tensors on a device without a kernel."""
    meta = dict(device="meta")
    s = torch.empty((4, 4), **meta)
    m = torch.empty((4, 4), dtype=torch.bool, **meta)
    params = {k: v.to("meta") for k, v in TrafficPolicyModel().init_params(
        torch.Generator().manual_seed(0), device="cpu").items()}
    with pytest.raises(ValueError, match="CUDA"):
        plan_weights_cuda(s, m)
    with pytest.raises(ValueError, match="CUDA"):
        forward_cuda(params, torch.empty((4, 4, 8), **meta), m)
    with pytest.raises(ValueError, match="CUDA"):
        score_rows_cuda(params, torch.empty((4, 8), **meta))
    with pytest.raises(ValueError, match="CUDA"):
        row_splice(torch.empty((4, 2), dtype=torch.int32, **meta),
                   torch.empty(1, dtype=torch.int32, **meta),
                   torch.empty((1, 2), dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        tdevice.probe_double(torch.empty((8, 128), **meta))
    qkv = torch.empty((64, 2, 16), dtype=torch.bfloat16, **meta)
    stats = torch.empty((2, 64), **meta)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(qkv, qkv, qkv)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_stats(qkv, qkv, qkv)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_stats_ring(qkv.float(), qkv, qkv)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_dq(qkv, qkv, qkv, qkv, stats, stats, stats)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_dkv(qkv, qkv, qkv, qkv, stats, stats, stats)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(*(x.requires_grad_(True) for x in (
            torch.empty((64, 2, 16), dtype=torch.bfloat16, **meta)
            for _ in range(3))))
    with pytest.raises(ValueError, match="CUDA"):
        stats_ring_cuda(None, torch.empty(5, **meta))
    with pytest.raises(ValueError):
        plan_weights_cuda(torch.zeros((2, 2)), m)   # mixed devices


def test_cpu_calls_build_and_launch_nothing():
    build.reset_launch_counts()
    model = TrafficPolicyModel(serve="fused")
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    batch = synthetic_batch(np.random.default_rng(0), 4, 8, device="cpu")
    model.forward(params, batch.features, batch.mask)
    model.score_rows(params, batch.features.reshape(-1, 8))
    plan_weights_cuda(torch.zeros((3, 4)), torch.ones((3, 4), dtype=bool))
    row_splice(torch.zeros((4, 2), dtype=torch.int32),
               torch.tensor([1], dtype=torch.int32),
               torch.ones((1, 2), dtype=torch.int32))
    tdevice.probe_double(torch.ones(8, 128))
    tmodel = TemporalTrafficModel(embed_dim=16, hidden_dim=16,
                                  supervision="sequence")
    window, wbatch = synthetic_window(np.random.default_rng(0), 64, 2, 2,
                                      per_step=True, device="cpu")
    tparams = tmodel.init_params(torch.Generator().manual_seed(0),
                                 device="cpu")
    tmodel.loss(tparams, window, wbatch)
    tmodel.train_step(tparams, tmodel.init_opt_state(tparams), window,
                      wbatch)
    flash_attention_stats_ring(torch.ones(2, 64, 16), torch.ones(
        2, 64, 16, dtype=torch.bfloat16), torch.ones(
            2, 64, 16, dtype=torch.bfloat16), causal=True)
    fused = TemporalTrafficModel(embed_dim=16, hidden_dim=16,
                                 supervision="sequence", head="fused_always")
    fused.train_step(tparams, fused.init_opt_state(tparams), window, wbatch)
    model.train_step(params, model.init_opt_state(params), batch)
    _make_stats_ring(Group([0], 0), "cpu")(torch.ones(5))
    counts = build.launch_counts()
    assert set(counts) >= {"probe_double", "plan_weights", "fused_mlp_plan",
                           "fused_mlp_scores", "row_splice",
                           "flash_attention", "flash_attention_stats",
                           "flash_bwd_dq", "flash_bwd_dkv", "score_head_fwd",
                           "score_head_bwd", "flash_attention_stats_ring",
                           "stats_ring"}
    assert not any(counts.values())
    if not torch.cuda.is_available():
        assert build._library is None


def test_params_from_jax_carries_every_bf16_bit_pattern():
    bits = jnp.arange(1 << 16, dtype=jnp.uint32).astype(jnp.uint16)
    every = jax.lax.bitcast_convert_type(bits, jnp.bfloat16)
    jp = JaxModel().init_params(jax.random.PRNGKey(3))
    src = {**{k: np.asarray(v) for k, v in jp.items()},
           "every": np.asarray(every), "f32": np.arange(5, dtype=np.float32)}
    got = params_from_jax(src, device="cpu")
    for k, v in src.items():
        t = got[k]
        if v.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  v.view(np.uint16)), k
        else:
            assert np.array_equal(t.numpy(), v)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: chip_smoke would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    lonely = tmp_path / "chip_smoke.py"
    lonely.write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(lonely)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
