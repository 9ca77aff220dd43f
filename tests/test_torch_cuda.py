"""The port's kernels and device paths on the card.

Every test here needs a CUDA device (the ``cuda`` marker) and skips
where none is visible; it imports neither JAX nor the JAX package, so
on a machine with the card and without JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Each kernel is held against its plain version on the same inputs with
the port's tolerances (``parity.py``); the planners on the card are held
against themselves on the CPU and against their own full repack.
"""
import numpy as np
import pytest
import torch

from aws_global_accelerator_controller_tpu_torch import device as tdevice
from aws_global_accelerator_controller_tpu_torch import parity
from aws_global_accelerator_controller_tpu_torch.kernels import build
from aws_global_accelerator_controller_tpu_torch.models.temporal import (
    TemporalTrafficModel,
    synthetic_window,
)
from aws_global_accelerator_controller_tpu_torch.models.traffic import (
    TrafficPolicyModel,
)
from aws_global_accelerator_controller_tpu_torch.models.common import (
    value_and_grad,
)
from aws_global_accelerator_controller_tpu_torch.ops.cuda_attention import (
    BLOCK_K,
    attention_dvec,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_magnitude,
    flash_attention_plain,
    flash_attention_stats,
    flash_attention_stats_plain,
    flash_bwd_dkv,
    flash_bwd_dkv_plain,
    flash_bwd_dq,
    flash_bwd_dq_plain,
    flash_bwd_dqkv,
    flash_bwd_dqkv_plain,
    fused_bwd_route,
)
from aws_global_accelerator_controller_tpu_torch.ops import (
    cuda_attention as ca,
)
from aws_global_accelerator_controller_tpu_torch.ops.cuda_head import (
    score_head,
    score_head_bwd,
    score_head_bwd_plain,
    score_head_dx_magnitude,
    score_head_forward,
    score_head_magnitude,
    score_head_plain,
    score_head_weight_grad_limits,
    weight_grad_error,
)
from aws_global_accelerator_controller_tpu_torch.ops.cuda_mlp import (
    bf16_linear,
    dense_scores,
    forward_cuda,
    forward_reference,
    relu,
    score_rows_cuda,
)
from aws_global_accelerator_controller_tpu_torch.ops.cuda_weights import (
    plan_block,
    plan_weights_cuda,
)
from aws_global_accelerator_controller_tpu_torch.parallel.fleet import (
    row_splice,
    row_splice_reference,
)
from aws_global_accelerator_controller_tpu_torch.parallel.fleet_plan import (
    ResidentFleetPlanner,
    WholeFleetPlanner,
)
from aws_global_accelerator_controller_tpu_torch.reconcile.columnar import (
    GroupState,
)
from aws_global_accelerator_controller_tpu_torch.reconcile.resident import (
    ResidentFleet,
)

pytestmark = pytest.mark.cuda

F = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return tdevice.resolve_device("cuda")


@pytest.fixture
def params(cuda):
    return TrafficPolicyModel().init_params(
        torch.Generator().manual_seed(0), device=cuda)


def test_probe_kernel_doubles(cuda):
    x = torch.randn(8, 128, device=cuda)
    assert torch.equal(tdevice.probe_double(x), x * 2)


@pytest.mark.parametrize("G,E", [(64, 4), (48, 16), (32, 32), (16, 7),
                                 (9, 40), (100_000, 4)])
def test_quantizer_kernel_matches_plain_version(cuda, G, E):
    rng = np.random.default_rng(G + E)
    s = torch.from_numpy((rng.standard_normal((G, E)) * 3)
                         .astype(np.float32)).to(cuda)
    m = torch.from_numpy(np.arange(E)[None, :]
                         < rng.integers(0, E + 1, (G, 1))).to(cuda)
    m[::5] = False
    got = plan_weights_cuda(s, m).cpu().numpy()
    assert parity.weights_close(got, plan_block(s, m).cpu().numpy())
    assert not got[~m.cpu().numpy()].any()


@pytest.mark.parametrize("G,E", [(512, 16), (37, 4), (3, 300)])
def test_fused_mlp_kernel_matches_plain_version(cuda, params, G, E):
    rng = np.random.default_rng(G)
    x = torch.from_numpy(rng.standard_normal((G, E, F))
                         .astype(np.float32)).to(cuda)
    m = torch.from_numpy(rng.random((G, E)) < 0.8).to(cuda)
    got = forward_cuda(params, x, m).cpu().numpy()
    assert parity.weights_close(
        got, forward_reference(params, x, m).cpu().numpy())
    assert not got[~m.cpu().numpy()].any()


@pytest.mark.parametrize("H", [129, 256, 512])
@pytest.mark.parametrize("F", [8, 65, 128])
def test_fused_mlp_kernel_takes_any_width(cuda, F, H):
    """K3 past one pass of 128 hidden units, past resident weights and
    past one 32-feature tile: both entries against their plain versions
    (weights +-1 on <= 0.5% of cells, scores within 2 bf16 ulps), and a
    row scores bit-identically in any batch."""
    p = TrafficPolicyModel(feature_dim=F, hidden_dim=H).init_params(
        torch.Generator().manual_seed(F + H), device=cuda)
    rng = np.random.default_rng(F * H)
    x = torch.from_numpy(rng.standard_normal((300, 7, F))
                         .astype(np.float32)).to(cuda)
    m = torch.from_numpy(rng.random((300, 7)) < 0.8).to(cuda)
    build.reset_launch_counts()
    got = forward_cuda(p, x, m)
    assert build.launch_counts()["fused_mlp_plan"] == 1
    assert parity.weights_close(got.cpu().numpy(),
                                forward_reference(p, x, m).cpu().numpy())
    rows = x.reshape(-1, F)
    s = score_rows_cuda(p, rows)
    assert parity.scores_close(s.cpu().numpy(),
                               dense_scores(p, rows).cpu().numpy())
    for a, b in ((0, 1), (7, 40), (2000, 2100)):
        assert torch.equal(score_rows_cuda(p, rows[a:b]), s[a:b])


def _mlp_score_magnitude(p, rows):
    """What each score of the traffic MLP sums, in absolute value:
    |h2| . |w3| + |b3|."""
    h = relu(bf16_linear(rows.to(torch.bfloat16), p["w1"], p["b1"]))
    h = relu(bf16_linear(h, p["w2"], p["b2"]))
    return (h.float().abs() @ p["w3"].float().abs())[..., 0] + \
        p["b3"].float().abs()


@pytest.mark.parametrize("H", [2048, 3072])
def test_fused_mlp_kernel_at_widths_of_thousands(cuda, H):
    """K3 at H = 2048 (rows 32 at a time) and 3072, where 32 rows of the
    hidden layer would not fit in shared memory beside the streamed
    tiles, so it takes rows 8 at a time: the plan entry against its
    plain version (weights +-1 on <= 0.5% of cells), the scores within
    2 bf16 ulps of what each sums (a score sums thousands of terms of
    either sign, so it can cancel far below them), and a row scores
    bit-identically in any batch."""
    p = TrafficPolicyModel(feature_dim=F, hidden_dim=H).init_params(
        torch.Generator().manual_seed(H), device=cuda)
    rng = np.random.default_rng(H)
    x = torch.from_numpy(rng.standard_normal((100, 7, F))
                         .astype(np.float32)).to(cuda)
    m = torch.from_numpy(rng.random((100, 7)) < 0.8).to(cuda)
    got = forward_cuda(p, x, m)
    assert parity.weights_close(got.cpu().numpy(),
                                forward_reference(p, x, m).cpu().numpy())
    rows = x.reshape(-1, F)
    s = score_rows_cuda(p, rows)
    assert parity.scores_close(
        s.cpu().numpy(), dense_scores(p, rows).cpu().numpy(),
        scale=_mlp_score_magnitude(p, rows).cpu().numpy())
    for a, b in ((0, 1), (7, 40), (500, 700)):
        assert torch.equal(score_rows_cuda(p, rows[a:b]), s[a:b])


def test_row_scoring_kernel_is_batch_independent(cuda, params):
    rows = torch.randn(5000, F, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(1))
    s = score_rows_cuda(params, rows)
    assert parity.scores_close(s.cpu().numpy(),
                               dense_scores(params, rows).cpu().numpy())
    for a, b in ((0, 1), (7, 40), (4000, 5000)):
        assert torch.equal(score_rows_cuda(params, rows[a:b]), s[a:b])


def test_splice_kernel_matches_plain_version_in_place(cuda):
    rng = np.random.default_rng(3)
    for W in (4, 1):
        base = torch.from_numpy(
            rng.integers(0, 1000, (300, W)).astype(np.int32)).to(cuda)
        lin_np = rng.choice(300, 40, replace=False).astype(np.int32)
        lin_np[-5:] = lin_np[0]
        rows = torch.from_numpy(
            rng.integers(0, 1000, (40, W)).astype(np.int32)).to(cuda)
        rows[-5:] = rows[0]
        lin = torch.from_numpy(lin_np).to(cuda)
        dst = base.clone()
        assert row_splice(dst, lin, rows) is dst
        assert torch.equal(dst,
                           row_splice_reference(base.clone(), lin, rows))


@pytest.mark.parametrize("lin", [[300], [-1], [0, 5, 300]])
def test_splice_kernel_refuses_rows_outside_the_grid(cuda, lin):
    dst = torch.zeros((300, 4), dtype=torch.int32, device=cuda)
    rows = torch.ones((len(lin), 4), dtype=torch.int32, device=cuda)
    before = build.launch_counts()["row_splice"]
    with pytest.raises(IndexError):
        row_splice(dst, torch.tensor(lin, dtype=torch.int32, device=cuda),
                   rows)
    assert build.launch_counts()["row_splice"] == before
    assert not dst.any()


def fleet_groups(n, shards, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ne = 1 + i % 4
        desired = [f"arn:lb{i}-{j}" for j in range(ne)]
        observed = desired[1:] if i % 5 == 0 else list(desired)
        out.append(GroupState(
            key=f"default/b{i}", group_arn=f"eg-{i}", desired=desired,
            observed=observed,
            observed_weights=[int(w) for w in
                              rng.integers(0, 256, len(observed))],
            features=rng.standard_normal((ne, F)).astype(np.float32),
            fingerprint=i + 1, shard=i % shards))
    return out


def test_whole_fleet_on_card_matches_cpu(cuda, params):
    groups = fleet_groups(3000, 4, 0)
    got = WholeFleetPlanner(params=params, device=cuda).plan_groups(
        groups, endpoints_cap=8, shards=4)
    want = WholeFleetPlanner(params=params, device="cpu").plan_groups(
        groups, endpoints_cap=8, shards=4)
    assert np.array_equal(got.to_add, want.to_add)
    assert np.array_equal(got.to_remove, want.to_remove)
    assert parity.weights_close(got.desired_w, want.desired_w)


def test_resident_waves_on_card_bitmatch_full_repack(cuda, params):
    fleet = ResidentFleet(shards=8, endpoints_cap=4, feature_dim=F,
                          groups_per_shard=64)
    planner = ResidentFleetPlanner(fleet, params=params, device=cuda)
    groups = fleet_groups(400, 8, 1)
    for g in groups:
        fleet.upsert(g)
    build.reset_launch_counts()
    planner.plan_wave()
    for i in range(100, 140):
        g = groups[i]
        g.observed = list(g.desired)
        g.observed_weights = [7] * len(g.desired)
        g.fingerprint += 1000
        fleet.upsert(g)
    planner.plan_wave()
    counts = build.launch_counts()
    assert counts["row_splice"] == 12 and counts["plan_weights"] == 2
    assert not planner.plan_wave().device_call
    assert build.launch_counts() == counts
    assert planner.verify_full_repack()["match"] is True


def test_resident_waves_at_hidden_256_bitmatch_full_repack(cuda):
    """The resident planner's check rests on K3's row contract; with a
    256-unit model (two passes, w2 streamed) a wave still bit-matches
    the full repack."""
    model = TrafficPolicyModel(hidden_dim=256)
    params = model.init_params(torch.Generator().manual_seed(2),
                               device=cuda)
    fleet = ResidentFleet(shards=8, endpoints_cap=4, feature_dim=F,
                          groups_per_shard=64)
    planner = ResidentFleetPlanner(fleet, model=model, params=params,
                                   device=cuda)
    groups = fleet_groups(400, 8, 3)
    for g in groups:
        fleet.upsert(g)
    planner.plan_wave()
    for i in range(200, 260):
        g = groups[i]
        g.observed = list(g.desired)
        g.observed_weights = [9] * len(g.desired)
        g.features = g.features + 1.0
        g.fingerprint += 1000
        fleet.upsert(g)
    build.reset_launch_counts()
    wave = planner.plan_wave()
    assert wave.device_call and build.launch_counts()["fused_mlp_scores"]
    assert planner.verify_full_repack()["match"] is True


def _qkv(cuda, T, S, D, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(T, S, D, device=cuda, generator=g)
            .to(torch.bfloat16) for _ in range(3)]


@pytest.mark.parametrize("T,S,D", [(1, 3, 32), (72, 5, 16), (130, 4, 128),
                                   (200, 2, 40), (64, 1024, 32),
                                   (130, 4, 20), (72, 3, 160),
                                   (64, 2, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain_version(cuda, T, S, D,
                                                      causal):
    """K6a against its plain version at the kernel's K block: padded T
    (72, 130, 200), T = 1, D padded in the kernel (40 -> 64), D padded
    by the wrapper (20 -> 24), D in 128-column chunks (160, 256), and
    the eval shape.  Tolerance: 2 bf16 ulps of the magnitude averaged."""
    q, k, v = _qkv(cuda, T, S, D, T + S + D)
    build.reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    assert build.launch_counts()["flash_attention"] == 1
    want = flash_attention_plain(q, k, v, causal, BLOCK_K)
    mag = flash_attention_plain(q, k, v.abs(), causal, BLOCK_K)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got.float()).all())
    assert parity.attention_close(got.float().cpu().numpy(),
                                  want.float().cpu().numpy(),
                                  mag.float().cpu().numpy())
    if T == 1:
        # one key: the output is v itself
        assert torch.equal(got, v)


def test_flash_attention_kernel_refuses_what_it_cannot_take(cuda):
    q, k, v = _qkv(cuda, 64, 2, 16, 0)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q.float(), k, v)
    wide = torch.randn(64, 4, 16, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(wide[:, ::2], k, v)
    for D in (136, 12):     # widths the kernel once refused now run
        assert flash_attention(*_qkv(cuda, 8, 2, D, 1)).shape == (8, 2, D)
    with pytest.raises(ValueError, match="one"):
        flash_attention(q, k[:32], v)
    with pytest.raises(ValueError):
        flash_attention(q, k.cpu(), v)


def test_temporal_seq_on_card_matches_cpu_and_reference(cuda):
    kw = dict(embed_dim=32, hidden_dim=64, supervision="sequence")
    model = TemporalTrafficModel(**kw)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    window, batch = synthetic_window(np.random.default_rng(0), steps=130,
                                     groups=4, endpoints=8, per_step=True,
                                     device="cpu")
    on_card = {k: v.to(cuda) for k, v in params.items()}
    build.reset_launch_counts()
    got = model.scores_seq(on_card, window.to(cuda)).cpu()
    assert build.launch_counts()["flash_attention"] == 1
    ref = TemporalTrafficModel(attention="reference", **kw).scores_seq(
        on_card, window.to(cuda)).cpu()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-2,
                               atol=2e-2)
    cpu = model.scores_seq(params, window)
    np.testing.assert_allclose(got.numpy(), cpu.numpy(), rtol=2e-2,
                               atol=2e-2)
    loss_card = model.loss(on_card, window.to(cuda), batch._replace(
        mask=batch.mask.to(cuda), target=batch.target.to(cuda)))
    loss_cpu = model.loss(params, window, batch)
    np.testing.assert_allclose(float(loss_card), float(loss_cpu),
                               rtol=1e-3)


def _host(x):
    return x.float().cpu().numpy()


@pytest.mark.parametrize("T", [1, 63, 64, 65, 130, 200])
@pytest.mark.parametrize("D", [16, 32, 40, 64, 128, 20, 160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_stats_and_backward_kernels_match_plain_versions(cuda, T, D,
                                                               causal):
    """K6b, K7 and K8 against their plain versions at the kernels' block,
    on the same inputs (the backward on K6b's own o, m, l): o, dq, dk and
    dv within 2 bf16 ulps of the magnitude each sums, m and l within
    1e-5 (s in another f32 order moves them by an f32 ulp or two)."""
    q, k, v = _qkv(cuda, T, 3, D, 7 * T + D)
    do = _qkv(cuda, T, 3, D, T + 11 * D)[0]
    build.reset_launch_counts()
    o, m, l = flash_attention_stats(q, k, v, causal)
    dvec = attention_dvec(o, do)
    dq = flash_bwd_dq(q, k, v, do, m, l, dvec, causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, m, l, dvec, causal)
    counts = build.launch_counts()
    assert (counts["flash_attention_stats"], counts["flash_bwd_dq"],
            counts["flash_bwd_dkv"], counts["flash_attention"]) == (1, 1, 1, 0)
    torch.cuda.synchronize()
    po, pm, pl = flash_attention_stats_plain(q, k, v, causal, BLOCK_K)
    mag = flash_attention_plain(q, k, v.abs(), causal, BLOCK_K)
    assert parity.attention_close(_host(o), _host(po), _host(mag))
    assert torch.equal(o, flash_attention(q, k, v, causal))   # K6a's o
    np.testing.assert_allclose(_host(m), _host(pm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_host(l), _host(pl), rtol=1e-5, atol=1e-5)
    want = (flash_bwd_dq_plain(q, k, v, do, m, l, dvec, causal),
            *flash_bwd_dkv_plain(q, k, v, do, m, l, dvec, causal))
    mags = flash_attention_bwd_magnitude(q, k, v, o, do, m, l, causal)
    for name, g, w, mg in zip(("dq", "dk", "dv"), (dq, dk, dv), want, mags):
        assert g.dtype == torch.bfloat16 and g.shape == q.shape
        assert bool(torch.isfinite(g.float()).all()), name
        assert parity.attention_close(_host(g), _host(w), _host(mg)), name


@pytest.mark.parametrize("S", [16, 40])
def test_flash_backward_is_reproducible_and_takes_a_strided_cotangent(cuda,
                                                                      S):
    """Two backward runs agree bit for bit (no atomics), and autograd
    through flash_attention takes a strided cotangent as its contiguous
    copy, on the reference's route: at 16 heads one K6b and one K9
    launch, at 40 heads one K6b, K7 and K8; no K6a."""
    q, k, v = _qkv(cuda, 130, S, 32, 5)
    wide = _qkv(cuda, 130, 2 * S, 32, 6)[0]
    do = wide[:, ::2]
    assert not do.is_contiguous()
    fused = fused_bwd_route(130, S, 32)
    assert fused == (S <= 32)
    runs = []
    for _ in range(2):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        build.reset_launch_counts()
        out = flash_attention(*leaves)
        runs.append(torch.autograd.grad(out, leaves, do))
        counts = build.launch_counts()
        assert (counts["flash_attention_stats"], counts["flash_bwd_dq"],
                counts["flash_bwd_dkv"], counts["flash_bwd_dqkv"],
                counts["flash_attention"]) == (
                    (1, 0, 0, 1, 0) if fused else (1, 1, 1, 0, 0))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    o, m, l = flash_attention_stats(q, k, v)
    want = flash_attention_bwd(q, k, v, o, do.contiguous(), m, l)
    assert all(torch.equal(a, b) for a, b in zip(runs[0], want))


def _fused_backward_matches(cuda, T, S, D, causal, seed):
    """K9 against its plain version and against K7 and K8, on K6b's o, m,
    l and a random cotangent: dq, dk and dv within 2 bf16 ulps of the
    magnitude each sums; two K9 runs bit for bit."""
    q, k, v = _qkv(cuda, T, S, D, seed)
    do = _qkv(cuda, T, S, D, seed + 1)[0]
    o, m, l = flash_attention_stats(q, k, v, causal)
    dvec = attention_dvec(o, do)
    build.reset_launch_counts()
    got = flash_bwd_dqkv(q, k, v, do, m, l, dvec, causal)
    counts = build.launch_counts()
    assert (counts["flash_bwd_dqkv"], counts["flash_bwd_dq"],
            counts["flash_bwd_dkv"]) == (1, 0, 0)
    torch.cuda.synchronize()
    want = flash_bwd_dqkv_plain(q, k, v, do, m, l, dvec, causal)
    sweeps = (flash_bwd_dq(q, k, v, do, m, l, dvec, causal),
              *flash_bwd_dkv(q, k, v, do, m, l, dvec, causal))
    mags = flash_attention_bwd_magnitude(q, k, v, o, do, m, l, causal)
    for name, g, w, sw, mg in zip(("dq", "dk", "dv"), got, want, sweeps,
                                  mags):
        assert g.dtype == torch.bfloat16 and g.shape == q.shape
        assert bool(torch.isfinite(g.float()).all()), name
        assert parity.attention_close(_host(g), _host(w), _host(mg)), name
        assert parity.attention_close(_host(g), _host(sw), _host(mg)), name
    again = flash_bwd_dqkv(q, k, v, do, m, l, dvec, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("T", [1, 63, 64, 65, 130, 200])
@pytest.mark.parametrize("D", [16, 32, 40, 128, 20, 160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_fused_backward_kernel_matches_plain_version(cuda, T, D, causal):
    """K9 at one K block (T <= 64) and several with a ragged last one
    (65, 130, 200), D in one tile (16, 32, 128), padded in the kernel
    (40) or by the wrapper (20), and in 128-column chunks (160, 256)."""
    _fused_backward_matches(cuda, T, 3, D, causal, 7 * T + D)


@pytest.mark.parametrize("causal", [True, False])
def test_fused_backward_kernel_with_its_workspace(cuda, causal):
    """K9 at T = 2048, S = 32, D = 128 (a chunk of the production
    temporal shape, which the reference's gate sends to its fused
    kernel): 32 heads' dq accumulators of 1 MiB each in the f32
    workspace, 32 K blocks a head."""
    assert fused_bwd_route(2048, 32, 128)
    assert ca._dqkv_workspace_floats(2048, 32, 128) == 2048 * 128 * 32
    assert ca._dqkv_workspace_floats(65, 3, 160) == 128 * 128 * 3 * 2
    _fused_backward_matches(cuda, 2048, 32, 128, causal, 3)


def test_flash_backward_kernels_refuse_what_they_cannot_take(cuda):
    q, k, v = _qkv(cuda, 64, 2, 16, 0)
    o, m, l = flash_attention_stats(q, k, v)
    dvec = attention_dvec(o, q)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention_stats(q.float(), k, v)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_bwd_dq(q, k, v, q.float(), m, l, dvec)
    wide = torch.randn(64, 4, 16, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        flash_bwd_dkv(q, k, v, wide[:, ::2], m, l, dvec)
    flat = torch.zeros(64 * 2 * 16 + 1, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view(64, 2, 16)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    for fn in (lambda x: flash_attention_stats(x, k, v),
               lambda x: flash_bwd_dq(q, k, v, x, m, l, dvec),
               lambda x: flash_bwd_dkv(x, k, v, q, m, l, dvec)):
        with pytest.raises(ValueError, match="aligned"):
            fn(shifted)
    with pytest.raises(ValueError, match="stats"):
        flash_bwd_dq(q, k, v, q, m.t(), l, dvec)
    with pytest.raises(ValueError, match="stats"):
        flash_bwd_dkv(q, k, v, q, m, l.double(), dvec)


def test_temporal_train_step_on_card_matches_cpu(cuda):
    """One sequence-supervised train step on the card (K6b, K7, K8 once
    each) against the same step on the CPU: the loss within 1e-4, the
    gradients within the gradient tolerance."""
    kw = dict(embed_dim=32, hidden_dim=64, supervision="sequence")
    model = TemporalTrafficModel(**kw)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    window, batch = synthetic_window(np.random.default_rng(0), steps=130,
                                     groups=5, endpoints=8, per_step=True,
                                     device="cpu")
    on_card = {k: x.to(cuda) for k, x in params.items()}
    card_batch = batch._replace(mask=batch.mask.to(cuda),
                                target=batch.target.to(cuda))
    build.reset_launch_counts()
    loss, grads = value_and_grad(model.loss, on_card, window.to(cuda),
                                 card_batch)
    counts = build.launch_counts()
    assert (counts["flash_attention_stats"], counts["flash_bwd_dq"],
            counts["flash_bwd_dkv"], counts["flash_attention"]) == (1, 1, 1, 0)
    cpu_loss, cpu_grads = value_and_grad(model.loss, params, window, batch)
    np.testing.assert_allclose(float(loss), float(cpu_loss), rtol=1e-4)
    for name, g in grads.items():
        assert parity.grads_close(_host(g), _host(cpu_grads[name])), name
    new, _, _ = model.train_step(on_card, model.init_opt_state(on_card),
                                 window.to(cuda), card_batch)
    assert all(x.device.type == "cuda" and x.dtype == torch.bfloat16
               for x in new.values())


def test_chunked_temporal_train_step_on_card_matches_cpu(cuda):
    """A sequence loss with ``attention_chunk=8`` over 40 streams on the
    card: 5 calls, each one K6b and one K9 launch, no K7 or K8; the loss
    within 1e-4 of the CPU's and of the unchunked loss on the card, the
    gradients within the gradient tolerance of both."""
    kw = dict(embed_dim=32, hidden_dim=64, supervision="sequence")
    chunked = TemporalTrafficModel(attention_chunk=8, **kw)
    params = chunked.init_params(torch.Generator().manual_seed(0),
                                 device="cpu")
    window, batch = synthetic_window(np.random.default_rng(2), steps=130,
                                     groups=5, endpoints=8, per_step=True,
                                     device="cpu")
    on_card = {k: x.to(cuda) for k, x in params.items()}
    card_batch = batch._replace(mask=batch.mask.to(cuda),
                                target=batch.target.to(cuda))
    build.reset_launch_counts()
    loss, grads = value_and_grad(chunked.loss, on_card, window.to(cuda),
                                 card_batch)
    counts = build.launch_counts()
    assert (counts["flash_attention_stats"], counts["flash_bwd_dqkv"],
            counts["flash_bwd_dq"], counts["flash_bwd_dkv"]) == (5, 5, 0, 0)
    others = (value_and_grad(chunked.loss, params, window, batch),
              value_and_grad(TemporalTrafficModel(**kw).loss, on_card,
                             window.to(cuda), card_batch))
    for other_loss, other_grads in others:
        np.testing.assert_allclose(float(loss), float(other_loss),
                                   rtol=1e-4)
        for name, g in grads.items():
            assert parity.grads_close(_host(g), _host(other_grads[name])), \
                name


def _head_inputs(cuda, T, S, D, H, seed):
    """x [T, S, D] bf16, params with the reference test's scales, and an
    f32 cotangent ds [T, S]."""
    g = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device=cuda, generator=g)

    bf = torch.bfloat16
    return (randn(T, S, D).to(bf), (randn(D, H) * 0.1).to(bf),
            torch.linspace(-0.1, 0.1, H, device=cuda).to(bf),
            (randn(H, 1) * 0.1).to(bf),
            torch.full((1,), 0.05, device=cuda).to(bf), randn(T, S))


def _head_matches_plain(cuda, T, S, D, H, seed):
    x, w1, b1, w2, b2, ds = _head_inputs(cuda, T, S, D, H, seed)
    build.reset_launch_counts()
    s = score_head_forward(x, w1, b1, w2, b2)
    grads = score_head_bwd(x, w1, b1, w2, b2, ds)
    counts = build.launch_counts()
    assert (counts["score_head_fwd"], counts["score_head_bwd"]) == (1, 1)
    torch.cuda.synchronize()
    assert s.dtype == torch.float32 and s.shape == (T, S)
    assert parity.scores_close(
        _host(s), _host(score_head_plain(x, w1, b1, w2, b2)),
        scale=_host(score_head_magnitude(x, w1, b1, w2, b2)))
    want = score_head_bwd_plain(x, w1, b1, w2, b2, ds)
    for name, g, like in zip(("dx", "dw1", "db1", "dw2", "db2"), grads,
                             (x, w1, b1, w2, b2)):
        assert g.dtype == like.dtype and g.shape == like.shape, name
        assert bool(torch.isfinite(g.float()).all()), name
    assert parity.scores_close(
        _host(grads[0]), _host(want[0]),
        scale=_host(score_head_dx_magnitude(x, w1, b1, w2, b2, ds)))
    limits = score_head_weight_grad_limits(x, w1, b1, w2, b2, ds)
    for name, g, w, lim in zip(("dw1", "db1", "dw2", "db2"), grads[1:],
                               want[1:], limits):
        assert weight_grad_error(g, w, lim) <= 1.0, name


@pytest.mark.parametrize("H", [16, 128, 200, 256, 512])
@pytest.mark.parametrize("D", [8, 20, 96, 128, 160])
def test_score_head_kernels_match_plain_versions(cuda, D, H):
    """K10 and K11 against their plain versions at 703 rows (not a
    multiple of the 64-row tile): D padded by the wrapper (20), in one
    tile (8, 96, 128) and in 128-column chunks (160); H in one 64-unit
    chunk (16), several (128, 200, 256) and many (512).  Scores and dx
    within 2 bf16 ulps of what each sums (``score_head_magnitude``,
    ``score_head_dx_magnitude``), the weight gradients within
    ``score_head_weight_grad_limits``."""
    _head_matches_plain(cuda, 19, 37, D, H, D + H)


def test_score_head_kernels_match_plain_versions_over_many_row_tiles(cuda):
    """The backward's persistent grid with several row tiles a CTA, at
    the train command's widths (D = 32, H = 128): 64,000 rows, where each
    weight gradient cancels to a few hundredths of its absolute sum, so
    its limit (a share of the root sum of squares of its terms) fails a
    backward that loses any CTA's partial or any CTA's later tiles."""
    _head_matches_plain(cuda, 64, 1000, 32, 128, 3)


def test_score_head_backward_is_reproducible_and_autograd_takes_it(cuda):
    """Two K11 runs agree bit for bit (no atomics; the per-CTA partials
    sum in a fixed order), and autograd through ``score_head`` runs K10
    once forward and K11 once backward, giving K11's gradients."""
    x, w1, b1, w2, b2, ds = _head_inputs(cuda, 64, 300, 32, 128, 4)
    runs = [score_head_bwd(x, w1, b1, w2, b2, ds) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    build.reset_launch_counts()
    out = score_head(*leaves)
    got = torch.autograd.grad(out, leaves, ds)
    counts = build.launch_counts()
    assert (counts["score_head_fwd"], counts["score_head_bwd"]) == (1, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, runs[0]))


def test_score_head_refuses_what_it_cannot_take(cuda):
    x, w1, b1, w2, b2, _ = _head_inputs(cuda, 4, 5, 16, 32, 5)
    with pytest.raises(ValueError, match="bfloat16"):
        score_head_forward(x, w1.float(), b1, w2, b2)
    with pytest.raises(ValueError, match="w2"):
        score_head_forward(x, w1, b1, w2[:16], b2)
    with pytest.raises(ValueError):
        score_head_forward(x, w1.cpu(), b1, w2, b2)
    with pytest.raises(ValueError, match="ds"):
        score_head_bwd(x, w1, b1, w2, b2, torch.zeros(5, 4, device=cuda))


def test_fused_head_on_card_matches_dense_head_and_cpu(cuda):
    """A sequence loss through ``head="fused"`` on the card (K10 and K11
    once each, with the flash kernels) against the dense head on the
    card, and against ``head="fused_always"`` on the CPU (the plain
    versions): the losses within rtol 1e-4, the gradients within the
    gradient tolerance."""
    kw = dict(embed_dim=32, hidden_dim=64, supervision="sequence")
    fused = TemporalTrafficModel(head="fused", **kw)
    params = fused.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    window, batch = synthetic_window(np.random.default_rng(1), steps=130,
                                     groups=5, endpoints=8, per_step=True,
                                     device="cpu")
    on_card = {k: x.to(cuda) for k, x in params.items()}
    card_batch = batch._replace(mask=batch.mask.to(cuda),
                                target=batch.target.to(cuda))
    build.reset_launch_counts()
    loss, grads = value_and_grad(fused.loss, on_card, window.to(cuda),
                                 card_batch)
    counts = build.launch_counts()
    assert (counts["score_head_fwd"], counts["score_head_bwd"],
            counts["flash_attention_stats"]) == (1, 1, 1)
    build.reset_launch_counts()
    dense_loss, dense_grads = value_and_grad(
        TemporalTrafficModel(**kw).loss, on_card, window.to(cuda),
        card_batch)
    counts = build.launch_counts()
    assert (counts["score_head_fwd"], counts["score_head_bwd"]) == (0, 0)
    cpu_loss, cpu_grads = value_and_grad(
        TemporalTrafficModel(head="fused_always", **kw).loss, params,
        window, batch)
    for other, other_grads in ((dense_loss, dense_grads),
                               (cpu_loss, cpu_grads)):
        np.testing.assert_allclose(float(loss), float(other), rtol=1e-4)
        for name, g in grads.items():
            assert parity.grads_close(_host(g), _host(other_grads[name])), \
                name


def test_plan_command_at_hidden_256_on_card_matches_cpu(cuda, capsys):
    """``plan --model mlp --hidden 256`` under the default ``--serve auto``
    runs K3 on the card and plans the CPU's weights within the port's
    weight tolerance."""
    import json

    from aws_global_accelerator_controller_tpu_torch.cmd.compute import main

    argv = ["plan", "--model", "mlp", "--hidden", "256", "--groups", "512",
            "--endpoints", "16", "--seed", "3"]
    build.reset_launch_counts()
    assert main(argv + ["--device", "cuda"]) == 0
    assert build.launch_counts()["fused_mlp_plan"] == 1
    card = json.loads(capsys.readouterr().out)
    assert main(argv + ["--device", "cpu"]) == 0
    cpu = json.loads(capsys.readouterr().out)
    assert parity.weights_close(np.asarray(card["weights"]),
                                np.asarray(cpu["weights"]))


# K6b-ring at the shapes of chip_smoke.py's rows, and at ragged ones
RING_SHAPES = [(4096, 128, 128, 32, True), (4096, 128, 128, 32, False),
               (128, 2048, 2048, 128, True), (64, 64, 128, 32, False),
               (64, 128, 64, 32, False), (256, 128, 128, 20, True),
               (256, 128, 128, 160, True), (3, 1, 1, 8, True),
               (5, 70, 200, 40, True), (5, 200, 70, 16, True),
               (2, 130, 65, 256, False)]


@pytest.mark.parametrize("H,Tq,Tk,D,causal", RING_SHAPES)
def test_ring_stats_kernel_matches_plain_version(cuda, H, Tq, Tk, D, causal):
    """K6b-ring (f32 q, bf16 k and v) against its plain version at the
    kernel's block, TF32 off (the plain q'.k^T a true f32 product): o
    within 2 bf16 ulps of the magnitude it sums, l within 1e-5 relative,
    m within D f32 ulps of the largest |q'| . |k| (a q' rounded to bf16
    would move m by about 2**-9 of |s|); two runs bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(H + Tq + Tk + D)
    q = torch.randn(H, Tq, D, device=cuda, generator=g)
    k, v = (torch.randn(H, Tk, D, device=cuda, generator=g)
            .to(torch.bfloat16) for _ in range(2))
    o, m, l = ca.flash_attention_stats_ring(q, k, v, causal)
    po, pm, pl = ca.flash_attention_stats_ring_plain(q, k, v, causal, BLOCK_K)
    mag = ca.flash_attention_stats_ring_plain(q, k, v.abs(), causal,
                                              BLOCK_K)[0]
    assert o.dtype == m.dtype == l.dtype == torch.float32
    assert tuple(o.shape) == (H, Tq, D) and tuple(m.shape) == (H, Tq)
    assert parity.attention_close(_host(o), _host(po), _host(mag))
    np.testing.assert_allclose(_host(l), _host(pl), rtol=1e-5, atol=0)
    s_mag = float(((q.abs() * D ** -0.5)
                   @ k.float().abs().transpose(1, 2)).max())
    assert float((m - pm).abs().max()) <= D * 2.0 ** -24 * s_mag
    again = ca.flash_attention_stats_ring(q, k, v, causal)
    assert all(torch.equal(a, b) for a, b in zip(again, (o, m, l)))


def test_ring_stats_kernel_refuses_what_it_cannot_take(cuda):
    q = torch.zeros(2, 64, 16, device=cuda)
    kv = torch.zeros(2, 64, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32 q"):
        ca.flash_attention_stats_ring(q.to(torch.bfloat16), kv, kv)
    with pytest.raises(ValueError, match="bfloat16"):
        ca.flash_attention_stats_ring(q, kv.float(), kv)
    strided = torch.zeros(2, 16, 64, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ca.flash_attention_stats_ring(strided, kv, kv)
    with pytest.raises(ValueError, match=r"\[H, Tq, D\]"):
        ca.flash_attention_stats_ring(q, kv[:1], kv[:1])
    with pytest.raises(ValueError):
        ca.flash_attention_stats_ring(q.cpu(), kv, kv)


def test_ring_of_two_ranks_on_one_card(cuda):
    """Two gloo ranks on card 0 (``--device cuda:0``, staged through the
    host): ``kernels/chip_checks.py ring`` holds the flash-local ring and
    its gradients against dense attention and checks each rank's
    K6b-ring launches, and exits non-zero on a miss."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m",
         "aws_global_accelerator_controller_tpu_torch.kernels.chip_checks",
         "ring", "--device", f"cuda:{cuda.index}", "--T", "256", "--H",
         "64", "--D", "32"], cwd=root, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["launches_by_seq_rank"] == {"0": 1, "1": 2}
    assert out["staged_bytes_rank0"] > 0
