"""The port's kernels and device paths on the card.

Every test here needs a CUDA device (the ``cuda`` marker) and skips
where none is visible; it imports neither JAX nor the JAX package, so
on a machine with the card and without JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Each kernel is held against its plain version on the same inputs with
the port's tolerances (``parity.py``); the planners on the card are held
against themselves on the CPU and against their own full repack.
"""
import ctypes
import subprocess

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
    cuda_head,
    cuda_weights,
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
    plan_tensor_core_route,
    relu,
    score_rows_cuda,
)
from aws_global_accelerator_controller_tpu_torch.ops.cuda_weights import (
    plan_block,
    plan_weights_cuda,
)
from aws_global_accelerator_controller_tpu_torch.parallel.fleet import (
    _splice_grids,
    make_row_splice,
    pack_splice,
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


@pytest.mark.parametrize("n", [1, 3, 1024, 4097])
def test_probe_kernel_doubles_any_length_and_offset(cuda, n):
    """K1's float4 lanes, its scalar tail past a multiple of 4, and a view
    one float off a 16-byte boundary (every quad scalar)."""
    buf = torch.randn(n + 1, device=cuda)
    for x in (buf[:n], buf[1:]):
        assert x.is_contiguous()
        assert torch.equal(tdevice.probe_double(x), x * 2)
    assert buf[1:].data_ptr() % 16


def test_launch_floor_kernel_launches(cuda):
    before = build.launch_counts()["launch_floor"]
    tdevice.launch_floor(cuda)
    torch.cuda.synchronize()
    assert build.launch_counts()["launch_floor"] == before + 1


#: widths of K2's sweep: its quad route (E a multiple of 4 up to 32), its
#: scalar route on either side, and past one warp
QUANTIZER_E = (1, 3, 4, 8, 12, 16, 20, 28, 32, 33, 40, 300)


def _quantizer_cta_rows(E):
    """Rows one CTA of K2 plans (``csrc/plan_weights.cu``: 256 threads;
    the quad route a row on row_width(E) / 4 lanes, the scalar route on
    row_width(E) lanes)."""
    width = 1
    while width < min(E, 32):
        width *= 2
    quad = E % 4 == 0 and E <= 32
    return 256 // (width // 4 if quad else width)


def _quantizer_inputs(G, E, seed, device):
    rng = np.random.default_rng(seed)
    s = torch.from_numpy((rng.standard_normal((G, E)) * 3)
                         .astype(np.float32)).to(device)
    m = torch.from_numpy(np.arange(E)[None, :]
                         < rng.integers(0, E + 1, (G, 1))).to(device)
    m[::5] = False
    return s, m


@pytest.mark.parametrize("G,E", [(64, 4), (48, 16), (32, 32), (16, 7),
                                 (9, 40), (100_000, 4)]
                         + [(g, E) for E in QUANTIZER_E
                            for g in ("1", "cta-1", "cta+1", "1000003")])
def test_quantizer_kernel_matches_plain_version(cuda, G, E):
    """K2 against its plain version (weights +-1 on <= 0.5% of cells) at
    every route's widths and at 1 row, a CTA's rows +- 1 and a million
    and three rows; masked cells and all-masked rows (every fifth) 0."""
    if isinstance(G, str):
        G = {"1": 1, "cta-1": _quantizer_cta_rows(E) - 1,
             "cta+1": _quantizer_cta_rows(E) + 1, "1000003": 1_000_003}[G]
    s, m = _quantizer_inputs(G, E, G + E, cuda)
    got = plan_weights_cuda(s, m).cpu().numpy()
    assert parity.weights_close(got, plan_block(s, m).cpu().numpy())
    assert not got[~m.cpu().numpy()].any()


@pytest.mark.parametrize("E", QUANTIZER_E)
def test_quantizer_kernel_rounds_equal_scores_half_to_even(cuda, E):
    """Rows of k equal valid scores (k from 0 to E, each at a score of its
    own) are p = 1 / k exactly: 2 equal cells give 127.5, which rounds
    half to even to 128, 3 give 85.  K2 must equal its plain version
    exactly on every such row."""
    rng = np.random.default_rng(E)
    G = 3 * (E + 1)
    k = np.arange(G) % (E + 1)
    cols = rng.permuted(np.tile(np.arange(E), (G, 1)), axis=1)
    mask = np.zeros((G, E), bool)
    for g in range(G):
        mask[g, cols[g, :k[g]]] = True
    scores = np.where(mask, (rng.standard_normal((G, 1)) * 5)
                      .astype(np.float32), rng.standard_normal((G, E))
                      .astype(np.float32) * 9)
    s = torch.from_numpy(scores).to(cuda)
    m = torch.from_numpy(mask).to(cuda)
    got = plan_weights_cuda(s, m)
    assert torch.equal(got, plan_block(s, m))
    got = got.cpu().numpy()
    for g in range(G):
        want = {0: 0, 1: 255, 2: 128, 3: 85}.get(k[g])
        if want is not None:
            assert (got[g][mask[g]] == want).all(), (g, k[g])


@pytest.mark.parametrize("E", [4, 8, 12, 16, 20, 24, 28, 32])
def test_quantizer_kernel_on_misaligned_views(cuda, E):
    """Views off their 16-byte boundary (scores, mask and out each one
    cell into a buffer) take K2's scalar route and must give the quad
    route's weights on an aligned copy bit for bit: the two routes sum a
    row in one tree.  Through the wrapper (scores and mask off) and
    through the entry point itself (each of the three off alone, and all
    three); rows of zeros of both signs take the same weights whatever
    the sign of their max."""
    G = 5000
    s, m = _quantizer_inputs(G, E, E, cuda)
    s[1::11] = 0.0
    s[1::11, ::2] = -0.0
    want = plan_weights_cuda(s, m)
    s_buf = torch.empty(G * E + 1, device=cuda)
    s_off = s_buf[1:].view(G, E)
    s_off.copy_(s)
    m_buf = torch.empty(G * E + 1, dtype=torch.bool, device=cuda)
    m_off = m_buf[1:].view(G, E)
    m_off.copy_(m)
    assert s_off.data_ptr() % 16 and m_off.data_ptr() % 4
    assert torch.equal(plan_weights_cuda(s_off, m_off), want)
    for off in ((True, False, False), (False, True, False),
                (False, False, True), (True, True, True)):
        o_buf = torch.full((G * E + 1,), -7, dtype=torch.int32, device=cuda)
        out = o_buf[1:].view(G, E) if off[2] else o_buf[:-1].view(G, E)
        cuda_weights._PLAN(cuda, s_off if off[0] else s,
                           m_off if off[1] else m, out, G, E)
        assert torch.equal(out, want), off


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


#: slices of a batch that cross K3's 64-row tiles on the tensor cores,
#: lie inside one, or hold 37 rows
K3_SLICES = ((0, 1), (63, 64), (64, 65), (127, 128), (128, 129),
             (129, 130), (63, 129), (5, 42), (0, 37))


def _k3_inputs(cuda, G, E, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((G, E, F))
                         .astype(np.float32)).to(cuda)
    m = torch.from_numpy(rng.random((G, E)) < 0.8).to(cuda)
    m[::5] = False
    return x, m


@pytest.mark.parametrize("E", [4, 7, 16, 300])
@pytest.mark.parametrize("H", [128, 192, 256])
def test_fused_mlp_tensor_cores_bit_contract(cuda, H, E):
    """K3 on the tensor cores (F = 8): the plan entry's weights are K2's
    on the row entry's scores of the same rows, bit for bit (groups of 7
    and 37 leave a tile's last rows idle, a group of 300 spans five
    tiles); a row scores the same alone, in 37 rows and across the tile
    edges (rows 63, 64, 65, 127, 128, 129); and both entries lie within
    the port's tolerances of their plain versions."""
    p = TrafficPolicyModel(hidden_dim=H).init_params(
        torch.Generator().manual_seed(H + E), device=cuda)
    G = max(6, 2400 // E)
    x, m = _k3_inputs(cuda, G, E, H * E)
    build.reset_launch_counts()
    w = forward_cuda(p, x, m)
    assert build.launch_counts()["fused_mlp_plan"] == 1
    rows = x.reshape(-1, F)
    s = score_rows_cuda(p, rows)
    assert torch.equal(w, plan_weights_cuda(s.view(G, E), m))
    assert not w[~m].any()
    assert parity.weights_close(w.cpu().numpy(),
                                forward_reference(p, x, m).cpu().numpy())
    assert parity.scores_close(s.cpu().numpy(),
                               dense_scores(p, rows).cpu().numpy())
    for a, b in K3_SLICES:
        assert torch.equal(score_rows_cuda(p, rows[a:b]), s[a:b]), (a, b)
    G1 = 1 if E > 64 else 64 // E + 1    # a tile and a group past it
    assert torch.equal(forward_cuda(p, x[:G1], m[:G1]), w[:G1])


def _padded_to_cuda_cores(p, x):
    """The same MLP with zero features up to F = 17 (the CUDA-core
    route): w1 gains zero rows, x zero columns."""
    q = dict(p)
    pad = 17 - p["w1"].shape[0]
    q["w1"] = torch.cat([p["w1"], p["w1"].new_zeros(pad, p["w1"].shape[1])])
    return q, torch.cat([x, x.new_zeros(*x.shape[:-1], pad)], dim=-1)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("H", [64, 128, 192, 256])
def test_fused_mlp_tensor_cores_equal_cuda_cores(cuda, H, bias):
    """The tensor-core route (F = 8) gives the CUDA-core route's scores
    and weights value for value: the same MLP with zero features up to
    F = 17 takes the CUDA-core route, whose fmaf chains add only exact
    zeros to the same sums.  200,000 rows, some 30 times larger, with
    zero or random biases."""
    p = TrafficPolicyModel(hidden_dim=H).init_params(
        torch.Generator().manual_seed(H + 11), device=cuda)
    g = torch.Generator(cuda).manual_seed(H + int(bias))
    if bias:
        for k in ("b1", "b2", "b3"):
            p[k] = (torch.randn(p[k].shape, device=cuda, generator=g)
                    * 0.3).to(torch.bfloat16)
    rows = torch.randn(200_000, F, device=cuda, generator=g)
    rows[::97] *= 30
    q, rows17 = _padded_to_cuda_cores(p, rows)
    assert torch.equal(score_rows_cuda(p, rows), score_rows_cuda(q, rows17))
    x, m = _k3_inputs(cuda, 1000, 37, H)
    q, x17 = _padded_to_cuda_cores(p, x)
    assert torch.equal(forward_cuda(p, x, m), forward_cuda(q, x17, m))


def test_fused_mlp_plan_entry_at_its_largest_group(cuda):
    """At H = 256 the tensor-core plan entry takes a group of up to 2752
    rows (43 tiles beside the weights and h1's copy in shared memory);
    a group of 2753 takes the CUDA-core route, which gives the same
    values: at both, K2 on the row entry's scores."""
    assert plan_tensor_core_route(2752, F, 256)
    assert not plan_tensor_core_route(2753, F, 256)
    p = TrafficPolicyModel(hidden_dim=256).init_params(
        torch.Generator().manual_seed(5), device=cuda)
    x, m = _k3_inputs(cuda, 3, 2753, 5)
    for E in (2752, 2753):
        w = forward_cuda(p, x[:, :E], m[:, :E])
        s = score_rows_cuda(p, x[:, :E].reshape(-1, F))
        assert torch.equal(w, plan_weights_cuda(s.view(3, E), m[:, :E])), E


def _plan_entry_limit(H):
    """The largest group the plan entry takes on the tensor cores at H,
    found by bisection of the library's own route (a group of at most
    one tile always fits; past it the item is the group, so the route
    holds up to a limit and not beyond)."""
    lo, hi = 64, 1 << 16
    assert plan_tensor_core_route(lo, F, H)
    assert not plan_tensor_core_route(hi, F, H)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if plan_tensor_core_route(mid, F, H) else (lo, mid)
    return lo


@pytest.mark.parametrize("past", [0, 1])
@pytest.mark.parametrize("H", [64, 128, 192, 256])
def test_fused_mlp_plan_entry_past_its_shared_memory(cuda, H, past):
    """A group at the tensor-core plan entry's limit (whole tiles) and
    one row past it (the CUDA-core route, as the library says) plans as
    the plain version does, under ``parity.weights_close``, and as K2
    on the row entry's scores."""
    limit = _plan_entry_limit(H)
    assert limit % 64 == 0
    E = limit + past
    assert plan_tensor_core_route(E, F, H) == (not past)
    p = TrafficPolicyModel(hidden_dim=H).init_params(
        torch.Generator().manual_seed(H + past), device=cuda)
    x, m = _k3_inputs(cuda, 2, E, H + past)
    w = forward_cuda(p, x, m)
    assert parity.weights_close(w.cpu().numpy(),
                                forward_reference(p, x, m).cpu().numpy())
    s = score_rows_cuda(p, x.reshape(-1, F))
    assert torch.equal(w, plan_weights_cuda(s.view(2, E), m))


@pytest.mark.parametrize("H", [128, 256])
def test_fused_mlp_row_scores_in_a_batch_of_millions(cuda, H):
    """A row scores the same in a 2.5M-row batch (a full repack's size)
    as alone or in a slice of 37."""
    p = TrafficPolicyModel(hidden_dim=H).init_params(
        torch.Generator().manual_seed(H), device=cuda)
    rows = torch.randn(2_500_000, F, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(H))
    s = score_rows_cuda(p, rows)
    for a, b in ((0, 1), (1_250_000, 1_250_037), (1_250_063, 1_250_064),
                 (2_499_963, 2_500_000), (2_499_999, 2_500_000)):
        assert torch.equal(score_rows_cuda(p, rows[a:b]), s[a:b]), (a, b)
    assert bool(torch.isfinite(s).all())


@pytest.mark.parametrize("H", [64, 256, 129, 320])
def test_fused_mlp_route_boundary(cuda, H):
    """H = 64 and 256 take the tensor cores, H = 129 and 320 the CUDA
    cores (F = 8): each entry against its plain version, and a row
    scores the same in any batch."""
    p = TrafficPolicyModel(hidden_dim=H).init_params(
        torch.Generator().manual_seed(H), device=cuda)
    x, m = _k3_inputs(cuda, 300, 7, H)
    assert parity.weights_close(forward_cuda(p, x, m).cpu().numpy(),
                                forward_reference(p, x, m).cpu().numpy())
    rows = x.reshape(-1, F)
    s = score_rows_cuda(p, rows)
    assert parity.scores_close(s.cpu().numpy(),
                               dense_scores(p, rows).cpu().numpy())
    for a, b in K3_SLICES:
        assert torch.equal(score_rows_cuda(p, rows[a:b]), s[a:b]), (a, b)


@pytest.mark.parametrize("H", [128, 256])
def test_fused_mlp_tensor_cores_take_views_at_any_offset(cuda, H):
    """The route does not depend on alignment: x and every param a bf16
    off a 16-byte boundary give the aligned copies' scores and weights
    bit for bit."""
    p = TrafficPolicyModel(hidden_dim=H).init_params(
        torch.Generator().manual_seed(H + 1), device=cuda)
    x, m = _k3_inputs(cuda, 200, 16, H + 1)
    xb = x.to(torch.bfloat16)

    def off(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16
        return view

    q = {k: off(v) for k, v in p.items()}
    rows = xb.reshape(-1, F)
    assert torch.equal(score_rows_cuda(q, off(rows)),
                       score_rows_cuda(p, rows))
    assert torch.equal(forward_cuda(q, off(xb), m), forward_cuda(p, xb, m))


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


def _wave(cuda, widths, S=6, cap=50, K=70, pad=20, seed=0):
    """Grids [S, cap, W] (W = 0: a plane [S, cap]) on the card, K real rows
    at distinct positions but the last 3, which repeat the first 3 with
    equal rows, and ``pad`` pad rows past K that repeat row 0."""
    rng = np.random.default_rng(seed)
    shapes = [(S, cap, W) if W else (S, cap) for W in widths]
    grids = [torch.from_numpy(rng.integers(0, 1 << 30, sh).astype(
        np.int32)).to(cuda) for sh in shapes]
    flat = rng.choice(S * cap, K - 3, replace=False)
    flat = np.concatenate([flat, flat[:3], np.repeat(flat[:1], pad)])
    blocks = []
    for sh in shapes:
        b = rng.integers(0, 1 << 30, (K + pad, *sh[2:])).astype(np.int32)
        b[K - 3:K] = b[:3]
        b[K:] = b[0]
        blocks.append(b)
    return grids, flat // cap, flat % cap, blocks, K


def _plain_wave(grids, ks, kg, blocks):
    out = []
    for g, b in zip(grids, blocks):
        S, cap = g.shape[:2]
        flat = g.cpu().clone().reshape(S * cap, -1)
        lin = torch.from_numpy(ks * cap + kg)
        row_splice_reference(flat, lin, torch.from_numpy(b).reshape(
            lin.shape[0], -1))
        out.append(flat.view(g.shape))
    return out


@pytest.mark.parametrize("widths", [tuple(range(1, 9)),
                                    tuple(range(9, 17)), (17, 0, 4, 4)])
def test_splice_kernel_splices_many_grids_in_one_launch(cuda, widths):
    """K4's table at widths 1-17 and a plane, up to 8 grids a launch, the
    K real rows of K + pad: one launch, the plain version's grids."""
    grids, ks, kg, blocks, K = _wave(cuda, widths, seed=len(widths))
    want = _plain_wave(grids, ks, kg, blocks)
    before = build.launch_counts()["row_splice"]
    make_row_splice(cuda)(grids, ks[:K], kg[:K], [b[:K] for b in blocks])
    torch.cuda.synchronize()
    assert build.launch_counts()["row_splice"] == before + 1
    for g, w in zip(grids, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("W", [1, 4, 8, 12])
def test_splice_kernel_takes_rows_off_16_byte_alignment(cuda, W):
    """Rows one int32 off a 16-byte boundary take the scalar path, the
    aligned copy of the same rows the vector path: equal grids."""
    grids, ks, kg, blocks, K = _wave(cuda, (W, W), seed=W)
    lin, (rows, _) = pack_splice(grids[0].shape[:2], ks[:K], kg[:K],
                                 [b[:K] for b in blocks], cuda)
    off = torch.empty(rows.numel() + 1, dtype=torch.int32, device=cuda)
    view = off[1:].view(rows.shape)
    view.copy_(rows)
    assert view.data_ptr() % 16 and rows.data_ptr() % 16 == 0
    S, cap = grids[0].shape[:2]
    aligned, scalar = (g.view(S * cap, W) for g in grids)
    scalar.copy_(aligned)
    _splice_grids([aligned, scalar], lin, [rows, view])
    want = _plain_wave(grids[:1], ks[:K], kg[:K], [blocks[0][:K]])[0]
    assert torch.equal(aligned.cpu().view(want.shape), want)
    assert torch.equal(scalar, aligned)


@pytest.mark.parametrize("axis", ["ks", "kg"])
def test_splice_kernel_refuses_a_wave_outside_the_grid(cuda, axis):
    """A position off its own axis, last in the wave: IndexError, no
    launch, no grid written."""
    grids, ks, kg, blocks, K = _wave(cuda, (4, 4, 4, 4, 0, 0))
    ks, kg = ks[:K].copy(), kg[:K].copy()
    (ks if axis == "ks" else kg)[-1] = grids[0].shape[0 if axis == "ks"
                                                       else 1]
    before_grids = [g.clone() for g in grids]
    before = build.launch_counts()["row_splice"]
    with pytest.raises(IndexError):
        make_row_splice(cuda)(grids, ks, kg, [b[:K] for b in blocks])
    torch.cuda.synchronize()
    assert build.launch_counts()["row_splice"] == before
    for g, b in zip(grids, before_grids):
        assert torch.equal(g, b)


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
    assert counts["row_splice"] == 2 and counts["plan_weights"] == 2
    assert not planner.plan_wave().device_call
    assert build.launch_counts() == counts
    assert planner.verify_full_repack()["match"] is True


def test_resident_waves_at_hidden_256_bitmatch_full_repack(cuda):
    """The resident planner's check rests on K3's row contract; with a
    256-unit model (on the tensor cores: w1 and w2 resident in shared
    memory, layer 2 in two 128-column chunks) a wave still bit-matches
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
                                   (64, 2, 256), (130, 3, 136),
                                   (72, 3, 288)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain_version(cuda, T, S, D,
                                                      causal):
    """K6a against its plain version at the kernel's K block: padded T
    (72, 130, 200), T = 1, D padded in the kernel (40 -> 64, 136 and 160
    -> 192), D padded by the wrapper (20 -> 24), one full-width tile up
    to 256, the chunked kernel past it (288), and the eval shape.
    Tolerance: 2 bf16 ulps of the magnitude averaged."""
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
@pytest.mark.parametrize("D", [16, 32, 40, 64, 128, 20, 160, 256, 136, 288])
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


def _forward_matches(cuda, T, S, D, causal, seed):
    """K6b against its plain version (o within 2 bf16 ulps of the
    magnitude, m and l within 1e-5) and K6a's o equal to K6b's."""
    q, k, v = _qkv(cuda, T, S, D, seed)
    o, m, l = flash_attention_stats(q, k, v, causal)
    o6a = flash_attention(q, k, v, causal)
    po, pm, pl = flash_attention_stats_plain(q, k, v, causal, BLOCK_K)
    mag = flash_attention_plain(q, k, v.abs(), causal, BLOCK_K)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o.float()).all())
    assert parity.attention_close(_host(o), _host(po), _host(mag))
    assert torch.equal(o, o6a)
    np.testing.assert_allclose(_host(m), _host(pm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_host(l), _host(pl), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,S", [(65, 300), (1024, 40)])
@pytest.mark.parametrize("D", [32, 128, 160])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_walks_more_tiles_than_the_card_has_sms(cuda, T, S, D,
                                                              causal):
    """More (head, q block) tiles than the card has SMs (600 and 640
    against 132), so that each CTA of the persistent grid walks several,
    of different lengths when causal."""
    assert S * -(-T // BLOCK_K) > torch.cuda.get_device_properties(
        cuda).multi_processor_count
    _forward_matches(cuda, T, S, D, causal, T + S + D)


def test_flash_forward_encodes_its_tensor_maps_per_call(cuda):
    """K6b captured in a CUDA graph at one shape and K6b again, the same
    kernel instantiation (D = 128, the stats written), launched on
    another stream at another T, S and other buffers while the graph
    replays: each launch carries its own tensor maps (a map kept once
    per instantiation would read the wrong tensors), so both equal
    their eager calls bit for bit."""
    qa, ka, va = _qkv(cuda, 1024, 16, 128, 3)
    qb, kb, vb = _qkv(cuda, 200, 24, 128, 4)
    want_a = flash_attention_stats(qa, ka, va)
    want_b = flash_attention_stats(qb, kb, vb, False)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        flash_attention_stats(qa, ka, va)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_a = flash_attention_stats(qa, ka, va)
    other = torch.cuda.Stream(cuda)
    for i in range(5):
        for x in out_a:
            x.zero_()
        other.wait_stream(torch.cuda.current_stream(cuda))
        graph.replay()
        with torch.cuda.stream(other):
            out_b = flash_attention_stats(qb, kb, vb, False)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out_a, want_a)), i
        assert all(torch.equal(a, b) for a, b in zip(out_b, want_b)), i


#: powers of two that take |acc| below 2^-64 or above 2^30, outside the
#: range where K6a's and K6b's division skips `/`
_FWD_EDGE_SCALES = (-110, -80, 32, 100)


def _fwd_edge_inputs(cuda, T, S, D, seed):
    """q within 2^-10 of 0 (every p within 2% of 1) and v of one sign a
    column with |v| in [1, 2): no acc cancels and no product is
    subnormal, even at 2^-110, so scaling v by a power of two scales
    acc and acc / l exactly."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = (torch.randn(T, S, D, device=cuda, generator=g)
         * 2.0 ** -10).to(torch.bfloat16)
    k = torch.randn(T, S, D, device=cuda, generator=g).to(torch.bfloat16)
    sign = torch.where(torch.arange(D, device=cuda) % 2 == 1, -1.0, 1.0)
    v = ((1 + torch.rand(T, S, D, device=cuda, generator=g))
         * sign).to(torch.bfloat16)
    return q, k, v


@pytest.mark.parametrize("e", _FWD_EDGE_SCALES)
@pytest.mark.parametrize("D", [32, 128, 160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_division_at_the_edges_of_its_range(cuda, e, D,
                                                          causal):
    """v scaled by 2^e in parts, so that warps hold |acc| outside the
    fast division's range: a whole head (every warp falls back to `/`),
    one column (a warp whose out-of-range values sit in a quarter of its
    lanes), and, causal, keys 0-7 of a head (rows 0-7 see only those;
    at e < 0 warp 0 of q block 0 falls back with its rows 8-15 in range
    while warps 1-3 take the fast path; non-causal, the upper half of
    the columns instead).  Both branches must give RN(acc / l): K6a's and
    K6b's o equal 2^e times their o of the unscaled v, value for value,
    wherever that holds exactly, and m and l do not move."""
    T, S = 200, 8
    q, k, v = _fwd_edge_inputs(cuda, T, S, D, 31 * D + e + causal)
    scale = torch.ones(T, S, D, device=cuda)
    exact = torch.ones(T, S, D, dtype=torch.bool, device=cuda)
    for h in range(S):
        mode = h % 4
        if mode == 1:
            scale[:, h] = 2.0 ** e
        elif mode == 2:
            scale[:, h, (h + 2) % D] = 2.0 ** e
        elif mode == 3 and causal:
            scale[:8, h] = 2.0 ** e
            exact[8:, h] = False
        elif mode == 3:
            scale[:, h, D // 2:] = 2.0 ** e
    vs = (v.float() * scale).to(torch.bfloat16)
    assert torch.equal(vs.float(), v.float() * scale)
    o, m, l = flash_attention_stats(q, k, v, causal)
    o6a = flash_attention(q, k, v, causal)
    got = flash_attention_stats(q, k, vs, causal)
    got6a = flash_attention(q, k, vs, causal)
    torch.cuda.synchronize()
    assert torch.equal(got[1], m) and torch.equal(got[2], l)
    assert torch.equal(got[0], got6a)
    # o[t, h, d] scales as v[:, h, d] where that column is scaled whole,
    # and rows 0-7 of a causal head as keys 0-7
    for name, want, have in (("K6b", o, got[0]), ("K6a", o6a, got6a)):
        assert bool(torch.isfinite(have.float()).all()), name
        scaled = (want.float() * scale).to(torch.bfloat16)
        assert torch.equal(have[exact], scaled[exact]), name
    # rows that mix scaled and unscaled keys: against the plain version
    po = flash_attention_stats_plain(q, k, vs, causal, BLOCK_K)[0]
    mag = flash_attention_plain(q, k, vs.abs(), causal, BLOCK_K)
    assert parity.attention_close(_host(got[0]), _host(po), _host(mag))


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
    workspace, 32 K blocks a head; after them a chain counter a tile and
    the ticket."""
    assert fused_bwd_route(2048, 32, 128)
    assert ca._dqkv_workspace_floats(2048, 32, 128) == (
        2048 * 128 * 32 + 32 * 32 + 1)
    assert ca._dqkv_workspace_floats(65, 3, 160) == (
        128 * 128 * 3 * 2 + 2 * 3 * 2 + 1)
    _fused_backward_matches(cuda, 2048, 32, 128, causal, 3)


def _fused_backward_inputs(cuda, T, S, D, causal, seed):
    q, k, v = _qkv(cuda, T, S, D, seed)
    do = _qkv(cuda, T, S, D, seed + 1)[0]
    o, m, l = flash_attention_stats(q, k, v, causal)
    return q, k, v, do, m, l, attention_dvec(o, do)


@pytest.mark.parametrize("T", [1024, 2048])
@pytest.mark.parametrize("S", [1, 3, 32])
@pytest.mark.parametrize("D", [32, 128, 160])
@pytest.mark.parametrize("causal", [True, False])
def test_fused_backward_kernel_chains_dq_as_k7_does(cuda, T, S, D, causal):
    """K9 where its dq chains are longest (16 and 32 K blocks) and most
    contended (up to 32 heads x 2 column chunks of tiles racing for the
    same q blocks): dq bit for bit K7's and dk, dv K8's, and 20 calls
    back to back bit for bit one another."""
    args = _fused_backward_inputs(cuda, T, S, D, causal, T + 7 * S + D)
    got = flash_bwd_dqkv(*args, causal)
    sweeps = (flash_bwd_dq(*args, causal), *flash_bwd_dkv(*args, causal))
    runs = [flash_bwd_dqkv(*args, causal) for _ in range(20)]
    torch.cuda.synchronize()
    for name, g, sw in zip(("dq", "dk", "dv"), got, sweeps):
        assert torch.equal(g, sw), name
    for i, run in enumerate(runs):
        assert all(torch.equal(a, b) for a, b in zip(run, got)), i


@pytest.mark.parametrize("T,S,D", [(2048, 32, 128), (1024, 3, 160)])
@pytest.mark.parametrize("causal", [True, False])
def test_fused_backward_kernel_replays_in_a_cuda_graph(cuda, T, S, D,
                                                       causal):
    """K9 captured in a CUDA graph (its workspace, the memset of its
    chains' counters and ticket, the launch) and replayed 10 times, the
    outputs cleared before each replay: every replay bit for bit the
    eager call, which counters or a ticket left unreset would break."""
    args = _fused_backward_inputs(cuda, T, S, D, causal, T + S + D)
    want = flash_bwd_dqkv(*args, causal)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        flash_bwd_dqkv(*args, causal)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_bwd_dqkv(*args, causal)
    for i in range(10):
        for x in out:
            x.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want)), i


def _two_sweeps(args, causal):
    return (flash_bwd_dq(*args, causal), *flash_bwd_dkv(*args, causal))


@pytest.mark.parametrize("T", [1024, 2048])
@pytest.mark.parametrize("D", [20, 40, 64, 128, 160, 256, 288])
@pytest.mark.parametrize("causal", [True, False])
def test_two_sweep_backward_equals_fused_kernel(cuda, T, D, causal):
    """K7 and K8 at 128 heads, where the reference's route takes the two
    sweeps, against K9 on the same inputs: dq, dk and dv equal value for
    value, over 16 and 32 blocks, at widths padded by the wrapper (20),
    in the kernels (40), in one warpgroup's tile (64, 128), split
    between two warpgroups (160, 256) and in the 128-column chunks of the
    widest heads (288: two whole chunks and a part)."""
    assert not fused_bwd_route(T, 128, D)
    args = _fused_backward_inputs(cuda, T, 128, D, causal, T + 3 * D)
    build.reset_launch_counts()
    got = _two_sweeps(args, causal)
    counts = build.launch_counts()
    assert (counts["flash_bwd_dq"], counts["flash_bwd_dkv"],
            counts["flash_bwd_dqkv"]) == (1, 1, 0)
    want = flash_bwd_dqkv(*args, causal)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == args[0].shape
        assert torch.equal(g, w), name


@pytest.mark.parametrize("T,D", [(130, 32), (1024, 128), (1024, 160)])
@pytest.mark.parametrize("causal", [True, False])
def test_two_sweep_backward_equals_fused_kernel_on_wide_scores(cuda, T, D,
                                                               causal):
    """q and k scaled by 12, so that a row's scores span hundreds and
    exp(s - m) reaches the subnormal floats: K7's and K8's quotients p =
    exp(s - m) / max(l, 1) then leave the range of their fast division
    and take its wide path, and must still equal K9's `/` value for
    value."""
    q, k, v = _qkv(cuda, T, 40, D, 5 * T + D)
    q, k = (x * 12 for x in (q, k))
    do = _qkv(cuda, T, 40, D, T + D)[0]
    o, m, l = flash_attention_stats(q, k, v, causal)
    args = (q, k, v, do, m, l, attention_dvec(o, do))
    got = _two_sweeps(args, causal)
    want = flash_bwd_dqkv(*args, causal)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(g.float()).all()), name
        assert torch.equal(g, w), name


#: the edges of the range where K7's and K8's quotients skip `/`'s check
_LN2 = float(np.log(2.0))
#: row offsets of m: exp(s - m) just inside, just outside and across
#: 2^-64 and 2^30 (|s| < 0.01 here), or the row's own m
_EDGE_M = (64 * _LN2 - 0.02, 64 * _LN2 + 0.02, 64 * _LN2,
           -30 * _LN2 + 0.02, -30 * _LN2 - 0.02, -30 * _LN2, None)
#: l: at, inside and past 2^24, below 1 (max(l, 1) = 1), or the row's own
_EDGE_L = (2.0 ** 24, 2.0 ** 24 - 1, 2.0 ** 24 + 2, 1.0, 0.5, 3.7, None)


@pytest.mark.parametrize("D", [32, 128, 160])
@pytest.mark.parametrize("causal", [True, False])
def test_two_sweep_backward_equals_fused_kernel_at_the_division_edges(
        cuda, D, causal):
    """Scores within 0.01 of 0 (q scaled by 2^-10) and stats set a
    64-row block at a time, so that whole warps see exp(s - m) just
    inside and just outside 2^-64 and 2^30 and max(l, 1) at, inside and
    past 2^24: K7's and K8's quotients take their fast division up to the
    edges of its range and `/` past them, and must equal K9's `/` value
    for value."""
    T, S = 1024, 40
    q, k, v, do, m, l, dvec = _fused_backward_inputs(cuda, T, S, D, causal,
                                                     9 * T + D)
    q = q * 2.0 ** -10
    rng = np.random.default_rng(D + causal)
    m, l = m.clone(), l.clone()
    for h in range(S):
        for r0 in range(0, T, 64):
            mi, li = rng.integers(len(_EDGE_M)), rng.integers(len(_EDGE_L))
            if _EDGE_M[mi] is not None:
                m[h, r0:r0 + 64] = _EDGE_M[mi]
            if _EDGE_L[li] is not None:
                l[h, r0:r0 + 64] = _EDGE_L[li]
    args = (q, k, v, do, m, l, dvec)
    got = _two_sweeps(args, causal)
    want = flash_bwd_dqkv(*args, causal)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(g.float()).all()), name
        assert torch.equal(g, w), name


_DIVISION_SRC = r"""
#include "flash_common.cuh"
using namespace agac_flash;

#define EACH(i, n) \
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < (n); \
       i += gridDim.x * blockDim.x)

// b: the floats with bits [lo, lo + n)
__global__ void reciprocals(unsigned lo, unsigned n,
                            unsigned long long* bad) {
  unsigned long long miss = 0;
  EACH(i, n) {
    const float b = __uint_as_float(lo + i);
    miss += __float_as_uint(div_reciprocal(b)) !=
            __float_as_uint(__frcp_rn(b));
  }
  if (miss) atomicAdd(bad, miss);
}

__global__ void quotients(const float* as, int na, unsigned lo, unsigned n,
                          unsigned long long* bad) {
  unsigned long long miss = 0;
  EACH(i, n) {
    const float b = __uint_as_float(lo + i);
    const float r = div_reciprocal(b);
    for (int j = 0; j < na; ++j)
      miss += __float_as_uint(div_by(as[j], b, r)) !=
              __float_as_uint(as[j] / b);
  }
  if (miss) atomicAdd(bad, miss);
}

// every 32-bit pattern, in 2^31 halves
__global__ void ranges(unsigned hi, unsigned long long* bad) {
  unsigned long long miss = 0;
  EACH(i, 0x80000000u) {
    const unsigned x = hi | i;
    const float a = __uint_as_float(x);
    miss += div_in_range(a) !=
            (x == 0u || (a >= 0x1p-64f && a <= 0x1p30f));
  }
  if (miss) atomicAdd(bad, miss);
}

extern "C" int check_reciprocals(unsigned lo, unsigned n,
                                 unsigned long long* bad) {
  reciprocals<<<4096, 256>>>(lo, n, bad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int check_quotients(const float* as, int na, unsigned lo,
                               unsigned n, unsigned long long* bad) {
  quotients<<<4096, 256>>>(as, na, lo, n, bad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int check_ranges(unsigned hi, unsigned long long* bad) {
  ranges<<<4096, 256>>>(hi, bad);
  return static_cast<int>(cudaGetLastError());
}
"""


def _f32_bits(x: float) -> int:
    return int(np.array(x, np.float32).view(np.uint32))


def test_fast_division_is_the_ieee_division(cuda, tmp_path):
    """K7's and K8's division helpers (csrc/flash_common.cuh) on the
    card: div_reciprocal(b) is __frcp_rn(b), the correctly rounded
    reciprocal, for every float b in [1, 2^24], which with Markstein's
    theorem makes div_by(a, b) = RN(a / b) over the whole fast range;
    div_by equals `/` for every b in [1, 2) at 64 quotients, and for
    every b in [1, 2^24] at the range's edges; and div_in_range accepts
    exactly 0 and [2^-64, 2^30] of all 2^32 bit patterns."""
    src = tmp_path / "division.cu"
    src.write_text(_DIVISION_SRC)
    lib = tmp_path / "division.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                    f"-I{build.CSRC}", str(src), "-o", str(lib)],
                   check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    bad = torch.zeros(1, dtype=torch.int64, device=cuda)
    ptr = ctypes.c_void_p(bad.data_ptr())

    def misses(rc):
        assert rc == 0
        torch.cuda.synchronize()
        n = int(bad.item())
        bad.zero_()
        return n

    one, top = _f32_bits(1.0), _f32_bits(2.0 ** 24)
    span = ctypes.c_uint(top - one + 1)            # 201,326,593 floats
    assert misses(so.check_reciprocals(ctypes.c_uint(one), span, ptr)) == 0

    rng = np.random.default_rng(0)
    edges = np.array([0.0, 2.0 ** -64, 2.0 ** 30, 1.0],
                     np.float32)
    edges = np.concatenate([edges, np.nextafter(edges[1:2], 1),
                            np.nextafter(edges[2:], 0)]).astype(np.float32)
    spread = (rng.uniform(1, 2, 64)
              * 2.0 ** rng.integers(-64, 30, 64)).astype(np.float32)
    for a_values, n in ((edges, span), (spread, ctypes.c_uint(1 << 23))):
        a = torch.from_numpy(a_values).to(cuda)
        assert misses(so.check_quotients(
            ctypes.c_void_p(a.data_ptr()), ctypes.c_int(len(a_values)),
            ctypes.c_uint(one), n, ptr)) == 0, a_values
    for hi in (0, 0x80000000):
        assert misses(so.check_ranges(ctypes.c_uint(hi), ptr)) == 0


_WGMMA_PROBE_SRC = r"""
#include "flash_common.cuh"
using namespace agac_flash;

// element (r, c) of a 64-row box of 128-byte rows, 128-byte swizzle
__device__ void put(uint8_t* box, int r, int c, __nv_bfloat16 x) {
  *reinterpret_cast<__nv_bfloat16*>(
      box + r * 128 + (((c / 8) ^ (r % 8)) * 16) + (c % 8) * 2) = x;
}

// One problem a CTA of one warpgroup: A [64 x 64] (rows x contraction),
// B [64 x 64] stored [n][k] (the s product's k), V [64 x 128] stored
// [k][n] (the p.v product's v), C [64 x 128] f32.  From the same C,
// `steps` k16 steps of A.B^T by wgmma m64n64k16 (A, B from shared memory)
// and by the 4 warps x 8 mma.sync m16n8k16 that cover the tile, and of
// A.V by wgmma with A in registers and V transposed from shared memory
// (two m64n64k16 a step, one a 64-column box) and by 4 x 16 mma.sync.
__global__ void __launch_bounds__(128) probe(
    const __nv_bfloat16* a_all, const __nv_bfloat16* b_all,
    const __nv_bfloat16* v_all, const float* c_all, int steps,
    float* ss_w, float* ss_m, float* rs_w, float* rs_m) {
  __shared__ __align__(1024) uint8_t as[8192];
  __shared__ __align__(1024) uint8_t bs[8192];
  __shared__ __align__(1024) uint8_t vs[16384];
  const int p = blockIdx.x;
  const __nv_bfloat16* a = a_all + p * 64 * 64;
  const __nv_bfloat16* b = b_all + p * 64 * 64;
  const __nv_bfloat16* v = v_all + p * 64 * 128;
  const float* c = c_all + p * 64 * 128;
  for (int i = threadIdx.x; i < 64 * 64; i += 128) {
    put(as, i / 64, i % 64, a[i]);
    put(bs, i / 64, i % 64, b[i]);
  }
  for (int i = threadIdx.x; i < 64 * 128; i += 128)
    put(vs + (i % 128 / 64) * 8192, i / 128, i % 64, v[i]);
  fence_proxy_async();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * warp + lane / 4, tq = lane % 4;

  float dw[8][4], dm[8][4], ew[16][4], em[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = c[(r0 + 8 * (i >> 1)) * 128 + 8 * j + 2 * tq + (i & 1)];
      ew[j][i] = em[j][i] = x;
      if (j < 8) dw[j][i] = dm[j][i] = x;
    }
  uint32_t af[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const __nv_bfloat16* p0 = a + r0 * 64 + 16 * kk + 2 * tq;
    af[kk][0] = load_pair(p0);
    af[kk][1] = load_pair(p0 + 8 * 64);
    af[kk][2] = load_pair(p0 + 8);
    af[kk][3] = load_pair(p0 + 8 * 64 + 8);
  }

  using L = SwizzledTile<64>;
  fence_acc(dw);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (kk < steps)
      wgmma_ss64<0>(dw, gmma_desc<128>(as) + (L::k_step(kk) >> 4),
                    gmma_desc<128>(bs) + (L::k_step(kk) >> 4));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(dw);
  fence_acc(ew);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (kk < steps)
      wgmma_rs_groups<64, 2, 8192>(
          ew, af[kk], gmma_desc<128>(vs) + ((kk * 16 * 128) >> 4));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(ew);

#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk >= steps) break;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* q = b + (8 * nt + lane / 4) * 64 + 16 * kk + 2 * tq;
      mma_bf16(dm[nt], af[kk], load_pair(q), load_pair(q + 8));
    }
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const __nv_bfloat16* q =
          v + (16 * kk + 2 * tq) * 128 + 8 * nt + lane / 4;
      mma_bf16(em[nt], af[kk], pack_raw(q[0], q[128]),
               pack_raw(q[8 * 128], q[9 * 128]));
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int at = (r0 + 8 * (i >> 1)) * 128 + 8 * j + 2 * tq + (i & 1);
      rs_w[p * 64 * 128 + at] = ew[j][i];
      rs_m[p * 64 * 128 + at] = em[j][i];
      if (j < 8) {
        const int at64 = (r0 + 8 * (i >> 1)) * 64 + 8 * j + 2 * tq + (i & 1);
        ss_w[p * 64 * 64 + at64] = dw[j][i];
        ss_m[p * 64 * 64 + at64] = dm[j][i];
      }
    }
}

extern "C" int run_probe(const void* a, const void* b, const void* v,
                         const void* c, int problems, int steps, void* ss_w,
                         void* ss_m, void* rs_w, void* rs_m) {
  probe<<<problems, 128>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(c),
      steps, static_cast<float*>(ss_w), static_cast<float*>(ss_m),
      static_cast<float*>(rs_w), static_cast<float*>(rs_m));
  return static_cast<int>(cudaGetLastError());
}
"""


def _wide(rng, shape, lo, hi):
    """Values of either sign whose exponents span [lo, hi)."""
    return (rng.uniform(1, 2, shape) * 2.0 ** rng.integers(lo, hi, shape)
            * rng.choice([-1.0, 1.0], shape)).astype(np.float32)


def _probe_operands(problems, seed):
    """bf16 A [P, 64, 64], B [P, 64, 64] ([n][k]), V [P, 64, 128] ([k][n])
    and f32 C [P, 64, 128]: exponents over 2^-12..2^12 (products over
    2^-24..2^24, C over 2^-20..2^20), and in every other problem terms
    that cancel: the second half of each k16 step repeats the first with
    the other sign, exactly or to a bf16 ulp, and C is minus a row's
    first product."""
    rng = np.random.default_rng(seed)
    a = _wide(rng, (problems, 64, 64), -12, 12)
    b = _wide(rng, (problems, 64, 64), -12, 12)
    v = _wide(rng, (problems, 64, 128), -12, 12)
    c = _wide(rng, (problems, 64, 128), -20, 20)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    a, b, v = bf(a), bf(b), bf(v)
    for p in range(1, problems, 2):
        nudge = torch.from_numpy(
            rng.choice([1.0, 1.0078125], (64, 32))).to(torch.bfloat16)
        for k0 in range(0, 64, 16):
            a[p, :, k0 + 8:k0 + 16] = a[p, :, k0:k0 + 8]
            b[p, :, k0 + 8:k0 + 16] = -b[p, :, k0:k0 + 8] * nudge[:, k0 // 2:
                                                                 k0 // 2 + 8]
            v[p, k0 + 8:k0 + 16] = -v[p, k0:k0 + 8]
        first = a[p].float() @ b[p].float().t()
        c[p, :, :64] = -first.numpy() * rng.choice([1.0, 0.5], (64, 64))
    return a, b, v, torch.from_numpy(c)


def test_wgmma_sums_as_mma_sync(cuda, tmp_path):
    """The bit contract of the forward's products (csrc/flash_common.cuh's
    wgmma wrappers and descriptors): from the same f32 accumulators, one
    and four k16 steps of a 64 x 64 x 16 product by wgmma m64n64k16 with
    both operands in shared memory (128-byte swizzle, K-major), and of a
    64 x 128 x 16 product with A in registers and B transposed from two
    swizzled boxes, give every f32 bit that the 4 warps x 8 (16) mma.sync
    m16n8k16 steps covering the same tile give, over bf16 operands whose
    products span 2^-24..2^24 and terms that cancel."""
    src = tmp_path / "probe.cu"
    src.write_text(_WGMMA_PROBE_SRC)
    lib = tmp_path / "probe.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                    f"-I{build.CSRC}", str(src), "-o", str(lib)],
                   check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    problems = 256
    a, b, v, c = (x.to(cuda) for x in _probe_operands(problems, 0))
    for steps in (1, 4):
        out = [torch.full((problems, 64, n), float("nan"), device=cuda)
               for n in (64, 64, 128, 128)]
        ptrs = [ctypes.c_void_p(x.data_ptr()) for x in (a, b, v, c, *out)]
        assert so.run_probe(*ptrs[:4], ctypes.c_int(problems),
                            ctypes.c_int(steps), *ptrs[4:]) == 0
        torch.cuda.synchronize()
        for name, w, m in (("ss", out[0], out[1]), ("rs", out[2], out[3])):
            assert bool(torch.isfinite(m).all()), (name, steps)
            diff = w.view(torch.int32) != m.view(torch.int32)
            if bool(diff.any()):
                p, r, col = (int(i) for i in diff.nonzero()[0])
                worst = float((w - m).abs().max())
                raise AssertionError(
                    f"{name}, {steps} k16 steps: {int(diff.sum())} of "
                    f"{diff.numel()} sums differ; first at problem {p} "
                    f"({'cancelling' if p % 2 else 'random'}), row {r}, "
                    f"column {col}: wgmma {float(w[p, r, col])!r}, "
                    f"mma.sync {float(m[p, r, col])!r}; largest "
                    f"difference {worst!r}")


_HEAD_PROBE_SRC = r"""
#include "flash_common.cuh"
using namespace agac_flash;

// One problem a CTA of one warpgroup, in the two forms of K11's bit
// contract (score_head.cu), from x [64 x 128] (rows x D), w [128 x 128]
// (w1, D x H), dh [64 x 128] (rows x H) and f32 C [64 x 128]:
// - h: C[:, :64] + x[:, :16 s] . w[:16 s, :64] by wgmma m64n64k16 with x
//   K-major in SwizzledTile<kDPad> and w's first box of 64 H columns
//   MN-major (128-byte swizzle), and by the 4 warps x 8 mma.sync m16n8k16
//   (a_frag, mma_kn) that cover the tile, s = h_steps k16 steps;
// - dx: C[:, :kDPad] + dh[:, :16 s] . w[:kDPad, :16 s]^T by wgmma with dh
//   in registers and w K-major (rows of d, two boxes of 64 H columns) in
//   groups of at most 64 columns, and by 4 x kDPad / 8 mma.sync (mma_nk),
//   s = dx_steps k16 steps (past 4 the second box).
template <int kDPad>
__global__ void __launch_bounds__(128) head_probe(
    const __nv_bfloat16* x_all, const __nv_bfloat16* w_all,
    const __nv_bfloat16* dh_all, const float* c_all, int h_steps,
    int dx_steps, float* h_w, float* h_m, float* dx_w, float* dx_m) {
  using L = SwizzledTile<kDPad>;
  constexpr int kBox = kDPad * 128;              // a box of 64 H columns
  constexpr int kN = kDPad < 64 ? kDPad : 64;    // dx's column groups
  __shared__ __align__(1024) uint8_t xs[L::kBytes];
  __shared__ __align__(1024) uint8_t ws[2 * kBox];
  const int p = blockIdx.x;
  const __nv_bfloat16* x = x_all + p * 64 * 128;
  const __nv_bfloat16* w = w_all + p * 128 * 128;
  const __nv_bfloat16* dh = dh_all + p * 64 * 128;
  const float* c = c_all + p * 64 * 128;
  for (int i = threadIdx.x; i < 64 * (kDPad / 8); i += 128) {
    const int r = i / (kDPad / 8), j = i % (kDPad / 8);
    *reinterpret_cast<uint4*>(xs + L::chunk(r, j)) =
        *reinterpret_cast<const uint4*>(x + r * 128 + 8 * j);
  }
  for (int i = threadIdx.x; i < kDPad * 16; i += 128) {
    const int d = i / 16, j = i % 16;
    *reinterpret_cast<uint4*>(ws + (j / 8) * kBox + d * 128 +
                              (((j % 8) ^ (d % 8)) << 4)) =
        *reinterpret_cast<const uint4*>(w + d * 128 + 8 * j);
  }
  fence_proxy_async();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * warp + lane / 4, tq = lane % 4;

  float hw[8][4], hm[8][4], dw[kDPad / 8][4], dm[kDPad / 8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      hw[j][i] = hm[j][i] =
          c[(r0 + 8 * (i >> 1)) * 128 + 8 * j + 2 * tq + (i & 1)];
#pragma unroll
  for (int j = 0; j < kDPad / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dw[j][i] = dm[j][i] =
          c[(r0 + 8 * (i >> 1)) * 128 + 8 * j + 2 * tq + (i & 1)];
  uint32_t xf[kDPad / 16][4], af[8][4];
#pragma unroll
  for (int kk = 0; kk < kDPad / 16; ++kk)
    a_frag(xf[kk], x, 128, 16 * warp, kk);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) a_frag(af[kk], dh, 128, 16 * warp, kk);

  fence_acc(hw);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kDPad / 16; ++kk)
    if (kk < h_steps)
      wgmma_ss<64, false, true, 0>(
          hw, gmma_desc<L::kSwz>(xs) + (L::k_step(kk) >> 4),
          gmma_desc<128>(ws) + ((kk * 16 * 128) >> 4));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(hw);
  fence_acc(dw);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    if (kk < dx_steps)
      wgmma_rs_groups<kN, kDPad / kN, 64 * 128, false>(
          dw, af[kk], gmma_desc<128>(ws + (kk / 4) * kBox) +
                          (((kk % 4) * 32) >> 4));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(dw);

#pragma unroll
  for (int kk = 0; kk < kDPad / 16; ++kk) {
    if (kk >= h_steps) break;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma_kn(hm[nt], xf[kk], w, 128, 8 * nt, kk);
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (kk >= dx_steps) break;
#pragma unroll
    for (int nt = 0; nt < kDPad / 8; ++nt)
      mma_nk(dm[nt], af[kk], w, 128, 8 * nt, kk);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int at = p * 64 * 64 + (r0 + 8 * (i >> 1)) * 64 + 8 * j +
                     2 * tq + (i & 1);
      h_w[at] = hw[j][i];
      h_m[at] = hm[j][i];
    }
#pragma unroll
  for (int j = 0; j < kDPad / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int at = (p * 64 + r0 + 8 * (i >> 1)) * kDPad + 8 * j + 2 * tq +
                     (i & 1);
      dx_w[at] = dw[j][i];
      dx_m[at] = dm[j][i];
    }
}

extern "C" int run_head_probe(int dpad, const void* x, const void* w,
                              const void* dh, const void* c, int problems,
                              int h_steps, int dx_steps, void* h_w, void* h_m,
                              void* dx_w, void* dx_m) {
  using bf = __nv_bfloat16;
  auto args = [&](auto kernel) {
    kernel<<<problems, 128>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(w),
        static_cast<const bf*>(dh), static_cast<const float*>(c), h_steps,
        dx_steps, static_cast<float*>(h_w), static_cast<float*>(h_m),
        static_cast<float*>(dx_w), static_cast<float*>(dx_m));
  };
  if (dpad == 16) args(head_probe<16>);
  else if (dpad == 32) args(head_probe<32>);
  else if (dpad == 64) args(head_probe<64>);
  else args(head_probe<128>);
  return static_cast<int>(cudaGetLastError());
}
"""


def _head_probe_operands(problems, seed):
    """bf16 x [P, 64, 128], w [P, 128, 128] (d x j), dh [P, 64, 128] and
    f32 C [P, 64, 128], exponents as ``_probe_operands``'; in problems
    1, 4, 7, ... h's terms cancel (the second half of each k16 step over
    d repeats the first with the other sign, to a bf16 ulp, and C is
    minus a row's product), in problems 2, 5, 8, ... dx's (over j)."""
    rng = np.random.default_rng(seed)
    x = _wide(rng, (problems, 64, 128), -12, 12)
    w = _wide(rng, (problems, 128, 128), -12, 12)
    dh = _wide(rng, (problems, 64, 128), -12, 12)
    c = _wide(rng, (problems, 64, 128), -20, 20)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    x, w, dh = bf(x), bf(w), bf(dh)
    for p in range(problems):
        nudge = torch.from_numpy(
            rng.choice([1.0, 1.0078125], (128, 8))).to(torch.bfloat16)
        if p % 3 == 1:
            for k0 in range(0, 128, 16):
                x[p, :, k0 + 8:k0 + 16] = x[p, :, k0:k0 + 8]
                w[p, k0 + 8:k0 + 16] = -w[p, k0:k0 + 8] * nudge.t()
            first = (x[p].float() @ w[p].float())[:, :64]
            c[p, :, :64] = -first.numpy() * rng.choice([1.0, 0.5], (64, 64))
        elif p % 3 == 2:
            for k0 in range(0, 128, 16):
                dh[p, :, k0 + 8:k0 + 16] = dh[p, :, k0:k0 + 8]
                w[p, :, k0 + 8:k0 + 16] = -w[p, :, k0:k0 + 8] * nudge
            first = dh[p].float() @ w[p].float().t()
            c[p] = -first.numpy() * rng.choice([1.0, 0.5], (64, 128))
    return x, w, dh, torch.from_numpy(c)


def test_score_head_wgmma_forms_sum_as_mma_sync(cuda, tmp_path):
    """The bit contract of K11's dx and relu gates (csrc/score_head.cu):
    from the same f32 accumulators, h = x . w1 by wgmma m64n64k16 with x
    K-major (SwizzledTile of 16, 32, 64 and 128 columns, so 32-, 64- and
    128-byte swizzles) and w1 MN-major from a 128-byte-swizzled box, one
    and every k16 step of D; and dx = dh . w1^T by wgmma with dh in
    registers and w1 K-major from the same boxes at N = 16, 32, 64 and
    128 (two groups of 64), one, four and eight k16 steps (the eighth in
    the second box), give every f32 bit that the mma.sync m16n8k16 steps
    covering the same tile give, over bf16 operands whose products span
    2^-24..2^24 and terms that cancel."""
    src = tmp_path / "head_probe.cu"
    src.write_text(_HEAD_PROBE_SRC)
    lib = tmp_path / "head_probe.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                    f"-I{build.CSRC}", str(src), "-o", str(lib)],
                   check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    problems = 192
    x, w, dh, c = (t.to(cuda) for t in _head_probe_operands(problems, 0))
    for dpad in (16, 32, 64, 128):
        for h_steps, dx_steps in ((1, 1), (dpad // 16, 4), (dpad // 16, 8)):
            out = [torch.full((problems, 64, n), float("nan"), device=cuda)
                   for n in (64, 64, dpad, dpad)]
            ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (x, w, dh, c)]
            assert so.run_head_probe(
                ctypes.c_int(dpad), *ptrs, ctypes.c_int(problems),
                ctypes.c_int(h_steps), ctypes.c_int(dx_steps),
                *[ctypes.c_void_p(t.data_ptr()) for t in out]) == 0
            torch.cuda.synchronize()
            for name, steps, got, want in (("h", h_steps, out[0], out[1]),
                                           ("dx", dx_steps, out[2], out[3])):
                assert bool(torch.isfinite(want).all()), (name, dpad, steps)
                diff = got.view(torch.int32) != want.view(torch.int32)
                if bool(diff.any()):
                    p, r, col = (int(i) for i in diff.nonzero()[0])
                    raise AssertionError(
                        f"{name} at D = {dpad}, {steps} k16 steps: "
                        f"{int(diff.sum())} of {diff.numel()} sums differ; "
                        f"first at problem {p}, row {r}, column {col}: "
                        f"wgmma {float(got[p, r, col])!r}, mma.sync "
                        f"{float(want[p, r, col])!r}; largest difference "
                        f"{float((got - want).abs().max())!r}")


_SPLIT_PROBE_SRC = r"""
#include "flash_common.cuh"
using namespace agac_flash;

// element (r, c) of a 64-row box of 128-byte rows, 128-byte swizzle
__device__ void put(uint8_t* box, int r, int c, __nv_bfloat16 x) {
  *reinterpret_cast<__nv_bfloat16*>(
      box + r * 128 + (((c / 8) ^ (r % 8)) * 16) + (c % 8) * 2) = x;
}

// term t (0 hi, 1 mid, 2 lo) of q[r][c] and q[r][c + 1] times scale, as
// the A fragment's pair
__device__ uint32_t term_pair(const float* q, int r, int c, float scale,
                              int t) {
  const SplitTerms a = split_q(q[r * 64 + c], scale);
  const SplitTerms b = split_q(q[r * 64 + c + 1], scale);
  return t == 0 ? pack_raw(a.hi, b.hi)
       : t == 1 ? pack_raw(a.mid, b.mid) : pack_raw(a.lo, b.lo);
}

// One problem a CTA of one warpgroup: f32 q [64 x 64] (rows x the
// contraction), bf16 k [64 x 64] stored [n][k], f32 c [64 x 64].  q' =
// q * scale is split into hi, mid and lo by store_q_split (as K6b-ring
// writes them); from the same c, `steps` k16 steps, each summing lo, mid
// and hi in that order, by wgmma m64n64k16 with both operands in shared
// memory and by the 4 warps x 8 mma.sync m16n8k16 covering the tile, the
// A fragments split in registers by split_q.
__global__ void __launch_bounds__(128) probe(
    const float* q_all, const __nv_bfloat16* k_all, const float* c_all,
    float scale, int steps, float* out_w, float* out_m) {
  using L = SwizzledTile<64>;
  __shared__ __align__(1024) uint8_t qs[3 * L::kBytes];
  __shared__ __align__(1024) uint8_t ks[L::kBytes];
  const int p = blockIdx.x;
  const float* q = q_all + p * 64 * 64;
  const __nv_bfloat16* k = k_all + p * 64 * 64;
  const float* c = c_all + p * 64 * 64;
  for (int i = threadIdx.x; i < 64 * 8; i += 128) {
    float x[8];
    for (int e = 0; e < 8; ++e) x[e] = q[i * 8 + e];
    store_q_split<64>(qs, i / 8, i % 8, x, scale);
  }
  for (int i = threadIdx.x; i < 64 * 64; i += 128)
    put(ks, i / 64, i % 64, k[i]);
  fence_proxy_async();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * warp + lane / 4, tq = lane % 4;

  float dw[8][4], dm[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dw[j][i] = dm[j][i] =
          c[(r0 + 8 * (i >> 1)) * 64 + 8 * j + 2 * tq + (i & 1)];

  const uint64_t k_desc = gmma_desc<128>(ks);
  fence_acc(dw);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (kk < steps) {
      const uint64_t step = L::k_step(kk) >> 4;
      wgmma_ss64<0>(dw, gmma_desc<128>(qs + 2 * L::kBytes) + step,
                    k_desc + step);
      wgmma_ss64<0>(dw, gmma_desc<128>(qs + L::kBytes) + step, k_desc + step);
      wgmma_ss64<0>(dw, gmma_desc<128>(qs) + step, k_desc + step);
    }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(dw);

  for (int kk = 0; kk < steps; ++kk)
    for (int t = 2; t >= 0; --t) {
      const int c0 = 16 * kk + 2 * tq;
      const uint32_t af[4] = {term_pair(q, r0, c0, scale, t),
                              term_pair(q, r0 + 8, c0, scale, t),
                              term_pair(q, r0, c0 + 8, scale, t),
                              term_pair(q, r0 + 8, c0 + 8, scale, t)};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* b = k + (8 * nt + lane / 4) * 64 + c0;
        mma_bf16(dm[nt], af, load_pair(b), load_pair(b + 8));
      }
    }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int at = (r0 + 8 * (i >> 1)) * 64 + 8 * j + 2 * tq + (i & 1);
      out_w[p * 64 * 64 + at] = dw[j][i];
      out_m[p * 64 * 64 + at] = dm[j][i];
    }
}

extern "C" int run_probe(const void* q, const void* k, const void* c,
                         int problems, float scale, int steps, void* out_w,
                         void* out_m) {
  probe<<<problems, 128>>>(
      static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const float*>(c), scale, steps,
      static_cast<float*>(out_w), static_cast<float*>(out_m));
  return static_cast<int>(cudaGetLastError());
}
"""

#: what each problem of the split probe is, by its index mod 4
_SPLIT_KINDS = ("random", "cancelling", "tiny q' (subnormal lo . k)",
                "rows of mixed scale")


def _split_probe_operands(problems, seed):
    """f32 q [P, 64, 64], bf16 k [P, 64, 64] ([n][k]) and f32 c [P, 64,
    64], in four kinds by problem index mod 4: random (q over 2^-12..2^12
    with every mantissa bit, k over 2^-12..2^12, c over 2^-20..2^20);
    cancelling (the second half of each k16 step repeats the first with k
    of the other sign, exactly or to a bf16 ulp, and c is minus a row's
    first step at scale 1/8, whole or half); tiny q (2^-135..2^-95, so hi itself may
    be subnormal and lo . k is subnormal or zero; c 0 or 2^-140..2^-110);
    and rows of mixed scale (each row of q times its own 2^-120..2^30, c
    with it), where lo . k lies far below hi . k of another row's
    scale."""
    rng = np.random.default_rng(seed)
    q = _wide(rng, (problems, 64, 64), -12, 12)
    k = _wide(rng, (problems, 64, 64), -12, 12)
    c = _wide(rng, (problems, 64, 64), -20, 20)
    for p in range(2, problems, 4):
        q[p] = _wide(rng, (64, 64), -135, -95)
        c[p] = _wide(rng, (64, 64), -140, -110) * rng.choice([0.0, 1.0])
    for p in range(3, problems, 4):
        rows = 2.0 ** rng.integers(-120, 30, (64, 1))
        q[p] = (q[p] * rows).astype(np.float32)
        c[p] = (c[p] * rows).astype(np.float32)
    k = torch.from_numpy(k).to(torch.bfloat16)
    for p in range(1, problems, 4):
        nudge = torch.from_numpy(
            rng.choice([1.0, 1.0078125], (64, 32))).to(torch.bfloat16)
        for k0 in range(0, 64, 16):
            q[p, :, k0 + 8:k0 + 16] = q[p, :, k0:k0 + 8]
            k[p, :, k0 + 8:k0 + 16] = -k[p, :, k0:k0 + 8] * nudge[
                :, k0 // 2:k0 // 2 + 8]
        first = 0.125 * (q[p, :, :16].astype(np.float64)
                         @ k[p, :, :16].double().numpy().T)
        c[p] = (-first * rng.choice([1.0, 0.5], (64, 64))).astype(np.float32)
    return torch.from_numpy(q), k, torch.from_numpy(c)


def test_wgmma_sums_split_terms_as_mma_sync(cuda, tmp_path):
    """The bit contract of K6b-ring's score product: q' = q * scale split
    into hi, mid and lo bf16 terms as the kernel splits them
    (csrc/flash_common.cuh's split_q and store_q_split), one and four
    k16 steps each summing lo, mid and hi into one f32 accumulator, by
    wgmma m64n64k16 from shared memory, give every f32 bit that mma.sync
    m16n8k16 gives in the same order, over 256 problems: random,
    cancelling, q' so small that lo . k is subnormal, and rows of mixed
    scale (_split_probe_operands)."""
    src = tmp_path / "split_probe.cu"
    src.write_text(_SPLIT_PROBE_SRC)
    lib = tmp_path / "split_probe.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                    f"-I{build.CSRC}", str(src), "-o", str(lib)],
                   check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    problems = 256
    q, k, c = (x.to(cuda) for x in _split_probe_operands(problems, 0))
    for scale in (40 ** -0.5, 0.125):
        for steps in (1, 4):
            w, m = (torch.full((problems, 64, 64), float("nan"), device=cuda)
                    for _ in range(2))
            ptrs = [ctypes.c_void_p(x.data_ptr()) for x in (q, k, c)]
            assert so.run_probe(*ptrs, ctypes.c_int(problems),
                                ctypes.c_float(scale), ctypes.c_int(steps),
                                ctypes.c_void_p(w.data_ptr()),
                                ctypes.c_void_p(m.data_ptr())) == 0
            torch.cuda.synchronize()
            assert bool(torch.isfinite(m).all()), (scale, steps)
            diff = w.view(torch.int32) != m.view(torch.int32)
            if bool(diff.any()):
                p, r, col = (int(i) for i in diff.nonzero()[0])
                kinds = sorted({_SPLIT_KINDS[int(i) % 4]
                                for i in diff.nonzero()[:, 0]})
                raise AssertionError(
                    f"scale {scale}, {steps} k16 steps: {int(diff.sum())} "
                    f"of {diff.numel()} sums differ, in problems of kinds "
                    f"{kinds}; first at problem {p}, row {r}, column {col}: "
                    f"wgmma {float(w[p, r, col])!r}, mma.sync "
                    f"{float(m[p, r, col])!r}")


@pytest.mark.parametrize("T,S,D", [(2048, 128, 128), (1024, 64, 160),
                                   (64, 8192, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_two_sweep_backward_is_reproducible_back_to_back(cuda, T, S, D,
                                                        causal):
    """20 calls of K7 and K8 back to back (the next call's copies racing
    the last one's stores), each bit for bit the first."""
    args = _fused_backward_inputs(cuda, T, S, D, causal, T + S + D)
    first = _two_sweeps(args, causal)
    runs = [_two_sweeps(args, causal) for _ in range(20)]
    torch.cuda.synchronize()
    for i, run in enumerate(runs):
        assert all(torch.equal(a, b) for a, b in zip(run, first)), i


@pytest.mark.parametrize("T,S,D", [(2048, 128, 128), (1024, 64, 160),
                                   (130, 40, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_two_sweep_backward_replays_in_a_cuda_graph(cuda, T, S, D, causal):
    """K7 and K8 captured in a CUDA graph and replayed 10 times, the
    outputs cleared before each replay: every replay bit for bit the
    eager call."""
    args = _fused_backward_inputs(cuda, T, S, D, causal, 2 * T + D)
    want = _two_sweeps(args, causal)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        _two_sweeps(args, causal)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _two_sweeps(args, causal)
    for i in range(10):
        for x in out:
            x.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want)), i


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
    """Two K10 runs agree bit for bit, and so do two K11 runs (no atomics;
    the per-CTA partials sum in a fixed order), and autograd through
    ``score_head`` runs K10 once forward and K11 once backward, giving
    K11's gradients."""
    x, w1, b1, w2, b2, ds = _head_inputs(cuda, 64, 300, 32, 128, 4)
    scores = [score_head_forward(x, w1, b1, w2, b2).view(torch.int32)
              for _ in range(2)]
    assert torch.equal(*scores)
    runs = [score_head_bwd(x, w1, b1, w2, b2, ds) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    build.reset_launch_counts()
    out = score_head(*leaves)
    got = torch.autograd.grad(out, leaves, ds)
    counts = build.launch_counts()
    assert (counts["score_head_fwd"], counts["score_head_bwd"]) == (1, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, runs[0]))


#: the route's predicate in csrc/score_head.cu, forced off in a copy
_HEAD_ROUTE = "  return D <= kMaxDPad && H <= kTcMaxH;"


@pytest.fixture(scope="module")
def cuda_core_head(tmp_path_factory):
    """``csrc/score_head.cu`` built alone with its tensor-core route
    forced off: every width on the CUDA-core kernels, the parents of K10
    and K11."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    src_text = (build.CSRC / "score_head.cu").read_text()
    assert src_text.count(_HEAD_ROUTE) == 1
    tmp = tmp_path_factory.mktemp("cuda_core_head")
    src = tmp / "score_head.cu"
    src.write_text(src_text.replace(_HEAD_ROUTE, "  return false;"))
    lib = tmp / "score_head.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                    f"-I{build.CSRC}", str(src), "-o", str(lib)],
                   check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    so.agac_score_head_fwd.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    so.agac_score_head_bwd_ctas.argtypes = [ctypes.c_int] * 3
    so.agac_score_head_bwd.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    so.agac_score_head_tc_route.argtypes = [ctypes.c_int] * 2
    return so


def _cuda_core_dx(so, x, w1, b1, w2, b2, ds):
    """dx of the CUDA-core build on the inputs ``score_head_bwd`` takes."""
    dev, x2, w1p, b1c, w2c, _, N, D, H = cuda_head._operands(
        "cuda_core_dx", x, w1, b1, w2, b2)
    Dp = x2.shape[1]
    assert so.agac_score_head_tc_route(Dp, H) == 0
    ctas = so.agac_score_head_bwd_ctas(N, Dp, H)
    assert ctas > 0
    n = Dp * H + 2 * H + 1
    dx = torch.empty_like(x2)
    partials = torch.empty((ctas, n), dtype=torch.float32, device=dev)
    sums = torch.zeros(n, dtype=torch.float32, device=dev)
    dsf = ds.float().contiguous()
    args = [ctypes.c_void_p(t.data_ptr()) for t in (
        x2, dsf, w1p, b1c, w2c, dx, partials, sums)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert so.agac_score_head_bwd(*args, N, Dp, H, ctas,
                                  ctypes.c_void_p(stream)) == 0
    return dx[:, :D].reshape(x.shape)


@pytest.mark.parametrize("T,S,D,H", [
    *((19, 37, D, H) for D in (8, 20, 96, 128, 160)
      for H in (16, 128, 200, 256, 512)),
    (64, 1000, 32, 128), (256, 128, 128, 256)])
def test_score_head_backward_tensor_cores_keep_the_parents_dx(
        cuda, cuda_core_head, T, S, D, H):
    """K11's dx on its tensor-core route (D <= 128, H <= 256) equals bit
    for bit the CUDA-core kernel's, the parent's K11, built from the same
    source with the route forced off, on the same inputs: the card tests'
    sweep (703 rows), the train command's widths over many row tiles and
    the reference's head shape.  Widths off the route compare the kernel
    with itself.  The train command's shape and the reference's head
    shape take the route."""
    if (D, H) in ((32, 128), (128, 256)):
        assert cuda_head.tensor_core_route(D, H)
    x, w1, b1, w2, b2, ds = _head_inputs(cuda, T, S, D, H, D * H + T)
    got = score_head_bwd(x, w1, b1, w2, b2, ds)[0]
    want = _cuda_core_dx(cuda_core_head, x, w1, b1, w2, b2, ds)
    torch.cuda.synchronize()
    diff = got.view(torch.int16) != want.view(torch.int16)
    assert not bool(diff.any()), (
        f"{int(diff.sum())} of {diff.numel()} dx values differ, first at "
        f"{tuple(int(i) for i in diff.nonzero()[0])}")


def _cuda_core_scores(so, x, w1, b1, w2, b2):
    """K10's scores from the CUDA-core build on the inputs
    ``score_head_forward`` takes."""
    dev, x2, w1p, b1c, w2c, b2c, N, D, H = cuda_head._operands(
        "cuda_core_scores", x, w1, b1, w2, b2)
    Dp = x2.shape[1]
    assert so.agac_score_head_tc_route(Dp, H) == 0
    out = torch.empty(N, dtype=torch.float32, device=dev)
    args = [ctypes.c_void_p(t.data_ptr()) for t in (
        x2, w1p, b1c, w2c, b2c, out)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert so.agac_score_head_fwd(*args, N, Dp, H,
                                  ctypes.c_void_p(stream)) == 0
    return out.reshape(x.shape[:-1])


def _assert_same_scores(got, want):
    diff = got.view(torch.int32) != want.view(torch.int32)
    assert not bool(diff.any()), (
        f"{int(diff.sum())} of {diff.numel()} scores differ, first at "
        f"{tuple(int(i) for i in diff.nonzero()[0])}: "
        f"{float(got[diff][0])!r} against {float(want[diff][0])!r}")


@pytest.mark.parametrize("T,S,D,H", [
    *((19, 37, D, H) for D in (8, 20, 96, 128, 160)
      for H in (16, 128, 200, 256, 512)),
    (64, 1000, 32, 128), (256, 128, 128, 256)])
def test_score_head_forward_tensor_cores_keep_the_parents_scores(
        cuda, cuda_core_head, T, S, D, H):
    """K10's scores on its tensor-core route (D <= 128, H <= 256) equal
    bit for bit the CUDA-core kernel's, the parent's K10, built from the
    same source with the route forced off, on the same inputs: the card
    tests' sweep (703 rows), the train command's widths over many row
    tiles and the reference's head shape.  Widths off the route compare
    the kernel with itself.  The train command's shape and the
    reference's head shape take the route."""
    if (D, H) in ((32, 128), (128, 256)):
        assert cuda_head.tensor_core_route(D, H)
    x, w1, b1, w2, b2, _ = _head_inputs(cuda, T, S, D, H, D * H + T + 1)
    got = score_head_forward(x, w1, b1, w2, b2)
    want = _cuda_core_scores(cuda_core_head, x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    _assert_same_scores(got, want)


@pytest.mark.parametrize("N", [1, 63, 65, 703])
@pytest.mark.parametrize("D,H", [(128, 256), (136, 256), (128, 257)])
def test_score_head_forward_on_each_side_of_the_route(cuda, cuda_core_head,
                                                      D, H, N):
    """K10 at the edges of its tensor-core route, D = 128 (on it) and 136
    (off it) at H = 256, and H = 257 (off it) at D = 128, at one row, a
    tile less one, a tile and one, and 703 rows: each within 2 bf16 ulps
    of what the score sums of its plain version; on the route also bit
    for bit the CUDA-core build's."""
    on_route = cuda_head.tensor_core_route(D, H)
    assert on_route == (D <= 128 and H <= 256)
    x, w1, b1, w2, b2, _ = _head_inputs(cuda, N, 1, D, H, D + H + N)
    build.reset_launch_counts()
    got = score_head_forward(x, w1, b1, w2, b2)
    assert build.launch_counts()["score_head_fwd"] == 1
    torch.cuda.synchronize()
    assert got.shape == (N, 1) and got.dtype == torch.float32
    assert parity.scores_close(
        _host(got), _host(score_head_plain(x, w1, b1, w2, b2)),
        scale=_host(score_head_magnitude(x, w1, b1, w2, b2)))
    if on_route:
        _assert_same_scores(
            got, _cuda_core_scores(cuda_core_head, x, w1, b1, w2, b2))


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


@pytest.mark.parametrize("H,Tq,Tk,D,causal", RING_SHAPES)
def test_ring_stats_kernel_scores_are_exact_f32_products(cuda, H, Tq, Tk, D,
                                                         causal):
    """K6b-ring's s is q'.k^T with q' in full f32: against a one-hot k
    (key j picks column j % D), where each score is one product, q' times
    1, and so exact in any order of the sums, the kernel's m equals its
    plain version's value for value.  A q' short of any of its three bf16
    terms moves m by about 2**-17 of it, which the tolerances of
    test_ring_stats_kernel_matches_plain_version, made for another order
    of the sums, let through."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(H + Tq + Tk + D + 1)
    q = torch.randn(H, Tq, D, device=cuda, generator=g)
    v = torch.randn(H, Tk, D, device=cuda, generator=g).to(torch.bfloat16)
    onehot = torch.nn.functional.one_hot(
        torch.arange(Tk, device=cuda) % D, D).to(torch.bfloat16)
    k = onehot.expand(H, Tk, D).contiguous()
    o, m, l = ca.flash_attention_stats_ring(q, k, v, causal)
    po, pm, pl = ca.flash_attention_stats_ring_plain(q, k, v, causal, BLOCK_K)
    assert torch.equal(m, pm)
    mag = ca.flash_attention_stats_ring_plain(q, k, v.abs(), causal,
                                              BLOCK_K)[0]
    assert parity.attention_close(_host(o), _host(po), _host(mag))
    np.testing.assert_allclose(_host(l), _host(pl), rtol=1e-5, atol=0)


@pytest.mark.parametrize("D", [32, 160, 288])
def test_ring_stats_kernel_with_no_keys(cuda, D):
    """A block pair with Tk = 0 folds no K block: o zero, m -1e30 and l 0,
    the plain version's values, on both kernels (TMA up to 256, chunked
    past it)."""
    q = torch.randn(3, 70, D, device=cuda)
    k = v = torch.zeros(3, 0, D, device=cuda, dtype=torch.bfloat16)
    got = ca.flash_attention_stats_ring(q, k, v, True)
    want = ca.flash_attention_stats_ring_plain(q, k, v, True, BLOCK_K)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


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


def _chip_checks(cuda, ranks, *argv):
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(ranks), "-m",
         "aws_global_accelerator_controller_tpu_torch.kernels.chip_checks",
         *argv, "--device", f"cuda:{cuda.index}"], cwd=root,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("ranks", [2, 3, 4])
def test_stats_ring_on_ranks_of_one_card(cuda, ranks):
    """Kernel K5 on 2 ranks (left and right neighbour the same rank), 3
    and 4: every sum bit for bit the plain ring's and the hop order's,
    2 launches a pass, nothing staged, and the three planted faults
    caught (``chip_checks.py fleet_sharded --ring-only`` exits non-zero
    on a miss)."""
    out = _chip_checks(cuda, ranks, "fleet_sharded", "--ring-only",
                       "--passes", "50")
    assert out["world"] == ranks and out["errors"] == []
    for r in out["ranks"]:
        assert r["launches"] == 50 * 2 and r["staged_bytes"] == 0
        assert r["peer_bytes"] == 50 * (ranks - 1) * 5 * 4
        assert r["equal_to_plain"] and r["equal_to_numpy_hop_order"]
        assert r["faults_caught"] == {"sum_skips_a_slot": True,
                                      "sum_skips_its_sent_wait": True,
                                      "send_skips_its_read_wait": True}
        assert r["passes_beside_faults_right"]


def test_stats_ring_events_order_the_exchange(cuda):
    """``chip_checks.py ring_probe`` on 3 ranks: no round's sum reads a
    slot before the peers' stores land, though each send follows a
    sleep on its stream (the probe exits non-zero on such a round)."""
    out = _chip_checks(cuda, 3, "ring_probe", "--rounds", "500",
                       "--loops", "20")
    assert out["world"] == 3 and out["errors"] == []
    for r in out["ranks"]:
        assert r["rounds_wrong_with_waits"] == 0


def test_sharded_whole_fleet_on_two_ranks_of_one_card(cuda):
    """The sharded whole-fleet pass on 2 ranks of one card, each rank held
    to its flat pass bit for bit; only the plan's gather is staged."""
    out = _chip_checks(cuda, 2, "fleet_sharded", "--groups", "2000")
    assert (out["world"], out["shards"], out["errors"]) == (2, 2, [])
    for r in out["ranks"]:
        assert r["launches"] == {"stats_ring": 2, "plan_weights": 1,
                                 "fused_mlp_scores": 1}
        assert r["device_pass_staged_bytes"] == 0
        assert r["plan_staged_bytes"] == out["gather_staged_bytes"] > 0
