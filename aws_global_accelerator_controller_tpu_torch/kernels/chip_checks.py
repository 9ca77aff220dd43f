"""Checks of the kernels that need the card: two that need more than
one build, and a profile of the train step.

``ab TREE_A TREE_B``: device times of K2 (``chip_smoke.py``'s two shapes
of it, 16384 x 16 and 1,000,000 x 4; also on inputs that miss the L2, by
this checkout's ``chip_smoke.time_cold`` in both trees), of K3 (both
entries, H = 128 and 256), of K4's wave splice and of K1 (below),
of K10 and K11 (the train command's default shape and the reference's
own head shape; also eager, a call from Python), of the fused train
step that launches them (``chip_smoke.py``'s ``temporal_fused_train``,
ms a step on the host clock), of K6a, K6b, K7 and K8 apart (``chip_smoke.py``'s three
shapes of them: T = 64, S = 8192, D = 32; T = 2048, S = 128, D = 128;
T = 1024, S = 64, D = 160), of K6b-ring (``chip_smoke.py``'s seven
shapes of it) and of K9 (32 heads at T = 64, 1024 and 1536
with D = 32, at T = 256 and 2048 with D = 128, and at T = 1024 with
D = 160) in two checkouts, each in a fresh process with its own build,
in the order A, B, B, A, so that a drift of the card's clock over the
run falls on both alike.  Each run also takes sha256 digests (each
tensor as ``x.float() + 0.0``, so -0 and +0 hash alike): of K6a's o and
K6b's o, m and l at the three shapes and over a sweep (S = 3, T in 1,
63, 65, 200, 1024, D in 16, 20, 40, 64, 128, 136, 160, 200, 256, 288,
causal and not, and at T = 200, D in 32, 160, 256 with v scaled by
2^-110 or 2^32 in one head and one column of another, where the
forward's division leaves its fast path for ``/``), and of K7's and K8's dq, dk, dv at the three shapes on
the stats of the plain forward run on the card, which both trees compute
alike, so that a change in the forward's last ulp can neither mask nor
fake one in the backward; and of K6b-ring's o, m and l at 89 points (its
seven shapes, the card tests' ragged ``RING_SHAPES``, a sweep of three
heads with Tq, Tk from 1 to 200 and D from 16 to 288, causal and not,
and q scaled by 2^-100 or 2^-120, where the lo term of q' is
subnormal); of K9's dq, dk, dv at its six timed shapes, on the plain
forward's stats like K7's and K8's; of K2's int32 weights at its two
shapes, over E = 1..40 and 300 at ragged G (with infinities, a NaN,
wide scores and zeros of both signs in a few rows) and on rows of k
equal valid scores; and of K3's weights and row scores on its two
routes: the tensor-core route at H = 128 and 256 (the timed inputs),
the CUDA-core route at H = 129 and 512 (2048 x 16 groups); of K10's
scores and K11's dx at the two timed shapes and over the card tests'
sweep (D in 8, 20, 96, 128, 160, H in 16, 128, 200, 256, 512, 703
rows: both routes of each), beside each weight gradient's
``weight_grad_error`` against its plain version at the timed shapes
(their digests may differ: the parent's order of sums follows its
grid).  First it runs the card tests ``test_wgmma_sums_as_mma_sync``,
``test_wgmma_sums_split_terms_as_mma_sync`` and
``test_score_head_wgmma_forms_sum_as_mma_sync`` in TREE_B.  ``ab``
fails unless the four runs give the same backward digests (K7, K8 and
K9), the same K10 and K11 digests and K11's probe passed
(``head_digests_equal``, ``head_probe_passed``), the same K2 and K3
digests (``k2_digests_equal``,
``mlp_digests_equal``: K3's tensor-core route re-sums near-tie sums in
the CUDA-core route's f32 order, so both routes keep the parent's
values; no probe needed), the same
forward digests where the first test passed (wgmma sums as mma.sync, so
the forward must keep its bits) and the same K6b-ring digests
(``ring_digests_equal``) where the second did; where forward digests
differ it prints the largest difference of o (bf16 ulps), m and l (f32
ulps) of B's first run from A's, and where K6b-ring's differ, of its o,
m and l in f32 ulps (over the first 256 heads of a point).  This is how
two versions of a kernel are compared.

Each run of ``ab`` also times K4 and K1 (``_WAVE``): K4's splice of one
resident wave into the six grids of ``chip_smoke.py``'s 1,000,000-group
fleet at a churn wave's 10,000 rows and the cold wave's 1,000,000 (the
grids and rows of this checkout's ``chip_smoke._k4_wave`` in both
trees), as each checkout's planner makes it (a tree without
``fleet.pack_splice`` pads the rows to the planner's power-of-two
bucket and splices each grid apart): device ms (the splice's launches
in a CUDA graph of 20), eager ms (from the host rows: pad or pack,
upload, launch), six ``index_copy_``, K4's launches a wave, and digests
of the six grids after it; K1 at 8 x 128 (device, eager; digests at
n = 1, 3, 1024, 4097 and at an offset of one float), and the empty
kernel's launch floor where the tree has it.  ``ab`` fails unless these
digests are alike too (``wave_digests_equal``).

``faults``: plants faults in K10's and K11's tensor-core routes, in
K11's weight-gradient sums, in K9's sums,
in K7's and K8's pipeline, in the forward K6a/K6b, in K6b-ring, in
K2's quad route, in K3's tensor-core route and in K4, each
in a copy of this checkout made in a temporary directory,
and demands that the kernel's card tests and ``chip_smoke.py``'s check
of it fail on every one, the latter at every shape where the fault
changes the result:

- K11 (the card test over many row tiles; ``chip_smoke.py`` at both
  shapes, D = 32, H = 128 and D = 128, H = 256, both on the tensor-core
  route): ``dx_skips_last_k16_step``, dx's chain skips the last k16 step
  of the last hidden chunk; ``dw1_first_tile_only``, dw1 takes each
  sweep's first row tile of a CTA only; ``dh_without_relu_gate``, dh is
  formed without the relu gate; and in the partials' sum, which both
  routes launch, ``half_partials``, it sums every other CTA's partial,
  and ``zero_weight_grads``, the weight gradients come out zero;
- K10 (the card tests over many row tiles and of its tensor-core route
  against the parent's build, bit for bit; ``chip_smoke.py`` at the same
  two shapes, both on the route): ``fwd_tc_drops_last_k16_step``, h
  sums one k16 step of D fewer; ``fwd_tc_skips_last_hidden_chunk``, the
  scores miss the last hidden chunk's h . w2; ``fwd_tc_fold_without_relu``,
  h . w2 folds h without its relu;
- K9 (the card tests of the fused backward, T up to 200, and T = 1024
  and 2048 where the dq chains are longest; ``chip_smoke.py`` at
  T = 2048 and T = 1024, which have several K blocks, and at T = 64
  where the fault touches one):
  ``dq_skips_k_block_0``, dq misses the contribution of K block 0;
  ``dkv_first_q_block_only``, dk and dv sum over the first live q
  block only (no change where T has one block);
  ``dq_last_block_unscaled``, the last q block's dq is not scaled by
  D**-0.5; ``dq_skips_its_wait``, a visit reads its dq accumulator
  without waiting for the chain's counter (no change where T has one
  block); ``ticket_map_drops_last_k_block``, the tiles of the last K
  block end at once, leaving its dk, dv and some dq rows unwritten;
- K7 and K8 (the card tests of the two sweeps against K9, T = 1024 and
  2048 at 128 heads, D from 20 to 288; ``chip_smoke.py``'s check of K6b,
  K7 and K8 at its three shapes, which holds them to K9 bit for bit):
  ``dq_prefetch_drops_v``, K7's prefetch of the next K block copies k
  but not v, so block j computes with v of block j - 2 (no change where
  T has one block);
  ``dkv_skips_last_q_block``, K8's walk stops before the last q block;
  ``wide_head_drops_second_column_half``, in a head wider than 128 the
  second warpgroup takes no output columns (of the smoke check's shapes,
  a change at D = 160 only);
- K6a and K6b (the card tests of the forward against its plain version,
  T up to 1024, D from 16 to 288; ``chip_smoke.py``'s check of K6b, K7
  and K8 at its three shapes, which holds K6b to its plain version and
  K6a's o to K6b's): ``fwd_v_from_previous_k_block``, the producer loads
  v of K block kb - 1 into the stage of block kb (no change where T has
  one block); ``fwd_walk_stops_one_k_block_short``, producer and
  consumers fold one K block fewer (never none; no change where T has
  one block); ``fwd_l_not_rescaled``, l misses its alpha rescale (no
  change where T has one block); ``wide_head_fwd_drops_upper_columns``,
  p.v stops after two 64-column boxes, so columns past 128 stay zero (of
  the smoke check's shapes, a change at D = 160 only);
- K6b-ring (the card tests ``-k ring_stats_kernel``: against the plain
  version at ``RING_SHAPES``, and m against a one-hot k, where each score
  is one exact product; ``chip_smoke.py``'s ``_k6b_ring_one`` at the
  ring block, causal, at Tq = 64, Tk = 128 and at D = 160):
  ``ring_drops_lo_term``, s misses the lo term's product (m off by about
  2^-17 of it: the one-hot check); ``ring_walk_stops_one_k_block_short``,
  producer and consumers fold one K block fewer (never none);
  ``ring_l_not_rescaled``, l misses its alpha rescale;
  ``wide_head_ring_drops_upper_columns``, p.v stops after two 64-column
  boxes (a change at D = 160 only);
- K2's quad route (the card tests ``-k quantizer_kernel``; ``chip_smoke.py``'s
  ``_k2_one`` at 16384 x 16 and 1,000,000 x 4): ``quad_drops_lane_pair_level``,
  the sum misses the level inside the lane that adds cell j + 2 to cell
  j; ``quad_rounds_down``, ``rintf`` becomes ``floorf``;
  ``quad_writes_last_quad_as_zero``, the last quad of each row is written
  as 0;
- K3 on the tensor cores (the card tests ``-k "fused_mlp or
  row_scoring"``; ``chip_smoke.py``'s ``_k3_both`` at H = 128 and 256,
  whose plan entry is held bit for bit to K2 on the row entry's scores
  at E = 16, 7 and 300): ``layer2_drops_last_k16_step``, layer 2 sums
  one k16 step fewer; ``layer3_skips_last_chunk``, the layer-3 dot
  misses layer 2's last chunk of output columns (64 of 128 at H =
  128, 128 of 256 at H = 256); ``plan_group_from_first_tile_only``, a
  group over several tiles (E > 64) is planned on the scores of its
  first tile alone;
- K4 (the card tests ``-k "splice_kernel or resident_waves_on_card"``;
  ``chip_smoke.py``'s ``_k4_one`` at the churn and the cold wave, six
  grids a launch, four of them on the vector path):
  ``vector_path_drops_last_lane``, a row on the 16-byte path leaves its
  last vector unwritten; ``table_skips_last_grid``, the kernel's table
  leaves its last grid out (the launch still covers it, writing
  nothing).

``ties``: builds ``csrc/mlp.cu`` alone with its tensor-core route's
re-summing slack (``near_tie``'s bounds ``kTieX``, ``kTieV``,
``kTieS``) scaled by 0 (sums taken as the tensor cores give them), 1/16,
1/4 and 1 (the source as it is); for each, over 2^20 rows at H = 64,
128, 192 and 256 and four parameter seeds (one with random biases), it
counts the scores of the tensor-core route (F = 8) that differ from the
CUDA-core route's (the same MLP with zero features up to F = 17) and
their largest difference in bf16 ulps, counts the weights of the plan
entry that differ at E = 16, 7 and 300, and times both entries at
``chip_smoke.py``'s shapes (A B B A over the scales).  Exits 1 unless
the source as it is differs nowhere.

``sass [SOURCE ...]``: compiles kernel sources (default K6b-ring's,
K3's and K10's and K11's) with
``-Xptxas -v`` and dumps their SASS: registers, stack and spills a
kernel, every ptxas warning, HGMMA and HMMA counts, 128-bit global loads
and stores (``LDG.E.128``, ``STG.E.128``), and for K6b-ring's
source the CTAs an SM its launches take at each width class; exits 1 on
a warning or on a spill in a wgmma kernel.

``head TREE ...``: ``torch.profiler`` over 10 calls of K10's and of
K11's wrapper at their two timed shapes in each checkout: device ms a
call of each kernel they launch (the route's kernel, K11's partials'
sum, the copies around them).

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

``fleet_sharded``, run by ``torch.distributed.run``: the sharded
whole-fleet layout on every rank (``WholeFleetPlanner(world=...)``,
``--shards`` = the world's size), on ``chip_smoke.py``'s fleets:
``--fleet bench`` (``fleet_plan_groups``, the ``fleet-plan`` bench leg's
shape) or ``--fleet resident`` (the resident phase's version-0 groups),
``--groups`` and ``--cap`` their sizes.  Each rank plans a warm pass, the
device pass alone (timed, as is the upload of its shard; on the card
it must stage 0 bytes: the stats cross the ranks through kernel K5's
peer stores), and a timed pass, whose
launches it holds to K5 ``launches_per_pass`` times and K2 and the K3
row entry once, and whose staged bytes to the gather's; then it plans
the flat layout on its own device and demands every array and the
stats equal.  Rank 0 checks that every rank holds the same result,
prints one JSON object, and with ``--out PATH`` saves the plan (npz) for
a comparison across devices.

``fleet_sharded --ring-only``: kernel K5 alone on a data axis of every
rank.  ``--passes`` (200) reduces back to back, each of its own seeded
[5] f32 vectors of arbitrary magnitudes, through the card's exchange;
then the same vectors' CPU copies through the plain ring (gloo) among
the same ranks, and each rank's numpy sum in the reference's hop order:
every sum must equal both bit for bit.  Three planted faults, each
arranged so that its miss is certain, must fail the hop-order
comparison: a sum that leaves out a slot; a sum that skips its wait on
the peers' ``sent`` and runs before any rank sends (a second barrier);
a send that skips its wait on the peers' ``read`` and lands, two passes
on, before the sum it overwrites has run (a second barrier).  At the
end the ranks close the exchange (unmap, destroy the events, free).
Times: the exchange's ms a pass to completion (the passes back to back,
one synchronise), the plain ring's, gloo's ``all_reduce`` of the same
vector on the card (staged: NCCL refuses two ranks on one card), and
the send's and the sum's device ms (a CUDA graph of launches, no event)
and eager ms.

``ring_probe``, run by ``torch.distributed.run``: K5's mechanism on
the ranks of one card.  A launch, a stream synchronise after a launch
and a gloo barrier, each timed alone in ``--loops`` (200), and the
parent's pass from them (n launches, n - 1 synchronises, n - 1
barriers); a pass to completion with the events, with the fallback's
synchronise and barrier, and with neither (unordered; the events'
waits are its difference from the first), the three in turn, medians;
then ``--rounds`` (10,000) passes of integer blocks, each send after a
sleep on its stream (one rank in turn sleeping past a barrier every
16th round), every sum held to the hop order, and 1000 rounds whose
sums skip their wait on ``sent``, as a control that must read some
late slot early.

``ring_ab TREE_A TREE_B``: K5's pass to completion (200 back to back,
one synchronise) and gloo's ``all_reduce`` on 4 ranks of card 0 in two
checkouts, A B B A twice after an uncounted run of each.

``gloo``, run by ``torch.distributed.run`` on 2 ranks: whether gloo
takes CUDA tensors as they are (``all_reduce``, ``all_gather`` and a
``batch_isend_irecv`` hop), which decides whether the sharded path must
stage them through the host; each op's verdict (right, wrong, or
gloo's error) is printed by rank 0 as it comes.  A refused hop leaves
gloo's connection closed, and the run then ends non-zero.

Run from the root of a checkout, on a machine with one card::

    python3 -m aws_global_accelerator_controller_tpu_torch.kernels.chip_checks ab build/parent .
    python3 -m aws_global_accelerator_controller_tpu_torch.kernels.chip_checks faults [NAME ...]
    python3 -m aws_global_accelerator_controller_tpu_torch.kernels.chip_checks sass [SOURCE ...]
    python3 -m aws_global_accelerator_controller_tpu_torch.kernels.chip_checks head build/parent .
    python3 -m aws_global_accelerator_controller_tpu_torch.kernels.chip_checks profile [--window T --chunks 0 32 ...]
    python3 -m torch.distributed.run --standalone --nproc-per-node 4 -m aws_global_accelerator_controller_tpu_torch.kernels.chip_checks ring --device cuda:0
    python3 -m torch.distributed.run --standalone --nproc-per-node 2 -m aws_global_accelerator_controller_tpu_torch.kernels.chip_checks gloo --device cuda:0
    python3 -m torch.distributed.run --standalone --nproc-per-node 4 -m aws_global_accelerator_controller_tpu_torch.kernels.chip_checks fleet_sharded --device cuda:0 [--fleet resident --groups 1000000 --cap 4] [--ring-only]
    python3 -m torch.distributed.run --standalone --nproc-per-node 4 -m aws_global_accelerator_controller_tpu_torch.kernels.chip_checks ring_probe --device cuda:0 [--rounds 10000]
    python3 -m aws_global_accelerator_controller_tpu_torch.kernels.chip_checks ring_ab build/parent .

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

# run inside a checkout: prints {"ms": {row: device ms}, "digests":
# {name: sha256}} of its kernels, and saves the forward's outputs to the
# file named by its first argument; its second names the chip_smoke.py
# whose ``time_cold`` times K2 on inputs that miss the L2 (the same timer
# in both trees)
_TIME = r"""
import hashlib, importlib.util, json, sys, torch, chip_smoke as cs
from aws_global_accelerator_controller_tpu_torch.ops.cuda_mlp import (
    forward_cuda, score_rows_cuda)
from aws_global_accelerator_controller_tpu_torch.ops import cuda_head as ch
from aws_global_accelerator_controller_tpu_torch.ops import cuda_attention as ca
from aws_global_accelerator_controller_tpu_torch.ops.cuda_weights import (
    plan_weights_cuda)
from aws_global_accelerator_controller_tpu_torch.kernels import build
build.library()
out, digests, saved = {}, {}, {}
spec = importlib.util.spec_from_file_location("timers", sys.argv[2])
timers = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timers)


def digest(*xs):
    h = hashlib.sha256()
    for x in xs:
        h.update((x.float() + 0.0).cpu().numpy().tobytes())
    return h.hexdigest()


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
    # K3 on the tensor cores: weights and scores
    digests[f"mlp H={H}"] = digest(forward_cuda(p, x, m),
                                   score_rows_cuda(p, rows))
# K3 on the CUDA cores: weights and scores
for H in (129, 512):
    p = cs._mlp_params(3, H)
    g = torch.Generator(device="cuda").manual_seed(H)
    x = torch.randn(2048, cs.FLEET_CAP, cs.F, device="cuda",
                    generator=g).to(torch.bfloat16)
    m = torch.rand(2048, cs.FLEET_CAP, device="cuda", generator=g) < 0.8
    digests[f"mlp H={H}"] = digest(forward_cuda(p, x, m),
                                      score_rows_cuda(p, x.view(-1, cs.F)))


# K2: times and digests at chip_smoke.py's two shapes of it, digests over
# E = 1..40 and 300 at ragged G (edge values in a few rows: infinities, a
# NaN, scores 40 times wider, zeros of both signs) and on rows of k equal
# valid scores (k = 0..E)
def k2_inputs(G, E, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    s = torch.randn(G, E, device="cuda", generator=g) * 3
    n = torch.randint(0, E + 1, (G, 1), device="cuda", generator=g)
    m = torch.arange(E, device="cuda")[None, :] < n
    m[::7] = False
    return s, m, g


for G, E, seed in ((cs.FLEET_GROUPS, cs.FLEET_CAP, 1),
                   (cs.RESIDENT_GROUPS, cs.RESIDENT_CAP, 2)):
    s, m, _ = k2_inputs(G, E, seed)
    out[f"plan_weights {G}x{E}"] = cs.time_device(
        lambda: plan_weights_cuda(s, m))
    out[f"plan_weights cold {G}x{E}"] = timers.time_cold(
        plan_weights_cuda, (s, m))
    digests[f"k2 {G}x{E}"] = digest(plan_weights_cuda(s, m))
for E in (*range(1, 41), 300):
    G = 997 + 13 * E
    s, m, g = k2_inputs(G, E, 100 + E)
    s[3, 0], s[5, -1], s[8, 0] = float("inf"), float("-inf"), float("nan")
    s[10::17] *= 40
    s[12], s[12, ::2] = 0.0, -0.0
    digests[f"k2 sweep E={E}"] = digest(plan_weights_cuda(s, m))
    k = torch.arange(G, device="cuda")[:, None] % (E + 1)
    m = torch.arange(E, device="cuda")[None, :] < k
    s = (torch.randn(G, 1, device="cuda", generator=g) * 5).expand(G, E)
    digests[f"k2 equal E={E}"] = digest(plan_weights_cuda(s, m))
# K10 and K11: times, digests of K10's scores and K11's dx at the two
# timed shapes and over the card tests' sweep (703 rows, both routes of
# each), and each weight gradient's error against its plain
# version over its limit (the weight gradients' digests may differ: the
# parent's own order of sums depends on its grid)
weight_errors = {}
for T, S, D, H in ((64, 8192, 32, 128), (2048, 128, 128, 256)):
    x, w1, b1, w2, b2, ds = cs._head_inputs(T, S, D, H, 13)
    shape = f"T={T} S={S} D={D} H={H}"
    out["score_head_fwd " + shape] = cs.time_device(
        lambda: ch.score_head_forward(x, w1, b1, w2, b2))
    out["score_head_bwd " + shape] = cs.time_device(
        lambda: ch.score_head_bwd(x, w1, b1, w2, b2, ds))
    out["score_head_fwd eager " + shape] = cs.time_eager(
        lambda: ch.score_head_forward(x, w1, b1, w2, b2))
    out["score_head_bwd eager " + shape] = cs.time_eager(
        lambda: ch.score_head_bwd(x, w1, b1, w2, b2, ds))
    grads = ch.score_head_bwd(x, w1, b1, w2, b2, ds)
    digests["head fwd " + shape] = digest(
        ch.score_head_forward(x, w1, b1, w2, b2))
    digests["head dx " + shape] = digest(grads[0])
    want = ch.score_head_bwd_plain(x, w1, b1, w2, b2, ds)
    limits = ch.score_head_weight_grad_limits(x, w1, b1, w2, b2, ds)
    weight_errors[shape] = {
        name: ch.weight_grad_error(g, w, lim) for name, g, w, lim in zip(
            ("dw1", "db1", "dw2", "db2"), grads[1:], want[1:], limits)}
    del x, grads, want, limits
# the fused train step that launches them (chip_smoke.py's phase, host
# clock, one step checked on the CPU)
out["temporal_fused_train ms a step"] = cs.phase_temporal_fused_train(
    "cuda", check_steps=1)["fused_head_ms_per_step"]
for D in (8, 20, 96, 128, 160):
    for H in (16, 128, 200, 256, 512):
        x, w1, b1, w2, b2, ds = cs._head_inputs(19, 37, D, H, D + H)
        digests[f"head fwd sweep D={D} H={H}"] = digest(
            ch.score_head_forward(x, w1, b1, w2, b2))
        digests[f"head dx sweep D={D} H={H}"] = digest(
            ch.score_head_bwd(x, w1, b1, w2, b2, ds)[0])
for T, S, D in ((64, 8192, 32), (2048, 128, 128), (1024, 64, 160)):
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn(T, S, D, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    shape = f"T={T} S={S} D={D}"
    out["flash_attention " + shape] = cs.time_device(
        lambda: ca.flash_attention_forward(q, k, v))
    out["flash_attention_stats " + shape] = cs.time_device(
        lambda: ca.flash_attention_stats(q, k, v))
    o, m, l = ca.flash_attention_stats(q, k, v)
    o6a = ca.flash_attention_forward(q, k, v)
    digests["fwd " + shape] = digest(o6a, o, m, l)
    saved[shape] = [x.cpu() for x in (o6a, o, m, l)]
    del o, m, l, o6a
    # the backward on the plain forward's stats: alike in both trees
    o, m, l = ca.flash_attention_stats_plain(q, k, v, True, ca.BLOCK_K)
    dvec = ca.attention_dvec(o, do)
    out["flash_bwd_dq " + shape] = cs.time_device(
        lambda: ca.flash_bwd_dq(q, k, v, do, m, l, dvec))
    out["flash_bwd_dkv " + shape] = cs.time_device(
        lambda: ca.flash_bwd_dkv(q, k, v, do, m, l, dvec))
    digests["bwd " + shape] = digest(
        ca.flash_bwd_dq(q, k, v, do, m, l, dvec),
        *ca.flash_bwd_dkv(q, k, v, do, m, l, dvec))
    del q, k, v, do, o, m, l, dvec
for T in (1, 63, 65, 200, 1024):
    for D in (16, 20, 40, 64, 128, 136, 160, 200, 256, 288):
        for causal in (True, False):
            g = torch.Generator(device="cuda").manual_seed(T * 1000 + D)
            q, k, v = (torch.randn(T, 3, D, device="cuda", generator=g)
                       .to(torch.bfloat16) for _ in range(3))
            o, m, l = ca.flash_attention_stats(q, k, v, causal)
            o6a = ca.flash_attention_forward(q, k, v, causal)
            shape = f"T={T} S=3 D={D} causal={causal}"
            digests["fwd " + shape] = digest(o6a, o, m, l)
            saved[shape] = [x.cpu() for x in (o6a, o, m, l)]
# v scaled by 2^e in head 0 and in one column of head 1, so that |acc|
# leaves the range of the forward's fast division there (q near 0 and
# |v| in [1, 2) of one sign a column: no product is subnormal)
for D in (32, 160, 256):
    for causal in (True, False):
        for e in (-110, 32):
            g = torch.Generator(device="cuda").manual_seed(D + e)
            q = (torch.randn(200, 3, D, device="cuda", generator=g)
                 * 2.0 ** -10).to(torch.bfloat16)
            k = torch.randn(200, 3, D, device="cuda",
                            generator=g).to(torch.bfloat16)
            v = 1 + torch.rand(200, 3, D, device="cuda", generator=g)
            v[..., 1::2] *= -1
            v[:, 0] *= 2.0 ** e
            v[:, 1, 5] *= 2.0 ** e
            v = v.to(torch.bfloat16)
            o, m, l = ca.flash_attention_stats(q, k, v, causal)
            o6a = ca.flash_attention_forward(q, k, v, causal)
            shape = f"T=200 S=3 D={D} causal={causal} v*2^{e}"
            digests["fwd " + shape] = digest(o6a, o, m, l)
            saved[shape] = [x.cpu() for x in (o6a, o, m, l)]
# K6b-ring: times at chip_smoke.py's seven shapes of it; digests of
# (o, m, l) there, at the card tests' ragged RING_SHAPES, over a sweep of
# three heads (Tq, Tk from 1 to 200, D from 16 to 288, causal and not),
# and with q scaled by 2^-100 or 2^-120, where the lo term of q' is
# subnormal; at most 256 heads of each saved
RING = ((4096, 128, 128, 32, True, 0), (4096, 128, 128, 32, False, 0),
        (128, 2048, 2048, 128, True, 0), (64, 64, 128, 32, False, 0),
        (64, 128, 64, 32, False, 0), (256, 128, 128, 20, True, 0),
        (256, 128, 128, 160, True, 0))
RAGGED = ((3, 1, 1, 8, True, 0), (5, 70, 200, 40, True, 0),
          (5, 200, 70, 16, True, 0), (2, 130, 65, 256, False, 0))
SWEEP = tuple((3, Tq, Tk, D, causal, 0)
              for Tq, Tk in ((1, 1), (65, 65), (200, 200), (64, 130),
                             (130, 64))
              for D in (16, 40, 64, 128, 160, 256, 288)
              for causal in (True, False))
TINY = tuple((3, 200, 200, D, causal, e) for D in (32, 128)
             for causal in (True, False) for e in (-100, -120))
for H, Tq, Tk, D, causal, e in RING + RAGGED + SWEEP + TINY:
    g = torch.Generator(device="cuda").manual_seed(H + Tq + Tk + D)
    q = torch.randn(H, Tq, D, device="cuda", generator=g) * 2.0 ** e
    k, v = (torch.randn(H, Tk, D, device="cuda", generator=g)
            .to(torch.bfloat16) for _ in range(2))
    shape = f"H={H} Tq={Tq} Tk={Tk} D={D} causal={causal}" + (
        f" q*2^{e}" if e else "")
    if (H, Tq, Tk, D, causal, e) in RING:
        out["flash_attention_stats_ring " + shape] = cs.time_device(
            lambda: ca.flash_attention_stats_ring(q, k, v, causal))
    res = ca.flash_attention_stats_ring(q, k, v, causal)
    digests["ring " + shape] = digest(*res)
    saved["ring " + shape] = [x[:256].cpu() for x in res]
    del q, k, v, res
for T, S, D in ((64, 32, 32), (1024, 32, 32), (1536, 32, 32),
                (256, 32, 128), (2048, 32, 128), (1024, 32, 160)):
    g = torch.Generator(device="cuda").manual_seed(15)
    q, k, v, do = (torch.randn(T, S, D, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    o, m, l = ca.flash_attention_stats(q, k, v)
    dvec = ca.attention_dvec(o, do)
    out[f"flash_bwd_dqkv T={T} S={S} D={D}"] = cs.time_device(
        lambda: ca.flash_bwd_dqkv(q, k, v, do, m, l, dvec))
    # K9 on the plain forward's stats, alike in both trees
    o, m, l = ca.flash_attention_stats_plain(q, k, v, True, ca.BLOCK_K)
    dvec = ca.attention_dvec(o, do)
    digests[f"bwd dqkv T={T} S={S} D={D}"] = digest(
        *ca.flash_bwd_dqkv(q, k, v, do, m, l, dvec))
torch.save(saved, sys.argv[1])
print(json.dumps({"ms": out, "digests": digests,
                  "weight_grad_error": weight_errors}))
"""

# run inside a checkout: K4's splice of one resident wave at a churn wave's
# 10,000 rows and the cold wave's 1,000,000, on the grids, positions and
# rows of ``_k4_wave`` of the chip_smoke.py named by its first argument
# (the same data in both trees), as that checkout's planner splices them;
# and K1.  A checkout from before the batched splice (no
# ``fleet.pack_splice``: this PR's parent) pads the rows to the planner's
# power-of-two bucket (pads repeat row 0) and splices each grid apart.
# Prints {"ms": {row: ms}, "digests": {name: sha256}, "launches":
# {wave: K4 launches a wave}}.
_WAVE = r"""
import hashlib, importlib.util, json, sys, numpy as np, torch
from aws_global_accelerator_controller_tpu_torch import device as tdevice
from aws_global_accelerator_controller_tpu_torch.kernels import build
from aws_global_accelerator_controller_tpu_torch.parallel import fleet
from aws_global_accelerator_controller_tpu_torch.reconcile.columnar import (
    _pad_rows_bucket)
spec = importlib.util.spec_from_file_location("timers", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
build.library()
dev = tdevice.resolve_device("cuda")
out, digests, launches = {}, {}, {}


def digest(*xs):
    h = hashlib.sha256()
    for x in xs:
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()


for wave, seed in (("churn", 5), ("cold", 6)):
    grids, ks, kg, blocks = cs._k4_wave(wave, seed)
    bases = [g.clone() for g in grids]
    S, cap = grids[0].shape[:2]
    K = ks.size
    flats = [g.view(S * cap, -1) for g in grids]
    lin64 = torch.from_numpy(ks * cap + kg).to(dev)
    real = [torch.from_numpy(b.reshape(K, -1)).to(dev) for b in blocks]
    splice = fleet.make_row_splice(dev)
    if hasattr(fleet, "pack_splice"):
        lin, rows = fleet.pack_splice((S, cap), ks, kg, blocks, dev)

        def launch():
            fleet._splice_grids(flats, lin, rows)

        def eager():
            splice(grids, ks, kg, blocks)
    else:
        Kp = _pad_rows_bucket(K)
        pad = np.zeros(Kp - K, np.int64)
        lin = torch.from_numpy(np.concatenate([ks * cap + kg, pad + (
            ks[0] * cap + kg[0])]).astype(np.int32)).to(dev)
        rows = [torch.cat([r, r[:1].expand(Kp - K, -1)]) for r in real]

        def launch():
            for f, r in zip(flats, rows):
                fleet._SPLICE(dev, f, lin, r, Kp, f.shape[1])

        def eager():
            ksp = np.concatenate([ks, pad + ks[0]]).astype(np.int32)
            kgp = np.concatenate([kg, pad + kg[0]]).astype(np.int32)
            for g, r in zip(grids, blocks):
                r = np.concatenate([r] + [r[:1]] * (Kp - K))
                splice(g, ksp, kgp, torch.as_tensor(r, device=dev))

    def library():
        for f, r in zip(flats, real):
            f.index_copy_(0, lin64, r)

    shape = f"{wave} K={K}"
    out["row_splice wave " + shape] = cs.time_device(launch)
    out["row_splice wave eager " + shape] = cs.time_eager(
        eager, *((50, 5) if wave == "churn" else (5, 1)))
    out["index_copy_ wave " + shape] = cs.time_device(library)
    for g, b in zip(grids, bases):
        g.copy_(b)
    build.reset_launch_counts()
    eager()
    torch.cuda.synchronize()
    launches[wave] = build.launch_counts()["row_splice"]
    digests["wave " + shape] = digest(*grids)
    del grids, flats, bases, real, lin64, lin, rows
g = torch.Generator(device="cuda").manual_seed(1)
x = torch.randn(8, 128, device="cuda", generator=g)
out["probe_double 8x128"] = cs.time_device(lambda: tdevice.probe_double(x))
out["probe_double eager 8x128"] = cs.time_eager(
    lambda: tdevice.probe_double(x))
for n in (1, 3, 1024, 4097):
    buf = torch.randn(n + 1, device="cuda", generator=g)
    digests[f"probe n={n}"] = digest(tdevice.probe_double(buf[:n]),
                                     tdevice.probe_double(buf[1:]))
if hasattr(tdevice, "launch_floor"):
    out["launch_floor"] = cs.time_device(lambda: tdevice.launch_floor(dev))
    out["launch_floor eager"] = cs.time_eager(
        lambda: tdevice.launch_floor(dev))
print(json.dumps({"ms": out, "digests": digests, "launches": launches}))
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
_BWD_SRC = f"{PKG}/csrc/flash_attention_bwd.cu"
_FWD_SRC = f"{PKG}/csrc/flash_attention.cu"
_RING_SRC = f"{PKG}/csrc/flash_attention_ring.cu"
_K2_SRC = f"{PKG}/csrc/plan_weights.cu"
_MLP_SRC = f"{PKG}/csrc/mlp.cu"
_K4_SRC = f"{PKG}/csrc/row_splice.cu"
#: name -> (source, a text of it once, the faulty replacement)
FAULTS = {
    "vector_path_drops_last_lane": (
        _K4_SRC,
        "      for (long long c = 0; c < W4; ++c) d[c] = __ldg(s + c);",
        "      for (long long c = 0; c < W4 - 1; ++c) d[c] = __ldg(s + c);"),
    "table_skips_last_grid": (
        _K4_SRC,
        "  for (int j = 0; j < n; ++j) {",
        "  for (int j = 0; j < n - 1; ++j) {"),
    "dx_skips_last_k16_step": (
        _HEAD_SRC,
        "          for (int kk = 0; kk < 4; ++kk) {\n"
        "            const uint32_t a[4]",
        "          for (int kk = 0; kk < (c == chunks - 1 ? 3 : 4); ++kk) {\n"
        "            const uint32_t a[4]"),
    "dw1_first_tile_only": (
        _HEAD_SRC,
        "        if (c_lo + q < c_hi) {\n"
        "          const uint64_t dd",
        "        if (c_lo + q < c_hi && t == 0) {\n"
        "          const uint64_t dd"),
    "dh_without_relu_gate": (
        _HEAD_SRC,
        "            const float dh0 = h0 > 0.f ? bf16_round(d * wv.x) : "
        "0.f;\n"
        "            const float dh1 = h1 > 0.f ? bf16_round(d * wv.y) : "
        "0.f;",
        "            const float dh0 = bf16_round(d * wv.x);\n"
        "            const float dh1 = bf16_round(d * wv.y);"),
    "half_partials": (
        _HEAD_SRC,
        "for (int c = 0; c < ctas; ++c) s += partials[c * n + e];",
        "for (int c = 0; c < ctas; c += 2) s += partials[c * n + e];"),
    "zero_weight_grads": (_HEAD_SRC, "  out[e] = s;", "  out[e] = 0.f;"),
    "fwd_tc_drops_last_k16_step": (
        _HEAD_SRC,
        "    for (int kk = 0; kk < S::kKSteps; ++kk)",
        "    for (int kk = 0; kk < S::kKSteps - 1; ++kk)"),
    "fwd_tc_skips_last_hidden_chunk": (
        _HEAD_SRC,
        "    fold_chunk(part, h, b1s, w2s, c, H);",
        "    if (!last) fold_chunk(part, h, b1s, w2s, c, H);"),
    "fwd_tc_fold_without_relu": (
        _HEAD_SRC,
        "      const uint32_t v = hidden_pair(h[nt][2 * r], h[nt][2 * r + 1], "
        "bias);",
        "      const __nv_bfloat162 pre = __hadd2(\n"
        "          __floats2bfloat162_rn(h[nt][2 * r], h[nt][2 * r + 1]), "
        "bias);\n"
        "      const uint32_t v = *reinterpret_cast<const uint32_t*>(&pre);"),
    "dq_skips_k_block_0": (
        _DQKV_SRC,
        "        mma_kn(acc[nt], dsa[kk], ks, kStride, nt * 8, kk);",
        "        if (kb > 0) mma_kn(acc[nt], dsa[kk], ks, kStride, nt * 8, "
        "kk);"),
    "dkv_first_q_block_only": (
        _DQKV_SRC,
        "          mma_kn(dva[nt], pa, dos, kStride, nt * 8, kq);\n"
        "          mma_kn(dka[nt], dsa, qs, kStride, nt * 8, kq);",
        "          if (qb == (causal ? kb : 0)) {\n"
        "          mma_kn(dva[nt], pa, dos, kStride, nt * 8, kq);\n"
        "          mma_kn(dka[nt], dsa, qs, kStride, nt * 8, kq);\n"
        "          }"),
    "dq_last_block_unscaled": (
        _DQKV_SRC,
        "pack_bf16(\n"
        "                acc[nt][2 * r] * scale, acc[nt][2 * r + 1] * scale);",
        "pack_bf16(\n"
        "                acc[nt][2 * r] * (qb == n_blocks - 1 ? 1.f : scale),\n"
        "                acc[nt][2 * r + 1] * (qb == n_blocks - 1 ? 1.f : "
        "scale));"),
    "dq_skips_its_wait": (
        _DQKV_SRC,
        "      if (threadIdx.x == 0) wait_for(counters + slot, kb);",
        "      // no wait for visit kb - 1"),
    "ticket_map_drops_last_k_block": (
        _DQKV_SRC,
        "  const int kb = t / per_block;",
        "  const int kb = t / per_block;\n"
        "  if (kb == n_blocks - 1) return;"),
    "dq_prefetch_drops_v": (
        _BWD_SRC,
        "      async_tile<kCta>(next + tile, stride, cols, v, k0 + kBlock, T, S,"
        " D,\n                       s);\n",
        "      // v of K block kb + 1 not prefetched\n"),
    "dkv_skips_last_q_block": (
        _BWD_SRC,
        "  for (int qb = first_qb; qb < n_qb; ++qb) {",
        "  for (int qb = first_qb; qb < n_qb - 1; ++qb) {"),
    "wide_head_drops_second_column_half": (
        _BWD_SRC,
        "  return kWide ? (half ? steps - first : first) : kDPad / 16;",
        "  return kWide ? (half ? 0 : first) : kDPad / 16;"),
    "fwd_v_from_previous_k_block": (
        _FWD_SRC,
        "tma_tile<kDPad>(vs + stage * L::kBytes, &v_map, s, k0,",
        "tma_tile<kDPad>(vs + stage * L::kBytes, &v_map, s, "
        "max(k0 - kBlock, 0),"),
    "fwd_walk_stops_one_k_block_short": (
        _FWD_SRC,
        "  return causal ? qb + 1 : n_kb;",
        "  return max(causal ? qb : n_kb - 1, 1);"),
    "fwd_l_not_rescaled": (
        _FWD_SRC,
        "row_l[r] = row_l[r] * alpha[r] + rsum[r];",
        "row_l[r] = row_l[r] + rsum[r];"),
    "wide_head_fwd_drops_upper_columns": (
        _FWD_SRC,
        "  constexpr int kPvGroups = L::kBoxes;",
        "  constexpr int kPvGroups = L::kBoxes < 2 ? L::kBoxes : 2;"),
    "ring_drops_lo_term": (
        _RING_SRC,
        "        wgmma_ss64<0>(sc, lo_desc + step, k_desc + step);\n",
        "        // the lo term's product dropped\n"),
    "ring_walk_stops_one_k_block_short": (
        _RING_SRC,
        "  return causal ? min(n_kb, qb + 1) : n_kb;",
        "  return max(causal ? min(n_kb, qb + 1) - 1 : n_kb - 1, "
        "min(n_kb, 1));"),
    "ring_l_not_rescaled": (
        _RING_SRC,
        "row_l[r] = row_l[r] * alpha[r] + rsum[r];",
        "row_l[r] = row_l[r] + rsum[r];"),
    "wide_head_ring_drops_upper_columns": (
        _RING_SRC,
        "  constexpr int kPvGroups = L::kBoxes;",
        "  constexpr int kPvGroups = L::kBoxes < 2 ? L::kBoxes : 2;"),
    "quad_drops_lane_pair_level": (
        _K2_SRC,
        "  const float pair0 = t[0] + t[2], pair1 = t[1] + t[3];",
        "  const float pair0 = t[0], pair1 = t[1];"),
    "quad_rounds_down": (
        _K2_SRC,
        "rintf(e[c] / den * agac::kMaxWeight)",
        "floorf(e[c] / den * agac::kMaxWeight)"),
    "quad_writes_last_quad_as_zero": (
        _K2_SRC,
        "  if (mine) *reinterpret_cast<int4*>(out + at) = w;",
        "  if (mine)\n"
        "    *reinterpret_cast<int4*>(out + at) =\n"
        "        quad == E / 4 - 1 ? make_int4(0, 0, 0, 0) : w;"),
    "layer2_drops_last_k16_step": (
        _MLP_SRC,
        "    for (int k16 = 0; k16 < S::kSteps; ++k16)",
        "    for (int k16 = 0; k16 < S::kSteps - 1; ++k16)"),
    "layer3_skips_last_chunk": (
        _MLP_SRC,
        "        part[r][m][0] = fmaf(h.x, w.x, part[r][m][0]);\n"
        "        part[r][m][1] = fmaf(h.y, w.y, part[r][m][1]);\n",
        "        if (c < S::kChunks - 1) {\n"
        "        part[r][m][0] = fmaf(h.x, w.x, part[r][m][0]);\n"
        "        part[r][m][1] = fmaf(h.y, w.y, part[r][m][1]);\n"
        "        }\n"),
    "plan_group_from_first_tile_only": (
        _MLP_SRC,
        "        if (tq == 0 && lr < rows_here) my_sc[r0 + lr] = s;",
        "        if (tq == 0 && lr < rows_here && tile == 0) "
        "my_sc[r0 + lr] = s;"),
}
#: source -> (card tests (-k), chip_smoke function, its shapes, how many
#: of them each fault must fail)
CHECKS = {
    _HEAD_SRC: ("over_many_row_tiles or "
                "forward_tensor_cores_keep_the_parents_scores",
                "_head_rows_one",
                ((64, 8192, 32, 128, 13), (2048, 128, 128, 256, 14)), 2),
    _DQKV_SRC: ("fused_backward_kernel", "_k9_one",
                ((64, 32, 32, 15), (2048, 32, 128, 16),
                 (1024, 32, 160, 17)), 2),
    _BWD_SRC: ("two_sweep_backward", "_flash_train_rows",
               ((64, 8192, 32, 9), (2048, 128, 128, 10),
                (1024, 64, 160, 12)), 2),
    _FWD_SRC: ("flash_attention_kernel_matches or flash_stats_and_backward "
               "or flash_forward", "_flash_train_rows",
               ((64, 8192, 32, 9), (2048, 128, 128, 10),
                (1024, 64, 160, 12)), 2),
    _RING_SRC: ("ring_stats_kernel", "_k6b_ring_one",
                ((4096, 128, 128, 32, True, 18),
                 (64, 64, 128, 32, False, 21),
                 (256, 128, 128, 160, True, 24)), 3),
    _K2_SRC: ("quantizer_kernel", "_k2_one",
              ((16384, 16, 1), (1000000, 4, 2)), 2),
    _MLP_SRC: ("fused_mlp or row_scoring", "_k3_both", ((128,), (256,)), 2),
    _K4_SRC: ("splice_kernel or resident_waves_on_card", "_k4_one",
              (("churn", 5), ("cold", 6)), 2),
}


def _must_fail(name: str, src: str, shapes, must_fail: int) -> int:
    """How many of its source's smoke shapes a fault must fail: the
    source's count, or every shape the changed code runs at if fewer.  A
    fault named ``wide_head_*`` changes only heads wider than 128 (D, the
    shapes' third entry, K6b-ring's fourth), of which each flash kernel's
    smoke check has one."""
    if name.startswith("wide_head_"):
        d_at = 3 if src == _RING_SRC else 2
        return min(must_fail, sum(shape[d_at] > 128 for shape in shapes))
    return must_fail


def _run(cmd, cwd, timeout=900):
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


#: the card test that decides whether the forward must keep its bits
_PROBE = "test_wgmma_sums_as_mma_sync"
#: the same for K6b-ring's three-term score product
_RING_PROBE = "test_wgmma_sums_split_terms_as_mma_sync"
#: the forms of K11's tensor-core route, whose dx keeps its bits
_HEAD_PROBE = "test_score_head_wgmma_forms_sum_as_mma_sync"
#: the three shapes of K6a, K6b, K7 and K8 that ab times
_AB_SHAPES = ("T=64 S=8192 D=32", "T=2048 S=128 D=128", "T=1024 S=64 D=160")


def _max_ulps(a_runs: str, b_runs: str, points,
              names=("o_k6a", "o_k6b", "m", "l")) -> dict:
    """The largest difference of the forward's outputs between two runs'
    saved files, at ``points``, by ``names`` in the order saved: K6a's and
    K6b's o in bf16 ulps, every other (K6b's m and l, K6b-ring's f32 o, m
    and l) in f32 ulps, each of the larger magnitude of the pair."""
    import numpy as np
    import torch

    from ..parity import bf16_ulp

    a, b = torch.load(a_runs), torch.load(b_runs)
    worst = dict.fromkeys(names, 0.0)
    for point in points:
        for name, x, y in zip(worst, a[point], b[point]):
            x, y = x.float().numpy(), y.float().numpy()
            if not x.size:
                continue
            big = np.maximum(np.abs(x), np.abs(y))
            ulp = (bf16_ulp(big) if name.startswith("o_k6")
                   else np.spacing(big))
            worst[name] = max(worst[name], float((np.abs(x - y) / ulp).max()))
    return worst


def _card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], ROOT, timeout=60).stdout.strip()


def _ab_runs(tree_a: str, tree_b: str, run, rounds: int = 1,
             warm: bool = False):
    """``run(label, tree)`` on two checkouts in the order A B B A,
    ``rounds`` times (a drift of the card over the call weighs on both
    alike), after one uncounted run of each if ``warm``.  Returns the
    counted runs' [(label, result)], or None at the first run whose
    result is None."""
    trees = {"A": tree_a, "B": tree_b}
    order = (("A", "B") if warm else ()) + ("A", "B", "B", "A") * rounds
    counted = []
    for at, label in enumerate(order):
        res = run(label, trees[label])
        if res is None:
            return None
        if not warm or at >= 2:
            counted.append((label, res))
    return counted


def _ab_means(runs, samples) -> dict:
    """{label: {key: mean}} over ``runs`` ([(label, result)]), a result's
    values of each key given by ``samples(result)`` ({key: [values]})."""
    mean = {}
    for label in ("A", "B"):
        vals: dict = {}
        for at, res in runs:
            if at == label:
                for key, v in samples(res).items():
                    vals.setdefault(key, []).extend(v)
        mean[label] = {k: sum(v) / len(v) for k, v in vals.items()}
    return mean


def ab(tree_a: str, tree_b: str) -> int:
    print(json.dumps({"card": _card()}), flush=True)
    passed = {}
    for test in (_PROBE, _RING_PROBE, _HEAD_PROBE):
        probe = _run([sys.executable, "-m", "pytest", "--noconftest", "-q",
                      "-p", "no:cacheprovider", "tests/test_torch_cuda.py",
                      "-k", test], Path(tree_b).resolve())
        summary = (probe.stdout.strip().splitlines() or [""])[-1]
        passed[test] = probe.returncode == 0 and "1 passed" in summary
        print(json.dumps({"probe": test, "tree": tree_b,
                          "passed": passed[test], "summary": summary}),
              flush=True)
    probe_passed, ring_probe_passed = passed[_PROBE], passed[_RING_PROBE]
    with tempfile.TemporaryDirectory() as tmp:
        runs = []

        def one(name, tree):
            saved = str(Path(tmp) / f"run{len(runs)}.pt")
            res = _snippet(_TIME, tree, saved, str(ROOT / "chip_smoke.py"))
            wave = _snippet(_WAVE, tree, str(ROOT / "chip_smoke.py"))
            if res is None or wave is None:
                return None
            res["ms"].update(wave["ms"])
            res["digests"].update(wave["digests"])
            res["k4_launches_a_wave"] = wave["launches"]
            runs.append({"tree": name, "path": tree, "saved": saved, **res})
            print(json.dumps({"tree": name, "path": tree, "ms": res["ms"],
                              "k4_launches_a_wave": wave["launches"],
                              "weight_grad_error": res.get(
                                  "weight_grad_error"),
                              "digests": {k: v for k, v in
                                          res["digests"].items()
                                          if "S=3 " not in k
                                          and "H=3 " not in k
                                          and not k.startswith(
                                              ("k2 sweep", "k2 equal",
                                               "head fwd sweep",
                                               "head dx sweep"))}}),
                  flush=True)
            return res

        counted = _ab_runs(tree_a, tree_b, one)
        if counted is None:
            return 1
        mean = _ab_means(counted, lambda res: {k: [v] for k, v in
                                               res["ms"].items()})
        ratio = {k: mean["B"][k] / mean["A"][k] for k in mean["A"]}
        for shape in _AB_SHAPES:
            pair = [mean[t][f"flash_bwd_{n} {shape}"] for t in ("A", "B")
                    for n in ("dq", "dkv")]
            ratio[f"K7 + K8 {shape}"] = (pair[2] + pair[3]) / (pair[0]
                                                               + pair[1])
        differ = sorted({k for r in runs for k, v in r["digests"].items()
                         if v != runs[0]["digests"][k]})
        bwd_differ = [k for k in differ if k.startswith("bwd ")]
        fwd_differ = [k[4:] for k in differ if k.startswith("fwd ")]
        ring_differ = [k for k in differ if k.startswith("ring ")]
        k2_differ = [k for k in differ if k.startswith("k2 ")]
        mlp_differ = [k for k in differ if k.startswith("mlp ")]
        head_differ = [k for k in differ if k.startswith("head ")]
        wave_differ = [k for k in differ if k.startswith(("wave ", "probe "))]
        result = {"mean_ms": mean, "b_over_a": ratio,
                  "k4_launches_a_wave": {r["tree"]: r["k4_launches_a_wave"]
                                         for r in runs},
                  "wave_digests_equal": not wave_differ,
                  "wave_differing": wave_differ,
                  "bwd_digests_equal": not bwd_differ,
                  "fwd_digests_equal": not fwd_differ,
                  "fwd_points": sum(k.startswith("fwd ")
                                    for k in runs[0]["digests"]),
                  "fwd_points_differing": len(fwd_differ),
                  "fwd_must_be_equal": probe_passed,
                  "ring_digests_equal": not ring_differ,
                  "ring_points": sum(k.startswith("ring ")
                                     for k in runs[0]["digests"]),
                  "ring_points_differing": len(ring_differ),
                  "ring_must_be_equal": ring_probe_passed,
                  "k2_digests_equal": not k2_differ,
                  "k2_points": sum(k.startswith("k2 ")
                                   for k in runs[0]["digests"]),
                  "k2_differing_first": k2_differ[:10],
                  "mlp_digests_equal": not mlp_differ,
                  "mlp_differing": mlp_differ,
                  "head_digests_equal": not head_differ,
                  "head_points": sum(k.startswith("head ")
                                     for k in runs[0]["digests"]),
                  "head_differing": head_differ[:10],
                  "head_probe_passed": passed[_HEAD_PROBE]}
        # the parent (A, run 1) against this tree (B, run 2)
        if fwd_differ:
            result["fwd_differing_first"] = fwd_differ[:10]
            result["fwd_max_ulps_b_vs_a"] = _max_ulps(
                runs[0]["saved"], runs[1]["saved"], fwd_differ)
        if ring_differ:
            result["ring_differing_first"] = ring_differ[:10]
            result["ring_max_f32_ulps_b_vs_a"] = _max_ulps(
                runs[0]["saved"], runs[1]["saved"], ring_differ,
                ("o", "m", "l"))
        print(json.dumps(result), flush=True)
    ok = (not bwd_differ and not k2_differ and not mlp_differ
          and not head_differ and not wave_differ and passed[_HEAD_PROBE]
          and (not fwd_differ or not probe_passed)
          and (not ring_differ or not ring_probe_passed))
    return 0 if ok else 1


def _snippet(code: str, tree: str, *args):
    """Run ``code`` in a fresh process from the checkout ``tree``; its last
    line of output as JSON, or None (its output printed) if it failed."""
    r = _run([sys.executable, "-c", code, *args], Path(tree).resolve())
    if r.returncode:
        print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
        return None
    return json.loads(r.stdout.strip().splitlines()[-1])


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
        must_fail = _must_fail(name, src_name, shapes, must_fail)
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


# run inside a checkout: the device ms a call of each kernel K10's and
# K11's wrappers launch (the head's kernels and the copies around them),
# by torch.profiler over 10 calls of each at the two timed shapes
_HEAD_SPLIT = r"""
import json, torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from aws_global_accelerator_controller_tpu_torch.kernels import build
from aws_global_accelerator_controller_tpu_torch.ops import cuda_head as ch
build.library()
out = {}
for T, S, D, H in ((64, 8192, 32, 128), (2048, 128, 128, 256)):
    x, w1, b1, w2, b2, ds = cs._head_inputs(T, S, D, H, 13)
    for name, call in (
            ("fwd", lambda: ch.score_head_forward(x, w1, b1, w2, b2)),
            ("bwd", lambda: ch.score_head_bwd(x, w1, b1, w2, b2, ds))):
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        row = out[f"{name} T={T} S={S} D={D} H={H}"] = {}
        for e in prof.key_averages():
            us = (getattr(e, "device_time_total", 0)
                  or getattr(e, "cuda_time_total", 0))
            if us > 0:
                row[e.key[:80]] = us / 1000 / 10
print(json.dumps(out))
"""


def head_split(trees) -> int:
    """``head TREE ...``: K10's and K11's device ms a call split by kernel
    (the route's kernel, K11's partials' sum, the wrappers' copies) in
    each checkout, one JSON object a tree."""
    for tree in trees:
        r = _run([sys.executable, "-c", _HEAD_SPLIT], Path(tree).resolve())
        if r.returncode:
            print(r.stdout, r.stderr[-4000:], file=sys.stderr)
            return 1
        print(json.dumps({"tree": tree, "ms_per_call": json.loads(
            r.stdout.strip().splitlines()[-1])}), flush=True)
    return 0


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


def _chip_smoke():
    """``chip_smoke.py`` of this checkout: its fleets and timers."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


def _fleet(kind: str, groups: int, shards: int, cap: int):
    from ..reconcile.columnar import pack_fleet

    cs = _chip_smoke()
    if kind == "bench":
        specs = cs.fleet_plan_groups(groups, shards)
    else:
        gen = cs.ResidentFleetGen(groups, shards)
        specs = [gen.group(i, 0) for i in range(groups)]
    return pack_fleet(specs, endpoints_cap=cap, shards=shards,
                      feature_dim=cs.F)


def _digest(res) -> str:
    import hashlib

    h = hashlib.sha256()
    for a in (res.desired_w, res.to_add, res.to_remove, res.to_reweight):
        h.update(a.tobytes())
    h.update(json.dumps(res.stats, sort_keys=True).encode())
    return h.hexdigest()


def _same_plan(a, b) -> bool:
    import numpy as np

    return (all(np.array_equal(getattr(a, k), getattr(b, k)) for k in (
        "desired_w", "to_add", "to_remove", "to_reweight"))
        and a.stats == b.stats)


def fleet_sharded(device: str = "cuda", fleet_kind: str = "bench",
                  groups: int = 16384, cap: int = 16, out: str = "") -> int:
    import time

    import numpy as np
    import torch

    from ..ops.cuda_ring import launches_per_pass
    from ..parallel.distributed import (
        Group,
        join_world,
        peer_bytes,
        staged_bytes,
    )
    from ..parallel.fleet_plan import STAT_RESCORED, WholeFleetPlanner
    from .build import launch_counts, reset_launch_counts

    with join_world(device) as world:
        n, on_card = world.size, world.device.type == "cuda"

        def sync():
            if on_card:
                torch.cuda.synchronize(world.device)

        t0 = time.perf_counter()
        fleet = _fleet(fleet_kind, groups, n, cap)
        pack_s = time.perf_counter() - t0
        planner = WholeFleetPlanner(seed=0, world=world)
        planner.plan(fleet)                                   # warm
        sync()
        t0 = time.perf_counter()
        fn, rows, rest = planner.prepare(fleet)
        sync()
        prepare_ms = (time.perf_counter() - t0) * 1e3
        staged0, peer0 = staged_bytes(), peer_bytes()
        t0 = time.perf_counter()
        fn(planner.params, rows, *rest)
        sync()
        pass_ms = (time.perf_counter() - t0) * 1e3
        pass_staged = staged_bytes() - staged0
        pass_peer = peer_bytes() - peer0
        reset_launch_counts()
        staged0, peer0 = staged_bytes(), peer_bytes()
        sync()
        t0 = time.perf_counter()
        res = planner.plan(fleet)
        plan_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in launch_counts().items() if v}
        plan_staged = staged_bytes() - staged0
        plan_peer = peer_bytes() - peer0
        flat_planner = WholeFleetPlanner(params=planner.params,
                                         device=world.device)
        flat_planner.plan(fleet)                              # warm
        sync()
        t0 = time.perf_counter()
        flat = flat_planner.plan(fleet)
        flat_ms = (time.perf_counter() - t0) * 1e3
        S, Gs, E = fleet.desired.shape
        mine = {"rank": world.rank, "launches": launches,
                "plan_ms": plan_ms, "flat_ms": flat_ms,
                "prepare_ms": prepare_ms, "device_pass_ms": pass_ms,
                "device_pass_staged_bytes": pass_staged,
                "device_pass_peer_bytes": pass_peer,
                "plan_staged_bytes": plan_staged,
                "plan_peer_bytes": plan_peer,
                "equal_to_flat": _same_plan(res, flat),
                "layout": res.layout, "digest": _digest(res)}
        ranks = Group(range(n), world.rank).gather_objects(mine)
        if world.rank:
            return 0
        k = STAT_RESCORED + 1             # the stats the ring reduces
        gather_bytes = 4 * Gs * E * 4 * (1 + S) if on_card else 0
        bad = [f"rank {r['rank']}: layout {r['layout']}" for r in ranks
               if r["layout"] != "sharded"]
        bad += [f"rank {r['rank']} differs from its flat pass"
                for r in ranks if not r["equal_to_flat"]]
        if len({r["digest"] for r in ranks}) != 1:
            bad.append("the ranks' results differ")
        for r in ranks:
            want = ({"stats_ring": launches_per_pass(n), "plan_weights": 1,
                     "fused_mlp_scores": 1} if on_card else {})
            if r["launches"] != want:
                bad.append(f"rank {r['rank']} launched {r['launches']} in "
                           f"a pass, not {want}")
            if r["device_pass_staged_bytes"] != 0:
                bad.append(f"rank {r['rank']}: the device pass staged "
                           f"{r['device_pass_staged_bytes']} bytes")
            if r["plan_staged_bytes"] != gather_bytes:
                bad.append(f"rank {r['rank']}: a pass staged "
                           f"{r['plan_staged_bytes']} bytes, the gather "
                           f"{gather_bytes}")
            peer = (n - 1) * k * 4 if on_card else 0
            if r["device_pass_peer_bytes"] != peer \
                    or r["plan_peer_bytes"] != peer:
                bad.append(f"rank {r['rank']}: {r['plan_peer_bytes']} "
                           f"peer bytes a pass, not {peer}")
        if out:
            np.savez(out, desired_w=res.desired_w, to_add=res.to_add,
                     to_remove=res.to_remove, to_reweight=res.to_reweight,
                     stats=json.dumps(res.stats))
        print(json.dumps({
            "phase": "fleet_sharded", "fleet": fleet_kind,
            "device": str(world.device), "world": n, "groups": groups,
            "endpoints_cap": cap, "shards": S, "groups_per_shard": Gs,
            "pack_s": pack_s, "stats": res.stats,
            "ranks": [{k: v for k, v in r.items() if k != "digest"}
                      for r in ranks],
            "gather_staged_bytes": gather_bytes,
            "launches_per_pass": launches_per_pass(n),
            "passes": 3, "errors": bad}), flush=True)
        if bad:
            print("fleet_sharded: " + "; ".join(bad), file=sys.stderr)
            return 1
        return 0


def _int_blocks(passes: int, n: int, k: int):
    """[passes, n, k] f32 blocks of distinct small integers, each pass's
    above every earlier one's: sums are exact, and a slot left out, read
    before its store or overwritten by a later pass changes them."""
    import numpy as np

    p, s, c = np.meshgrid(np.arange(passes), np.arange(n), np.arange(k),
                          indexing="ij")
    return ((p + 1) * 64 + s * 8 + c + 1).astype(np.float32)


def _hop_order(blocks, i: int):
    """Rank i's sum of ``blocks`` [n, k] in the reference's hop order."""
    import numpy as np

    n = blocks.shape[0]
    acc = blocks[i].copy()
    for h in range(1, n):
        acc = (acc + blocks[(i - h) % n]).astype(np.float32)
    return acc


def _k5_faults(slots, dev, k: int):
    """Kernel K5's three planted faults, each arranged so that its miss is
    certain, on blocks of ``_int_blocks``: two correct passes before them
    (the slots then hold known blocks) and one between and one after
    fault (c), which must be right.  Returns (fault -> caught, whether
    the correct passes were right)."""
    import numpy as np
    import torch

    from ..ops.cuda_ring import (
        _SUM,
        PARITIES,
        SLOT_FLOATS,
        _waits,
        stats_ring_cuda,
        stats_ring_send,
        stats_ring_sum,
    )

    group = slots.group
    n, i = group.size, group.index
    blocks = _int_blocks(7, n, k)
    xs = [torch.from_numpy(b[i].copy()).to(dev) for b in blocks]

    def same(got, p):
        return np.array_equal(got.cpu().numpy().view(np.int32),
                              _hop_order(blocks[p], i).view(np.int32))

    def parity():
        q = slots.passes % PARITIES
        slots.passes += 1
        return q

    right = [same(stats_ring_cuda(slots, xs[p]), p) for p in (0, 1)]
    # (a) the sum leaves out the last slot
    q = parity()
    stats_ring_send(slots, xs[2], q, slots.peer_read[q], slots.sent[q])
    group.barrier()
    a = torch.empty_like(xs[2])
    _SUM(dev, xs[2], slots.slots(q), n - 1, a, k, SLOT_FLOATS,
         *_waits(slots.peer_sent[q]), slots.read[q])
    # (b) the sum skips its wait on sent[q] and runs to its end before any
    # rank sends (a second barrier): it reads pass 1's blocks
    q = parity()
    b = stats_ring_sum(slots, xs[3], q, (), slots.read[q])
    torch.cuda.synchronize(dev)
    group.barrier()
    stats_ring_send(slots, xs[3], q, slots.peer_read[q], slots.sent[q])
    group.barrier()
    # (c) pass 4's sum is held back until pass 6's send, which skips its
    # wait on read[q], has landed in the same slots (a second barrier)
    q = parity()
    stats_ring_send(slots, xs[4], q, slots.peer_read[q], slots.sent[q])
    group.barrier()
    right.append(same(stats_ring_cuda(slots, xs[5]), 5))
    parity()
    stats_ring_send(slots, xs[6], q, (), slots.sent[q])
    torch.cuda.synchronize(dev)
    group.barrier()
    c = stats_ring_sum(slots, xs[4], q, slots.peer_sent[q], slots.read[q])
    right.append(same(stats_ring_sum(slots, xs[6], q, slots.peer_sent[q],
                                     slots.read[q]), 6))
    caught = {"sum_skips_a_slot": not same(a, 2),
              "sum_skips_its_sent_wait": not same(b, 3),
              "send_skips_its_read_wait": not same(c, 4)}
    return caught, all(right)


def stats_ring_check(device: str = "cuda", passes: int = 200,
                     k: int = 5, seed: int = 0) -> int:
    import time

    import numpy as np
    import torch

    from ..ops.cuda_ring import (
        close_peer_slots,
        launches_per_pass,
        peer_slots,
        stats_ring_send,
        stats_ring_sum,
    )
    from ..parallel.distributed import join_world, peer_bytes, staged_bytes
    from ..parallel.fleet_plan import _make_stats_ring
    from ..parallel.mesh import make_mesh
    from .build import launch_counts, reset_launch_counts

    with join_world(device) as world:
        group = make_mesh(world, ("data",)).groups["data"]
        n, i, dev = group.size, group.index, world.device
        rng = np.random.default_rng(seed)
        vecs = (rng.standard_normal((passes, n, k))
                * 10.0 ** rng.integers(-6, 7, (passes, n, k))).astype(
                    np.float32)
        reduce = _make_stats_ring(group, dev)
        on_card = dev.type == "cuda"

        def sync():
            if on_card:
                torch.cuda.synchronize(dev)

        mine = [torch.from_numpy(v[i].copy()).to(dev) for v in vecs]
        sync()
        group.barrier()
        reset_launch_counts()
        staged0, peer0 = staged_bytes(), peer_bytes()
        # to completion: on the card the passes are asynchronous
        t0 = time.perf_counter()
        sums = [reduce(x) for x in mine]
        sync()
        pass_ms = (time.perf_counter() - t0) * 1e3 / passes
        launches = launch_counts().get("stats_ring", 0)
        staged = staged_bytes() - staged0
        peer = peer_bytes() - peer0
        got = torch.stack(sums).cpu().numpy()
        plain_reduce = _make_stats_ring(group, "cpu")
        t0 = time.perf_counter()
        plain = torch.stack([plain_reduce(torch.from_numpy(v[i].copy()))
                             for v in vecs]).numpy()
        plain_ms = (time.perf_counter() - t0) * 1e3 / passes
        want = np.stack([_hop_order(v, i) for v in vecs])
        equal_plain = bool(np.array_equal(got.view(np.int32),
                                          plain.view(np.int32)))
        equal_numpy = bool(np.array_equal(got.view(np.int32),
                                          want.view(np.int32)))
        max_err = float(np.abs(got.astype(np.float64)
                               - plain.astype(np.float64)).max())
        rec = {"rank": i, "pass_ms": pass_ms, "plain_pass_ms": plain_ms,
               "launches": launches, "staged_bytes": staged,
               "peer_bytes": peer, "equal_to_plain": equal_plain,
               "equal_to_numpy_hop_order": equal_numpy,
               "max_abs_err_vs_plain": max_err}
        if on_card:
            slots = peer_slots(group, dev)
            x = mine[0]
            group.all_reduce(x)                               # warm
            sync()
            group.barrier()
            t0 = time.perf_counter()
            for y in mine:
                group.all_reduce(y)
            sync()
            rec["gloo_all_reduce_ms"] = (time.perf_counter() - t0) * 1e3 \
                / passes
            cs = _chip_smoke()
            # the launches alone: no event waited on or recorded (a CUDA
            # graph holds neither); their stores land in slots that the
            # faults' first passes overwrite
            for name, fn in (
                    ("send",
                     lambda: stats_ring_send(slots, x, 0, (), None)),
                    ("sum",
                     lambda: stats_ring_sum(slots, x, 0, (), None))):
                group.barrier()
                rec[f"{name}_device_ms"] = cs.time_device(fn)
                rec[f"{name}_eager_ms"] = cs.time_eager(fn)
            sync()
            group.barrier()
            rec["faults_caught"], rec["passes_beside_faults_right"] = \
                _k5_faults(slots, dev, k)
            close_peer_slots()
        ranks = group.gather_objects(rec)
        if world.rank:
            return 0
        bad = [f"rank {r['rank']}: the sums differ from the plain ring's"
               for r in ranks if not r["equal_to_plain"]]
        bad += [f"rank {r['rank']}: the sums differ from the hop order's "
                f"numpy sums" for r in ranks
                if not r["equal_to_numpy_hop_order"]]
        for r in ranks:
            if on_card and r["launches"] != passes * launches_per_pass(n):
                bad.append(f"rank {r['rank']}: {r['launches']} launches in "
                           f"{passes} passes, not "
                           f"{passes * launches_per_pass(n)}")
            if r["staged_bytes"]:
                bad.append(f"rank {r['rank']} staged {r['staged_bytes']} "
                           f"bytes")
            if not on_card:
                continue
            bad += [f"rank {r['rank']}: fault {f} went unnoticed"
                    for f, c in r["faults_caught"].items() if not c]
            if not r["passes_beside_faults_right"]:
                bad.append(f"rank {r['rank']}: a correct pass beside the "
                           f"faults went wrong")
        print(json.dumps({"phase": "stats_ring", "device": str(dev),
                          "world": n, "k": k, "passes": passes,
                          "launches_per_pass": launches_per_pass(n),
                          "ranks": ranks, "errors": bad}), flush=True)
        if bad:
            print("stats_ring: " + "; ".join(bad), file=sys.stderr)
            return 1
        return 0


#: ``ring_probe``'s sleeps before a send, in clock cycles: every round's,
#: and the late rank's every LATE_EVERY-th round (about 2.5 ms at the
#: H100's 1.98 GHz, past a gloo barrier's 0.84 ms)
SLEEP, LATE_SLEEP, LATE_EVERY = 20_000, 5_000_000, 16


def ring_probe(device: str = "cuda", loops: int = 200,
               rounds: int = 10000, k: int = 5) -> int:
    """K5's mechanism on the card, every rank of the world on one data
    axis (see the module's docstring)."""
    import time

    import numpy as np
    import torch

    from ..ops.cuda_ring import (
        PARITIES,
        close_peer_slots,
        peer_slots,
        stats_ring_cuda,
        stats_ring_send,
        stats_ring_sum,
    )
    from ..parallel.distributed import join_world
    from ..parallel.mesh import make_mesh

    with join_world(device) as world:
        dev = world.device
        if dev.type != "cuda":
            raise ValueError("ring_probe runs on the card")
        group = make_mesh(world, ("data",)).groups["data"]
        n, i = group.size, group.index
        slots = peer_slots(group, dev)
        stream = torch.cuda.current_stream(dev)
        x = torch.ones(k, device=dev)
        rec = {"rank": i}

        def timed(name, body, part=None):
            """ms a call of ``body`` (to completion) over ``loops`` calls,
            every rank looping together; with ``part``, only ``part``'s
            share of each ``body(); part()``."""
            torch.cuda.synchronize(dev)
            group.barrier()
            total = 0.0
            t0 = time.perf_counter()
            for _ in range(loops):
                body()
                if part is not None:
                    t1 = time.perf_counter()
                    part()
                    total += time.perf_counter() - t1
            if part is None:
                torch.cuda.synchronize(dev)
                total = time.perf_counter() - t0
            rec[name] = total * 1e3 / loops

        def launch():
            stats_ring_send(slots, x, 0, (), None)

        # the parent's pass of n launches, n - 1 stream synchronises and
        # n - 1 barriers, each part timed alone
        timed("launch_ms", launch)
        timed("synchronize_ms", launch, stream.synchronize)
        timed("barrier_ms", group.barrier)
        rec["parent_pass_from_parts_ms"] = (
            n * rec["launch_ms"]
            + (n - 1) * (rec["synchronize_ms"] + rec["barrier_ms"]))

        # a pass to completion: with the events; the fallback's (send,
        # synchronise, barrier, sum: no event); the same launches and
        # barrier with neither (unordered: its sums are not read), whose
        # difference from the first is the events' waits; and passes
        # back to back, synchronised once
        def unevented(synchronise):
            q = slots.passes % PARITIES
            stats_ring_send(slots, x, q, (), None)
            if synchronise:
                stream.synchronize()
            group.barrier()
            stats_ring_sum(slots, x, q, (), None)
            slots.passes += 1
            torch.cuda.synchronize(dev)

        def with_events():
            stats_ring_cuda(slots, x)
            torch.cuda.synchronize(dev)

        # the three in turn, each pass timed alone, so that a drift of the
        # host falls on all three alike; medians
        variants = (("with_events", with_events),
                    ("fallback", lambda: unevented(True)),
                    ("unordered", lambda: unevented(False)))
        times = {name: [] for name, _ in variants}
        torch.cuda.synchronize(dev)
        group.barrier()
        for _ in range(loops):
            for name, fn in variants:
                t0 = time.perf_counter()
                fn()
                times[name].append((time.perf_counter() - t0) * 1e3)
        for name, ts in times.items():
            rec[f"pass_{name}_ms"] = float(np.median(ts))
        timed("pass_back_to_back_ms", lambda: stats_ring_cuda(slots, x))
        waits = np.array(times["with_events"]) - np.array(times["unordered"])
        rec["event_waits_ms_per_pass"] = float(np.median(waits))
        rec["one_wait_ms"] = rec["event_waits_ms_per_pass"] / (2 * (n - 1))

        # ordering: each round's blocks are integers no other round has;
        # before its send each rank's stream sleeps (a kernel of its own
        # that counts clock cycles), and every LATE_EVERY-th round one
        # rank in turn sleeps for longer than a barrier takes, so that a
        # sum that did not wait for that rank's send would read its
        # slot's older block
        blocks = _int_blocks(rounds, n, k)
        xs = torch.from_numpy(blocks[:, i].copy()).to(dev)

        def sleep(r):
            late = r % LATE_EVERY == 0 and (r // LATE_EVERY) % n == i
            return LATE_SLEEP if late else SLEEP

        def run(count, ordered):
            sums = []
            for r in range(count):
                torch.cuda._sleep(sleep(r))
                if ordered:
                    sums.append(stats_ring_cuda(slots, xs[r]))
                    continue
                q = slots.passes % PARITIES
                stats_ring_send(slots, xs[r], q, slots.peer_read[q],
                                slots.sent[q])
                group.barrier()
                sums.append(stats_ring_sum(slots, xs[r], q, (),
                                           slots.read[q]))
                slots.passes += 1
            got = torch.stack(sums).cpu().numpy()
            want = np.stack([_hop_order(blocks[r], i)
                             for r in range(count)])
            return int((got != want).any(axis=1).sum())

        torch.cuda.synchronize(dev)
        group.barrier()
        t0 = time.perf_counter()
        rec["rounds"] = rounds
        rec["rounds_wrong_with_waits"] = run(rounds, True)
        rec["ordered_round_ms"] = (time.perf_counter() - t0) * 1e3 / rounds
        control = min(rounds, 1000)
        group.barrier()
        rec["control_rounds"] = control
        rec["control_rounds_wrong_without_sent_wait"] = run(control, False)
        close_peer_slots()
        ranks = group.gather_objects(rec)
        if world.rank:
            return 0
        bad = [f"rank {r['rank']}: {r['rounds_wrong_with_waits']} of "
               f"{rounds} rounds read a slot before its store"
               for r in ranks if r["rounds_wrong_with_waits"]]
        if min(rounds, 1000) >= LATE_EVERY * n and not sum(
                r["control_rounds_wrong_without_sent_wait"] for r in ranks):
            bad.append("no sum without its wait read a late send's slot "
                       "early: the rounds do not test the ordering")
        print(json.dumps({"phase": "ring_probe", "device": str(dev),
                          "world": n, "k": k, "loops": loops,
                          "sleep_cycles": SLEEP,
                          "late_sleep_cycles": LATE_SLEEP,
                          "late_every": LATE_EVERY, "ranks": ranks,
                          "errors": bad}), flush=True)
        if bad:
            print("ring_probe: " + "; ".join(bad), file=sys.stderr)
            return 1
        return 0


# run inside a checkout by ``torch.distributed.run``, every rank on card
# 0: ms a K5 reduce pass to completion (the passes back to back, one
# synchronise at the end) and a gloo all_reduce of the same [5] vector;
# rank 0 prints the ranks' JSON
_RING_TIME = r"""
import json, os, sys, time, torch
sys.path.insert(0, os.getcwd())
from aws_global_accelerator_controller_tpu_torch.ops.cuda_ring import (
    close_peer_slots)
from aws_global_accelerator_controller_tpu_torch.parallel.distributed import (
    join_world)
from aws_global_accelerator_controller_tpu_torch.parallel.fleet_plan import (
    _make_stats_ring)
from aws_global_accelerator_controller_tpu_torch.parallel.mesh import (
    make_mesh)
passes = int(sys.argv[1])
with join_world("cuda:0") as world:
    group = make_mesh(world, ("data",)).groups["data"]
    dev = world.device
    reduce = _make_stats_ring(group, dev)
    xs = [torch.full((5,), float(p * group.size + group.index), device=dev)
          for p in range(passes)]
    rec = {"rank": group.index}
    for name, fn in (("pass_ms", reduce),
                     ("gloo_all_reduce_ms", group.all_reduce)):
        for x in xs[:10]:
            fn(x)
        torch.cuda.synchronize(dev)
        group.barrier()
        t0 = time.perf_counter()
        for x in xs:
            fn(x)
        torch.cuda.synchronize(dev)
        rec[name] = (time.perf_counter() - t0) * 1e3 / passes
    group.barrier()
    close_peer_slots()
    ranks = group.gather_objects(rec)
    if world.rank == 0:
        print(json.dumps(ranks), flush=True)
"""


def ring_ab(tree_a: str, tree_b: str, ranks: int = 4,
            passes: int = 200) -> int:
    """K5's pass to completion in two checkouts, A B B A twice after a
    run of each that builds it, ``ranks`` ranks on card 0, each run its
    own ``torch.distributed.run`` of ``_RING_TIME`` from a temporary
    directory, in the checkout."""
    card = _card()
    with tempfile.TemporaryDirectory() as tmp:
        script = Path(tmp) / "ring_time.py"
        script.write_text(_RING_TIME)

        def one(label, tree):
            proc = _run([sys.executable, "-m", "torch.distributed.run",
                         "--standalone", "--nproc-per-node", str(ranks),
                         str(script), str(passes)], Path(tree).resolve())
            if proc.returncode != 0:
                print(f"ring_ab: tree {label} ({tree}) failed",
                      proc.stdout[-4000:], proc.stderr[-4000:],
                      file=sys.stderr)
                return None
            return json.loads(proc.stdout.strip().splitlines()[-1])

        counted = _ab_runs(tree_a, tree_b, one, rounds=2, warm=True)
    if counted is None:
        return 1
    mean = _ab_means(counted, lambda ranks_: {
        key: [r[key] for r in ranks_]
        for key in ("pass_ms", "gloo_all_reduce_ms")})
    print(json.dumps({"phase": "ring_ab", "card": card, "world": ranks,
                      "passes": passes, "tree_a": tree_a, "tree_b": tree_b,
                      "runs": [{"tree": label, "ranks": r}
                               for label, r in counted],
                      "mean": mean,
                      "b_over_a": mean["B"]["pass_ms"]
                      / mean["A"]["pass_ms"]}),
          flush=True)
    return 0


#: near_tie's bounds in csrc/mlp.cu, each scaled by ``ties``
_TIE_TEXTS = (
    "constexpr float kTieX = 48.0f * 0x1p-24f;",
    "constexpr float kTieV = 24.0f * 0x1p-24f;",
    "(kH == 64 ? 6.0f : kH == 128 ? 4.25f : kH == 192 ? 3.5f : 3.0f) *\n"
    "      0x1p-24f;")
_TIE_SCALES = (("0", 0.0), ("1/16", 1 / 16), ("1/4", 0.25), ("1", 1.0))


def _mlp_library(tmp: Path, scale: float):
    """``csrc/mlp.cu`` with near_tie's bounds times ``scale``, as an
    ``nvcc`` process building a shared library of its own."""
    from .build import NVCC_FLAGS, nvcc_path

    text = (ROOT / _MLP_SRC).read_text()
    for t in _TIE_TEXTS:
        if text.count(t) != 1:
            raise RuntimeError(f"{_MLP_SRC}: no single {t!r}")
        text = text.replace(t, t.replace("0x1p-24f", f"{scale!r}f * 0x1p-24f"))
    src, lib = tmp / f"mlp_{scale}.cu", tmp / f"mlp_{scale}.so"
    src.write_text(text)
    return lib, subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-shared", "-I",
         str((ROOT / _MLP_SRC).parent), str(src), "-o", str(lib)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ties() -> int:
    """The tensor-core route's slack, measured: see the module's
    docstring."""
    import ctypes

    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from ..models.traffic import TrafficPolicyModel

    card = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], ROOT, timeout=60)
    print(card.stdout.strip(), flush=True)
    vp = ctypes.c_void_p
    with tempfile.TemporaryDirectory() as tmp:
        built = {name: _mlp_library(Path(tmp), f)
                 for name, f in _TIE_SCALES}
        libs = {}
        for name, (path, proc) in built.items():
            log = proc.communicate()[0]
            if proc.returncode:
                print(log[-4000:], file=sys.stderr)
                return 1
            lib = ctypes.CDLL(str(path))
            lib.agac_mlp_scores.argtypes = [vp] * 8 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, vp]
            lib.agac_mlp_plan.argtypes = [vp] * 9 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                vp]
            libs[name] = lib
        order = ("w1", "b1", "w2", "b2", "w3", "b3")

        def call(lib, p, x, m=None):
            F, H = p["w1"].shape
            stream = torch.cuda.current_stream().cuda_stream
            ptrs = [p[k].data_ptr() for k in order]
            if m is None:
                out = torch.empty(x.shape[0], device="cuda")
                rc = lib.agac_mlp_scores(x.data_ptr(), *ptrs, out.data_ptr(),
                                         x.shape[0], F, H, stream)
            else:
                out = torch.empty(m.shape, dtype=torch.int32, device="cuda")
                rc = lib.agac_mlp_plan(x.data_ptr(), m.data_ptr(), *ptrs,
                                       out.data_ptr(), m.shape[0],
                                       m.shape[1], F, H, stream)
            if rc:
                raise RuntimeError(f"K3 launch returned {rc}")
            return out

        def padded(p, x):
            # the same MLP with zero features up to F = 17: the CUDA-core
            # route, whose fmaf chains add only exact zeros
            q, pad = dict(p), 17 - p["w1"].shape[0]
            q["w1"] = torch.cat([p["w1"],
                                 p["w1"].new_zeros(pad, p["w1"].shape[1])])
            return q, torch.cat([x, x.new_zeros(*x.shape[:-1], pad)], dim=-1)

        def ulps(a, b):
            ref = torch.maximum(a.abs(), b.abs()).double()
            _, e = torch.frexp(ref)
            return float(((a - b).abs().double()
                          / torch.ldexp(torch.ones_like(ref), e - 8)).max())

        bad = False
        for H in (64, 128, 192, 256):
            for seed in range(4):
                p = TrafficPolicyModel(hidden_dim=H).init_params(
                    torch.Generator().manual_seed(seed), device="cuda")
                g = torch.Generator("cuda").manual_seed(100 + seed)
                if seed == 3:
                    for k in ("b1", "b2", "b3"):
                        p[k] = (torch.randn(p[k].shape, device="cuda",
                                            generator=g) * 0.3
                                ).to(torch.bfloat16)
                x = torch.randn(1 << 20, cs.F, device="cuda", generator=g)
                x[::97] *= 30
                x = x.to(torch.bfloat16)
                q, x17 = padded(p, x)
                rec = {"H": H, "seed": seed, "biases": seed == 3}
                for name, lib in libs.items():
                    want = call(lib, q, x17)
                    got = call(lib, p, x)
                    d = got != want
                    rec[f"scores_differing {name}"] = int(d.sum())
                    rec[f"max_ulps {name}"] = ulps(got[d], want[d]) \
                        if d.any() else 0.0
                for E in (16, 7, 300):
                    G = (1 << 18) // E
                    xe = x[:G * E].view(G, E, cs.F)
                    m = torch.rand(G, E, device="cuda", generator=g) < 0.8
                    q, x17 = padded(p, xe)
                    for name, lib in libs.items():
                        rec[f"weights_differing E={E} {name}"] = int(
                            (call(lib, p, xe, m) != call(lib, q, x17, m))
                            .sum())
                bad |= any(v for k, v in rec.items()
                           if k.endswith(" 1") and "differing" in k)
                print(json.dumps(rec), flush=True)
        for H in (128, 256):
            p = cs._mlp_params(3, H)
            g = torch.Generator(device="cuda").manual_seed(3)
            x = torch.randn(cs.FLEET_GROUPS, cs.FLEET_CAP, cs.F,
                            device="cuda", generator=g).to(torch.bfloat16)
            m = torch.rand(cs.FLEET_GROUPS, cs.FLEET_CAP, device="cuda",
                           generator=g) < 0.8
            rows = torch.randn(65536, cs.F, device="cuda",
                               generator=g).to(torch.bfloat16)
            ms = {}
            names = [n for n, _ in _TIE_SCALES]
            for name in names + names[::-1]:
                lib = libs[name]
                for what, fn in (("plan", lambda: call(lib, p, x, m)),
                                 ("rows", lambda: call(lib, p, rows))):
                    ms.setdefault(f"{what} {name}", []).append(
                        cs.time_device(fn))
            print(json.dumps({"H": H, "ms": {
                k: sum(v) / len(v) for k, v in ms.items()},
                "plan": f"{cs.FLEET_GROUPS}x{cs.FLEET_CAP}x{cs.F}",
                "rows": f"65536x{cs.F}"}), flush=True)
    return 1 if bad else 0


def sass(sources=(_RING_SRC, _MLP_SRC, _HEAD_SRC)) -> int:
    """Build checks of kernel sources with the card's toolkit: ``nvcc
    -Xptxas -v`` (registers, stack and spills a kernel, and every ptxas
    warning or performance-loss note, such as C7515's and C7518's
    serialised wgmma) and ``cuobjdump -sass`` of
    the object (HGMMA and HMMA instructions, and 128-bit global loads and
    stores, ``LDG.E.128`` and ``STG.E.128``, a kernel); for K6b-ring's
    source also the CTAs an SM its launches take at each width class.
    One JSON object a kernel; exits 1 on a warning or on a spill in a
    wgmma kernel (the mma.sync kernels kept past D = 256 are reported:
    K6b-ring's spills 28 bytes, as its parent did)."""
    import re

    from .build import NVCC_FLAGS, nvcc_path

    nvcc = Path(nvcc_path())
    bad = False
    with tempfile.TemporaryDirectory() as tmp:
        for src in sources:
            obj = Path(tmp) / (Path(src).stem + ".o")
            r = _run([str(nvcc), *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                      str(ROOT / src), "-o", str(obj)], ROOT)
            log = (r.stdout + r.stderr).splitlines()
            if r.returncode:
                print("\n".join(log[-40:]), file=sys.stderr)
                return 1
            dump = _run([str(nvcc.with_name("cuobjdump")), "-sass", str(obj)],
                        ROOT).stdout
            kernels, name = {}, None
            for line in log:
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    name = m.group(1)
                    kernels[name] = {}
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", line)
                if m and name:
                    kernels[name].update(zip(("stack", "spill_stores",
                                              "spill_loads"),
                                             map(int, m.groups())))
                m = re.search(r"Used (\d+) registers", line)
                if m and name:
                    kernels[name]["registers"] = int(m.group(1))
            for part in dump.split("Function : ")[1:]:
                fn = part.split(None, 1)[0]
                if fn in kernels:
                    kernels[fn]["hgmma"] = part.count("HGMMA")
                    kernels[fn]["hmma"] = part.count("HMMA")
                    kernels[fn]["ldg128"] = part.count("LDG.E.128")
                    kernels[fn]["stg128"] = part.count("STG.E.128")
            names = subprocess.run([str(nvcc.with_name("cu++filt"))],
                                   input="\n".join(kernels),
                                   capture_output=True, text=True)
            pretty = names.stdout.split("\n") if names.returncode == 0 \
                else list(kernels)
            for fn, readable in zip(kernels, pretty):
                rec = {"source": src, "kernel": readable, **kernels[fn]}
                bad |= bool(rec.get("hgmma") and (rec.get("spill_stores")
                                                  or rec.get("spill_loads")))
                print(json.dumps(rec), flush=True)
            # ptxas reports serialised wgmma (C7515, C7518) as "info"
            warnings = [ln for ln in log
                        if "warning" in ln or "Performance Loss" in ln]
            bad |= bool(warnings)
            print(json.dumps({"source": src, "ptxas_warnings": warnings}),
                  flush=True)
    if _RING_SRC in sources:
        from ..ops.cuda_attention import flash_attention_stats_ring_ctas

        print(json.dumps({"source": _RING_SRC, "ctas_per_sm_sms": {
            D: flash_attention_stats_ring_ctas(D)
            for D in (16, 32, 64, 128, 160, 256)}}), flush=True)
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_ab = sub.add_parser("ab", help="time the kernels of two checkouts")
    p_ab.add_argument("tree_a")
    p_ab.add_argument("tree_b")
    p_faults = sub.add_parser("faults",
                              help="plant faults in K11, K10, K9, K7, "
                                   "K8, K6a/K6b, K6b-ring, K2, K3 and "
                                   "K4")
    p_faults.add_argument("names", nargs="*", metavar="NAME",
                          help="faults to plant (default: all): "
                               + ", ".join(FAULTS))
    p_sass = sub.add_parser("sass", help="registers, spills, ptxas "
                                         "warnings and tensor-core "
                                         "instructions of kernel sources")
    p_sass.add_argument("sources", nargs="*",
                        default=[_RING_SRC, _MLP_SRC, _HEAD_SRC],
                        metavar="SOURCE",
                        help=f"paths from the checkout (default: "
                             f"{_RING_SRC} {_MLP_SRC} {_HEAD_SRC})")
    p_head = sub.add_parser("head", help="K10's and K11's device time "
                                         "split by kernel, in each "
                                         "checkout")
    p_head.add_argument("trees", nargs="+", metavar="TREE")
    sub.add_parser("ties", help="K3's tensor-core re-summing slack: "
                                "differing values and times at four "
                                "scales")
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
    p_fleet = sub.add_parser("fleet_sharded",
                             help="the sharded whole-fleet pass, or K5 "
                                  "alone, under torch.distributed.run")
    p_fleet.add_argument("--device", default="cuda")
    p_fleet.add_argument("--fleet", choices=("bench", "resident"),
                         default="bench")
    p_fleet.add_argument("--groups", type=int, default=16384)
    p_fleet.add_argument("--cap", type=int, default=16)
    p_fleet.add_argument("--out", default="",
                         help="rank 0 saves the plan here (npz)")
    p_fleet.add_argument("--ring-only", action="store_true",
                         help="kernel K5 alone against its plain version")
    p_fleet.add_argument("--passes", type=int, default=200)
    p_probe = sub.add_parser("ring_probe",
                             help="K5's parts, event ordering and event "
                                  "waits on the card, under "
                                  "torch.distributed.run")
    p_probe.add_argument("--device", default="cuda")
    p_probe.add_argument("--loops", type=int, default=200)
    p_probe.add_argument("--rounds", type=int, default=10000)
    p_rab = sub.add_parser("ring_ab", help="K5's pass to completion in "
                                           "two checkouts")
    p_rab.add_argument("tree_a")
    p_rab.add_argument("tree_b")
    p_rab.add_argument("--ranks", type=int, default=4)
    p_rab.add_argument("--passes", type=int, default=200)
    args = ap.parse_args(argv)
    if args.cmd == "ring_probe":
        return ring_probe(args.device, args.loops, args.rounds)
    if args.cmd == "ring_ab":
        return ring_ab(args.tree_a, args.tree_b, args.ranks, args.passes)
    if args.cmd == "fleet_sharded":
        if args.ring_only:
            return stats_ring_check(args.device, args.passes)
        return fleet_sharded(args.device, args.fleet, args.groups,
                             args.cap, args.out)
    if args.cmd == "gloo":
        return gloo(args.device)
    if args.cmd == "ring":
        return ring(args.device, args.T, args.H, args.D, args.seed)
    if args.cmd == "sass":
        return sass(tuple(args.sources))
    if args.cmd == "ties":
        return ties()
    if args.cmd == "head":
        return head_split(args.trees)
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
