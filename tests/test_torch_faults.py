"""The planted faults of ``kernels/chip_checks.py faults`` stay armed.

Each fault replaces a text of a kernel's source, and ``faults`` refuses
to run one whose text is not in that source exactly once, but only on
the card.  Here, on the CPU, every fault's text must occur exactly once
in its source, so that a redesign of a kernel cannot silently leave a
fault with nothing to change.
"""
import pytest

from aws_global_accelerator_controller_tpu_torch.kernels.chip_checks import (
    CHECKS,
    FAULTS,
    ROOT,
)


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_fault_text_occurs_once_in_its_source(name):
    src, old, new = FAULTS[name]
    assert src in CHECKS, f"{name}: no card check for {src}"
    assert old != new
    assert (ROOT / src).read_text().count(old) == 1, name


def test_every_k9_fault_is_planted_in_the_fused_backward():
    k9 = {name for name, (src, _, _) in FAULTS.items()
          if src.endswith("csrc/flash_attention_dqkv.cu")}
    assert k9 == {"dq_skips_k_block_0", "dkv_first_q_block_only",
                  "dq_last_block_unscaled", "dq_skips_its_wait",
                  "ticket_map_drops_last_k_block"}


def test_every_two_sweep_fault_is_planted_in_the_two_sweep_backward():
    k7_k8 = {name for name, (src, _, _) in FAULTS.items()
             if src.endswith("csrc/flash_attention_bwd.cu")}
    assert k7_k8 == {"dq_prefetch_drops_v", "dkv_skips_last_q_block",
                     "wide_head_drops_second_column_half"}


def test_every_forward_fault_is_planted_in_the_flash_forward():
    k6 = {name for name, (src, _, _) in FAULTS.items()
          if src.endswith("csrc/flash_attention.cu")}
    assert k6 == {"fwd_v_from_previous_k_block",
                  "fwd_walk_stops_one_k_block_short", "fwd_l_not_rescaled",
                  "wide_head_fwd_drops_upper_columns"}


def test_every_ring_fault_is_planted_in_the_ring_forward():
    ring = {name for name, (src, _, _) in FAULTS.items()
            if src.endswith("csrc/flash_attention_ring.cu")}
    assert ring == {"ring_drops_lo_term", "ring_walk_stops_one_k_block_short",
                    "ring_l_not_rescaled",
                    "wide_head_ring_drops_upper_columns"}


def test_every_k2_fault_is_planted_in_the_quantizer():
    k2 = {name for name, (src, _, _) in FAULTS.items()
          if src.endswith("csrc/plan_weights.cu")}
    assert k2 == {"quad_drops_lane_pair_level", "quad_rounds_down",
                  "quad_writes_last_quad_as_zero"}


def test_every_k3_fault_is_planted_in_the_mlp():
    k3 = {name for name, (src, _, _) in FAULTS.items()
          if src.endswith("csrc/mlp.cu")}
    assert k3 == {"layer2_drops_last_k16_step", "layer3_skips_last_chunk",
                  "plan_group_from_first_tile_only"}


def test_every_k4_fault_is_planted_in_the_row_splice():
    k4 = {name for name, (src, _, _) in FAULTS.items()
          if src.endswith("csrc/row_splice.cu")}
    assert k4 == {"vector_path_drops_last_lane", "table_skips_last_grid"}


def _score_head_faults():
    return {name for name, (src, _, _) in FAULTS.items()
            if src.endswith("csrc/score_head.cu")}


def test_every_k11_fault_is_planted_in_the_score_head():
    k11 = {name for name in _score_head_faults()
           if not name.startswith("fwd_tc_")}
    assert k11 == {"dx_skips_last_k16_step", "dw1_first_tile_only",
                   "dh_without_relu_gate", "half_partials",
                   "zero_weight_grads"}


def test_every_k10_fault_is_planted_in_the_score_head():
    k10 = {name for name in _score_head_faults()
           if name.startswith("fwd_tc_")}
    assert k10 == {"fwd_tc_drops_last_k16_step",
                   "fwd_tc_skips_last_hidden_chunk",
                   "fwd_tc_fold_without_relu"}
