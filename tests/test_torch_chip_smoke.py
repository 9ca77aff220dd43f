"""``chip_smoke.py`` rehearsed on the CPU at a small size.

The script's planning phases take a device; here they run with
``device="cpu"``, so their fleet generators, entry-point calls and
checks are exercised without a card (its kernel phase needs one and
runs only there).
"""
import chip_smoke

from aws_global_accelerator_controller_tpu_torch.kernels import build


def test_plan_phase_rehearses_on_cpu():
    out = chip_smoke.phase_plan("cpu", groups=32, endpoints=8)
    assert out["device"] == "cpu" and out["max_abs_err_vs_cpu"] == 0


def test_whole_fleet_phase_rehearses_on_cpu():
    out = chip_smoke.phase_fleet("cpu", groups=256, shards=4, cap=16)
    assert out["mean_occupancy"] == 2.5
    assert out["mutating_groups"] > 0


def test_resident_phase_rehearses_on_cpu():
    out = chip_smoke.phase_resident("cpu", groups=2000, shards=8, cap=4,
                                    launch_counts=build.launch_counts)
    assert out["verify_full_repack"]["match"] is True
    assert out["clean_wave_device_call"] is False
    assert [w["dirty_groups"] for w in out["waves"]] == [20, 20, 20]
    assert all(w["rescored_groups"] > 0 for w in out["waves"])
    assert not any(out["launches"].values())
    assert not out["churn_launches"] and not out["verify_launches"]


def test_temporal_plan_phase_rehearses_on_cpu():
    build.reset_launch_counts()
    out = chip_smoke.phase_temporal_plan(
        "cpu", launch_counts=build.launch_counts, groups=3, endpoints=5,
        window=16)
    assert out["device"] == "cpu" and out["max_abs_err_vs_cpu"] == 0
    assert (out["groups"], out["endpoints"]) == (3, 5)
    assert not any(out["launches"].values())


def test_temporal_eval_phase_rehearses_on_cpu():
    out = chip_smoke.phase_temporal_eval("cpu", batches=2, groups=3,
                                         endpoints=4, hidden=32)
    assert out["device"] == "cpu" and out["batches"] == 2
    assert out["mean_loss_rel_err_vs_cpu"] == 0
    assert out["plan_l1_err_vs_cpu"] == 0


def test_temporal_seq_phase_rehearses_on_cpu():
    out = chip_smoke.phase_temporal_seq("cpu", steps=130, groups=2,
                                        endpoints=3, embed_dim=32,
                                        hidden_dim=32)
    assert out["streams"] == 6
    assert out["max_abs_err_vs_reference"] <= chip_smoke.SEQ_TOL


def test_temporal_train_phase_rehearses_on_cpu():
    build.reset_launch_counts()
    out = chip_smoke.phase_temporal_train(
        "cpu", steps=4, groups=3, endpoints=4, hidden=16,
        launch_counts=build.launch_counts)
    assert out["device"] == "cpu" and out["step"] == 4
    assert out["loss_rel_err_vs_cpu"] == 0
    assert out["check_loss"] == out["cpu_loss"]
    assert not any(out["launches"].values())


def test_temporal_train_seq_phase_rehearses_on_cpu():
    out = chip_smoke.phase_temporal_train_seq(
        "cpu", steps=130, groups=2, endpoints=3, embed_dim=32,
        hidden_dim=32, timed_steps=1)
    assert out["streams"] == 6 and out["timed_steps"] == 1
    assert set(out["grad_error_vs_reference"]) == {
        "embed", "wq", "wk", "wv", "w1", "b1", "w2", "b2"}
    assert max(out["grad_error_vs_reference"].values()) <= 1.0


def test_mlp_train_phase_rehearses_on_cpu():
    out = chip_smoke.phase_mlp_train("cpu", steps=4, groups=8,
                                     endpoints=4, hidden=16)
    assert out["model"] == "mlp" and out["loss_rel_err_vs_cpu"] == 0


def test_temporal_fused_train_phase_rehearses_on_cpu():
    """On the CPU ``head="fused"`` is the dense head (as in the
    reference off its TPU), held against ``head="fused_always"``, the
    kernels' plain versions; no kernel launches."""
    build.reset_launch_counts()
    out = chip_smoke.phase_temporal_fused_train(
        "cpu", steps=4, groups=3, endpoints=4, hidden=16, embed_dim=16,
        launch_counts=build.launch_counts)
    assert out["device"] == "cpu" and out["steps"] == 4
    assert out["loss_rel_err_vs_cpu"] <= chip_smoke.TRAIN_LOSS_RTOL
    assert out["loss_rel_err_vs_dense_head"] == 0
    assert max(out["grad_error_vs_dense_head"].values()) == 0
    assert not any(out["launches"].values())


def test_temporal_chunk_train_phase_rehearses_on_cpu():
    """12 streams in calls of 5: the fused route's plain versions on the
    CPU, equal to the unchunked command's."""
    build.reset_launch_counts()
    out = chip_smoke.phase_temporal_chunk_train(
        "cpu", steps=4, groups=3, endpoints=4, hidden=16, chunk=5,
        launch_counts=build.launch_counts)
    assert out["device"] == "cpu" and out["step"] == 4
    assert (out["attention_chunk"], out["calls_per_step"]) == (5, 3)
    assert out["loss_rel_err_vs_cpu"] == 0
    assert not any(out["launches"].values())


def test_temporal_chunk_train_seq_phase_rehearses_on_cpu():
    out = chip_smoke.phase_temporal_chunk_train_seq(
        "cpu", steps=130, groups=2, endpoints=5, embed_dim=32,
        hidden_dim=32, chunk=4, timed_steps=1)
    assert out["streams"] == 10 and out["attention_chunk"] == 4
    assert set(out["grad_error_vs_unchunked"]) == {
        "embed", "wq", "wk", "wv", "w1", "b1", "w2", "b2"}
    assert max(out["grad_error_vs_unchunked"].values()) <= 1.0
    assert out["loss_rel_err_vs_unchunked"] <= 1e-4


def test_temporal_sharded_train_phase_rehearses_on_cpu():
    """Four CPU ranks under torch.distributed.run at a 128-step window
    (64-step blocks, so the flash local: the plain K6b-ring), held to the
    unsharded command and to themselves as the "CPU" side; no launch."""
    out = chip_smoke.phase_temporal_sharded_train(
        "cpu", window=128, groups=4, endpoints=4, hidden=16, steps=2,
        cpu_groups=4)
    assert (out["world"], out["mesh"], out["local"]) == (
        4, {"data": 2, "seq": 2}, "flash")
    assert len(out["losses"]) == len(out["unsharded_losses"]) == 2
    assert out["loss_max_rel_err_vs_unsharded"] <= chip_smoke \
        .SHARDED_LOSS_RTOL
    assert out["loss_max_rel_err_vs_cpu"] == 0
    assert out["launches"] == {}
    assert out["staged_bytes_per_step_by_rank"] == [0.0] * 4


def test_temporal_sharded_train_1_phase_rehearses_on_cpu():
    build.reset_launch_counts()
    out = chip_smoke.phase_temporal_sharded_train_1(
        "cpu", groups=3, endpoints=4, hidden=16, steps=2,
        launch_counts=build.launch_counts)
    assert out["world"] == 1 and out["local"] == "flash"
    assert not any(out["launches"].values())


def test_temporal_sharded_plan_phase_rehearses_on_cpu():
    out = chip_smoke.phase_temporal_sharded_plan("cpu", groups=4,
                                                 endpoints=4, window=16)
    assert out["mesh"] == {"data": 2, "seq": 2}
    assert out["equal_share_vs_unsharded"] >= chip_smoke.SHARDED_PLAN_EQUAL


def test_ring_attention_phase_rehearses_on_cpu():
    out = chip_smoke.phase_ring_attention("cpu", T=128, H=8, D=16)
    assert out["world"] == 4 and out["launches"] == {}
    assert out["o_ulps_of_magnitude_vs_dense"] <= 2
    assert max(out["grad_ulps_of_head_max_vs_dense"].values()) <= 4
