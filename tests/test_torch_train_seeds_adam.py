"""The 3-step trajectory of ``tests/test_torch_train.py`` with
``adam``/``sequence`` on the batch seeds 0-19, every one of them: the
port against the JAX package op by op on the CPU, losses within rtol
1e-4 and params within 2 lr a step (the tolerances stated there).  One
file a configuration, so that ``--dist loadfile`` gives each sweep a
worker; the JAX side's compiles are made on the first seed and reused.
"""
import pytest

from test_torch_train import check_three_step_trajectory, temporal_params

SEEDS = range(20)

__all__ = ["temporal_params"]


@pytest.mark.parametrize("seed", SEEDS)
def test_three_step_trajectory_matches_jax_on_seed(temporal_params, seed):
    check_three_step_trajectory(temporal_params, "adam", "sequence", seed)
