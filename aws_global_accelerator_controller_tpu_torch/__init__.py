"""PyTorch + CUDA port of the controller's weight-planning path.

A second package beside ``aws_global_accelerator_controller_tpu``: the
traffic MLP, the weight quantizer, the plan-vs-observed diff, the
whole-fleet and resident incremental planners, and the ``plan``
command, in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper
(``csrc/``) where the JAX package has Pallas kernels for the TPU.  It
imports neither JAX nor the JAX package.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``); see ``device.py``.
"""
