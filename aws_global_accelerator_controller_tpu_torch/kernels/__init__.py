"""The hand-written Hopper kernels' build and binding (see build.py)."""
