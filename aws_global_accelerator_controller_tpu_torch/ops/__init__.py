"""Weight-planning ops: the plain versions and the kernel wrappers."""
