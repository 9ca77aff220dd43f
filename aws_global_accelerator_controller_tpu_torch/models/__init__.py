"""The traffic policy model and the params bridge from the JAX package."""
