"""Functional ops and parameter modules with the JAX package's numerics."""
