"""Carrying weights across from the JAX package."""
