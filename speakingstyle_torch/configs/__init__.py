"""Configuration schema and presets (copied from the JAX package)."""
