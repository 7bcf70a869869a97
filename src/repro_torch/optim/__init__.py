"""Optimizers of the port: AdamW (jnp and kernel paths) and its Mozart pipeline."""
