"""Particle-axis sharding over ranks (port of the JAX package's
``parallel/``)."""
