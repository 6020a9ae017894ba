"""Measurement tools that run on the card (ports of the JAX package's
``tools/`` probes)."""
