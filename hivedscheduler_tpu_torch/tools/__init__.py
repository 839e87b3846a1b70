"""Measurement tools run on the card (counterparts of the JAX package's
``hack/`` scripts)."""
