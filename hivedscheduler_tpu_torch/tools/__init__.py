"""Measurement tools (counterparts of the JAX package's ``hack/`` scripts)
and the multi-process dryrun of the sharded step (``__graft_entry__.py``'s
twin)."""
