"""Process groups, device meshes and sharding (counterpart of
``hivedscheduler_tpu/parallel``): ``mesh.py`` boots a gang and lays out
its mesh, ``sharding.py`` places parameters by the rule table and writes
out the sharded step's collectives, ``ulysses.py`` and ``ring.py`` shard
attention over the sequence, ``pipeline.py`` runs the layer stack as GPipe
stages over pp."""
