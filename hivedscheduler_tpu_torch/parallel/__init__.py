"""Process groups and device meshes (counterpart of
``hivedscheduler_tpu/parallel``). Sharding rules, sequence and pipeline
parallelism are later slices of the port."""
