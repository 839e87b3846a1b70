"""Host-side utilities of the port (counterpart of
``hivedscheduler_tpu/utils``): the token-file input pipeline."""
