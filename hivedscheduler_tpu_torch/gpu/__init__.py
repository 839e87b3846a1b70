"""The device contract on NVIDIA cards (counterpart of
``hivedscheduler_tpu/tpu``): ``env.py`` turns a pod's bind info into one
env block per granted card, ``topology.py`` declares H100 cell types for
the scheduler's config."""
