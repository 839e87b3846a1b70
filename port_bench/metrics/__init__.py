"""One reader a per-layer metric, ``<metric>.py`` with ``read(measures)``:
the value, or None where the run has nothing for it to read."""
