"""The benchmark of the PyTorch and CUDA port (``hivedscheduler_tpu_torch``).

``python3 port_bench/run.py --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Everything
that belongs to one item sits in a file of its own, found by name:
``configs/<config>.json``, ``traffic/<mix>.json`` (whose ``driver`` names
``drivers/<driver>.py``), ``families/<family>.py`` (the port's side of a
model family) beside ``reference/<family>.py`` (its plain f32 reference),
``counts/<family>.py`` (its model FLOPs), ``metrics/<metric>.py`` and
``limits/<workload>.json``. The yardstick
(traffic, counts, the trace's reduction, the references and the comparison)
lives here and imports nothing of the port.
"""
