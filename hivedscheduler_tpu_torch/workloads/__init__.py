"""What the port's workload entry points share (counterpart of
``example/workloads/common.py``): the boot from the scheduler's env block
and synthetic tokens; the pod's launcher (``launch.py``, one process per
granted card) and the long-context twin (``train_longctx.py``)."""
