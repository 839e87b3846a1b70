"""What the port's workload entry points share (counterpart of
``example/workloads/common.py``): the boot from the scheduler's env block
and synthetic tokens; the pod's launcher (``launch.py``, one process per
granted card) and the twins of the JAX package's workloads: long context
(``train_longctx.py``), pipeline stages (``train_pp.py``), BERT-large
(``train_bert.py``), Mixtral 8x7B over expert parallelism
(``train_mixtral.py``), ResNet-50 over dp (``train_resnet.py``) and the
MNIST MLP (``train_mnist.py``)."""
