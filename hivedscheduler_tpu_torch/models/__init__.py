"""Models of the port: the Llama-style transformer, its training step,
BERT-large (``bert.py``), the Mixtral MoE (``mixtral.py``), ResNet-50
(``resnet.py``), KV-cache generation, int8 quantization, checkpoints, the perf harness and
the converter from the JAX package's parameters."""

from typing import Any


def model_of(config: Any) -> Any:
    """The decoder module a config belongs to: ``mixtral`` for a
    ``MixtralConfig``, else ``transformer`` (its ``init`` and
    ``logical_axes`` place and gather the parameters)."""
    from . import mixtral, transformer

    return mixtral if isinstance(config, mixtral.MixtralConfig) else transformer
