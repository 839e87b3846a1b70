"""Models of the port: the Llama-style transformer, its training step,
BERT-large (``bert.py``),
KV-cache generation, int8 quantization, checkpoints, the perf harness and
the converter from the JAX package's parameters."""
