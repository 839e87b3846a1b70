"""Models of the port: the Llama-style transformer, KV-cache generation,
int8 quantization and the converter from the JAX package's parameters."""
