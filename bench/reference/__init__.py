"""The plain references the benchmark decides ``correct`` by: plain
PyTorch, float32 with TF32 off, importing nothing of the port or of the
JAX package."""
