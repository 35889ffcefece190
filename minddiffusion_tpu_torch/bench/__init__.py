"""Microbenchmarks of the port on the card (the JAX package's benchmarks/ scripts' counterparts)."""
