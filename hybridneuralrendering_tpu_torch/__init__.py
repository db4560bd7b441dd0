"""PyTorch + CUDA port of hybridneuralrendering_tpu for one NVIDIA H100.

The JAX package `hybridneuralrendering_tpu` is the reference; this package
imports nothing of it and no `jax`.  Module names mirror the JAX package's.
Entry points run on `device="cuda"` unless the caller passes `device="cpu"`,
where every kernel wrapper takes its plain PyTorch version.
"""
