"""PyTorch/CUDA port of the ``repro`` serving system for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package never imports it.
"""
