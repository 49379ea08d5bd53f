"""PyTorch/CUDA port of the intensity-guided ABFT serving stack.

Mirrors the JAX reference package ``repro`` module for module; imports
``torch`` and never ``jax`` or ``repro``.  Hand-written CUDA kernels live
under ``kernels/csrc`` and are built with ``nvcc`` at first CUDA use."""
