"""PyTorch/CUDA port of ``opentransformer_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here keeps
its counterpart's relative path and names, takes the same weights
(``compat.params_from_jax``) and is held against it by
``tests/test_torch_*.py``. The port imports ``torch`` and numpy only — no
JAX, flax, yaml, and nothing from the JAX package.

The Pallas kernels of the JAX package become hand-written CUDA kernels
under ``csrc/``, built with ``nvcc`` at first use (``ops/cuda_build.py``).
Each kernel has a plain PyTorch version beside it, which is what runs for
tensors on the CPU.
"""

__version__ = "0.1.0"
