"""PyTorch/CUDA port of ``proovread_tpu`` for one NVIDIA H100.

The package mirrors the JAX package's layout (``align/``, ``consensus/``,
``io/``, ``ops/``, ``pipeline/``) so each counterpart sits at the same path.
Plain tensor code is PyTorch; the four kernels of the correction pass are
CUDA C++ under ``csrc/``, built at first use (``proovread_tpu_torch.kernels``).
The package imports neither ``jax`` nor anything of ``proovread_tpu``.
"""

__version__ = "0.1.0"
