"""Low-level compute primitives.

* :mod:`.ozaki` -- high-precision matrix multiplication via the Ozaki
  splitting scheme (exact int8- or bf16-slice products, recombined in
  f64); the ``FF_TPU_CONTRACT=ozaki`` contraction mode.
"""
from . import ozaki

__all__ = ['ozaki']
