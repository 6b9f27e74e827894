"""bigsi_tpu_torch: bigsi-tpu's search on PyTorch and CUDA.

The bitslice matrix lives on an NVIDIA GPU, and hand-written CUDA
kernels (``csrc/lookup.cu``) gather, AND and count its rows.  Hashing,
storage, metadata, scoring, result building and the HTTP routes are
bigsi_tpu's jax-free host layers, reused by import; this package never
imports jax.  ``metrics`` is the process-wide registry of phase timers
and counters that the facade records into.
"""

from bigsi_tpu.utils.profiling import metrics
from bigsi_tpu_torch.graph import BIGSI

__all__ = ["BIGSI", "metrics"]
