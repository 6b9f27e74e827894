"""bigsi_tpu_torch: bigsi-tpu on PyTorch and CUDA.

The bitslice matrix lives on an NVIDIA GPU, and hand-written CUDA
kernels (``csrc/lookup.cu``) gather, AND and count its rows.  Hashing,
storage, metadata, scoring, result building, the commands, the CLI and
the HTTP routes are this package's own copies of bigsi_tpu's host
layers, with the same on-disk index format, k-mer and hash arithmetic,
result dicts and routes; the package imports neither bigsi_tpu nor jax.
``metrics`` is the process-wide registry of phase timers and counters
that the facade records into.
"""

from bigsi_tpu_torch.graph import BIGSI, BigsiQueryResult
from bigsi_tpu_torch.utils.profiling import metrics
from bigsi_tpu_torch.version import __version__

__all__ = ["BIGSI", "BigsiQueryResult", "metrics", "__version__"]
