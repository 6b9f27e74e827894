"""Lookup ops: plain PyTorch versions (lookup) and the wrappers of the
CUDA kernels (fused_lookup)."""
