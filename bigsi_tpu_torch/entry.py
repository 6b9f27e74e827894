"""The flagship one-program query steps, as one function with example inputs.

The counterpart of ``__graft_entry__.py:entry``: :func:`entry` returns
``(fn, example_args)``, where ``fn(words, kmers, mask, cols, seqs, lens)``
runs both serving steps of the port on the example's tensors and returns
``(classic_counts, seq_counts, ok)``:

(a) classic: raw ASCII k-mers through ``ops/lookup.py:make_full_query_step``
    (kernel I's canonical k-mers, murmur3 and rows, then kernel A's
    gather, AND and counts);
(b) the seq serving step: raw ACGT query bytes through kernel H
    (``fused_lookup.seq_streams``: 2-bit codes, minimizer tiles, the
    distinct-k-mer dedup and runs) into kernel E (``fused_lookup.cols_counts``).

The example inputs come from ``np.random.default_rng(0)`` in the JAX
entry's order, so both give the same arrays; the JAX uint16 cols are the
port's int16 cols holding the same bits.  ``device=None`` means CUDA;
``device="cpu"`` runs the plain versions.  The multi-device dry run
(``__graft_entry__.py:dryrun_multichip``) waits for the port's multi-GPU
engine.
"""

from __future__ import annotations

import numpy as np
import torch

from bigsi_tpu_torch.index.device_engine import resolve_device
from bigsi_tpu_torch.matrix.bitmatrix import BitSliceMatrix
from bigsi_tpu_torch.ops.fused_lookup import cols_counts, seq_streams
from bigsi_tpu_torch.ops.lookup import make_full_query_step

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _tiny_problem(rng, m=512, n_samples=1000, B=8, K=64, h=3):
    """A random matrix of ``n_samples`` blooms of density 0.3, row ids and
    a mask, drawn in the JAX entry's order."""
    blooms = [rng.random(m) < 0.3 for _ in range(n_samples)]
    matrix = BitSliceMatrix.create(blooms, m, n_samples)
    row_idx = rng.integers(0, m, size=(B, K, h)).astype(np.int32)
    mask = rng.random((B, K)) < 0.9
    return matrix, row_idx, mask


def entry(device=None):
    """-> (fn, example_args): the classic step from k-mers and the seq
    step from query bytes, on ``device`` (None: CUDA)."""
    dev = resolve_device(device)
    m, h, klen = 512, 3, 31
    B, K = 8, 64
    tile_rows, window = 16, 19
    num_tiles = m // tile_rows
    classic_step = make_full_query_step(m, h)

    def full_query_step(words, kmers, mask, cols, seqs, lens):
        classic = classic_step(words, kmers, mask)
        utile, gmask, n_valid, ok = seq_streams(
            seqs, lens, k=klen, s=klen - window + 1, num_tiles=num_tiles, h=h,
            tile_rows=tile_rows, r=window + 1, u_cap=16,
        )
        seq_counts, _ = cols_counts(cols, utile, gmask, n_valid)
        return classic, seq_counts, ok

    rng = np.random.default_rng(0)
    matrix, _, mask = _tiny_problem(rng, m=m, B=B, K=K, h=h)
    kmers = rng.choice(ACGT, size=(B, K, klen))
    L = 64 + klen - 1
    seqs = rng.choice(ACGT, size=(B, L))
    lens = np.full(B, L, dtype=np.int32)
    cols = rng.integers(0, 1 << 16, size=(num_tiles, 128), dtype=np.uint16)
    example_args = tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (matrix.words.view(np.int32), kmers, mask, cols.view(np.int16), seqs, lens)
    )
    return full_query_step, example_args
