"""Synthetic indexes drawn on the device, for smoke runs and benchmarks.

Sampling every bit of a full-size matrix in numpy takes minutes (m = 2.5e7
rows of 1,024 samples is 2.6e10 bits), so :func:`synth_index` draws the
bits with a seeded ``torch.Generator`` on its own device, a chunk of rows
at a time, and writes the packed words through the storage layer.
Planted samples are real blooms (``BIGSI.bloom``), so they use the
index's own layout and slot scheme, and every ``ksi:`` key is written, so
the index reopens with the scheme it was drawn for.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bigsi_tpu_torch.graph import BIGSI
from bigsi_tpu_torch.graph.metadata import SampleMetadata
from bigsi_tpu_torch.hashing.scheme import default_slot_scheme
from bigsi_tpu_torch.index.signature import persist_index_params
from bigsi_tpu_torch.kmers import seq_to_kmers
from bigsi_tpu_torch.matrix.bitmatrix import BitSliceMatrix
from bigsi_tpu_torch.storage import get_storage


def bloom_density(h: int, kmers_per_sample: int, m: int) -> float:
    """Expected share of set bits in a bloom of m bits holding that many
    k-mers under h hashes."""
    return 1.0 - math.exp(-h * kmers_per_sample / m)


def synth_index(
    config: dict,
    names: list[str],
    planted: list[str],
    density: float,
    generator: torch.Generator,
    chunk_rows: int = 1 << 18,
) -> None:
    """Write an index of ``len(names)`` samples into ``config``'s storage,
    replacing what was there.  Columns ``0 .. len(planted) - 1`` hold the
    blooms of the ``planted`` sequences; every other bit is set with
    probability ``density``, drawn from ``generator`` on its device."""
    m, h, k = config["m"], config["h"], config["k"]
    layout = config.get("layout", "classic")
    n = len(names)
    w = -(-n // 32)
    if len(planted) > n:
        raise ValueError("more planted sequences than samples")
    dev = generator.device
    cols = [
        torch.from_numpy(
            np.asarray(BIGSI.bloom(config, seq_to_kmers(s, k)), dtype=bool)
        ).to(dev)
        for s in planted
    ]
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    words = np.empty((m, w), dtype=np.uint32)
    for r0 in range(0, m, chunk_rows):
        r1 = min(m, r0 + chunk_rows)
        bits = torch.rand((r1 - r0, w * 32), generator=generator, device=dev) < density
        bits[:, n:] = False  # phantom columns of the last word
        for c, col in enumerate(cols):
            bits[:, c] = col[r0:r1]
        packed = (bits.view(r1 - r0, w, 32).to(torch.int32) << shifts).sum(
            -1, dtype=torch.int32)
        words[r0:r1] = packed.cpu().numpy().view(np.uint32)
    storage = get_storage(config)
    storage.delete_all()
    persist_index_params(
        storage.kv, m, h, layout=layout, tile_rows=config.get("tile-rows", 32),
        minimizer_window=config.get("minimizer-window"),
        slot_scheme=default_slot_scheme(layout, config), run_len=config.get("run-len"),
    )
    SampleMetadata(storage.kv).add_samples(list(names))
    storage.save_matrix(BitSliceMatrix(words, n))
