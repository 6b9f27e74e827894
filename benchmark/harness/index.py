"""The benchmark's own index: drawn from the seed on the device, planted
with known sequences, and written into the program's in-memory storage.

Background bits are drawn on the device, a chunk of rows at a time, at
density 49/128 (0.3828, a bloom of about 4.0 million k-mers at m = 2.5e7
and h = 3): each word is the AND/OR of seven random words, which costs
7 random bits a bit instead of a float32 draw and a compare.  The words
come back to host memory that is pinned for the copy (CUDA), and the
planted samples' bits are ORed in on the host, at the rows the frozen
reference hashing gives (``reference/<rows>.py``), so the reference and
the index agree by construction and no code of the program draws them.
"""

from __future__ import annotations

import dataclasses
import importlib
import time

import numpy as np
import torch

# 49/128 = 0.0110001 in binary: from the lowest set bit up, OR for a 1 and
# AND for a 0 halves or doubles the density; the first draw is the 1/128 bit
DENSITY_OPS = "&&&||&"
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
CHUNK_BYTES = 1 << 28  # device bytes of one chunk of drawn words


@dataclasses.dataclass
class Index:
    words: np.ndarray  # uint32[m, W], the whole matrix, host memory
    names: list[str]
    sources: list[str]  # the planted sequences' sources (queries come from them)
    port_config: dict
    synth_s: float
    pinned: object = None  # the tensor that owns the words' pinned memory, if any
    phases: dict = dataclasses.field(default_factory=dict)  # seconds of each set-up step


def random_seq(rng: np.random.Generator, n: int) -> np.ndarray:
    return BASES[rng.integers(0, 4, n)]


def mutate(rng: np.random.Generator, seq: np.ndarray, rate: float) -> np.ndarray:
    """A copy of ASCII ``seq`` with round(rate * len) SNPs at distinct
    positions, each to another base."""
    out = seq.copy()
    n = int(round(rate * len(seq)))
    if n:
        pos = rng.choice(len(seq), size=n, replace=False)
        code = np.searchsorted(BASES, out[pos])  # BASES is sorted: A C G T
        out[pos] = BASES[(code + rng.integers(1, 4, n)) % 4]
    return out


def host_words(m: int, w: int, pin: bool) -> tuple[np.ndarray, object]:
    """uint32[m, w] in host memory, pinned with ``pin`` (CUDA), so that the
    drawn words come back at the link's rate; -> (words, the tensor that
    owns pinned memory, or None).  Populating 25.6 GB of pages costs
    seconds whichever way: one pinned allocation was the fastest of those
    tried on the card's host (``PERF.md``)."""
    if not pin:
        return np.empty((m, w), dtype=np.uint32), None
    owner = torch.empty(m * w, dtype=torch.int32, pin_memory=True)
    return owner.numpy().view(np.uint32).reshape(m, w), owner


def draw_words(m: int, w: int, gen: torch.Generator, out: np.ndarray) -> None:
    """Fill ``out`` (uint32[m, w], pinned or plain host memory) with bits
    of density 49/128 drawn on ``gen``'s device."""
    dev = gen.device
    host = torch.from_numpy(out.view(np.int32))
    rows = max(1, CHUNK_BYTES // (4 * w))
    lo, hi = -(1 << 31), 1 << 31
    for r0 in range(0, m, rows):
        shape = (min(m, r0 + rows) - r0, w)
        acc = torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32, device=dev)
        for op in DENSITY_OPS:
            x = torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32, device=dev)
            if op == "&":
                acc.bitwise_and_(x)
            else:
                acc.bitwise_or_(x)
        host[r0:r0 + shape[0]].copy_(acc, non_blocking=dev.type == "cuda")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def synthesize(spec: dict, seed: int, device: str) -> Index:
    """The index of configuration ``spec`` (``configs/<name>.json``) drawn
    from ``seed`` on ``device``, written into the program's memory
    storage under the configuration's name."""
    from bigsi_tpu_torch.graph.metadata import SampleMetadata
    from bigsi_tpu_torch.index.signature import persist_index_params
    from bigsi_tpu_torch.matrix.bitmatrix import BitSliceMatrix
    from bigsi_tpu_torch.storage import get_storage

    t0 = time.perf_counter()
    idx = spec["index"]
    m, n = idx["m"], spec["samples"]
    w = -(-n // 32)
    plant = spec["planted"]
    rng = np.random.default_rng([seed, 1])
    sources = [random_seq(rng, plant["source_len"]) for _ in range(plant["sources"])]
    planted = [mutate(rng, s, rate) for s in sources for rate in plant["snp_rates"]]
    names = ["planted%d_%d" % (i // len(plant["snp_rates"]), i % len(plant["snp_rates"]))
             for i in range(len(planted))] + ["sample%d" % c for c in range(len(planted), n)]
    port_config = dict(idx, **{"storage-engine": "memory",
                               "storage-config": {"filename": "benchmark-" + spec["name"]}})
    storage = get_storage(port_config)
    storage.delete_all()  # an index made before under this name frees its memory first
    phases = {}
    words, pinned = host_words(m, w, torch.device(device).type == "cuda")
    phases["host_memory_s"] = time.perf_counter() - t0
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    draw_words(m, w, gen, words)
    phases["draw_s"] = time.perf_counter() - t0 - phases["host_memory_s"]
    if n % 32:
        words[:, -1] &= np.uint32((1 << (n % 32)) - 1)  # no bits past the last sample
    rows_of = importlib.import_module("benchmark.reference." + spec["reference"]).position_rows
    for c, seq in enumerate(planted):
        _, rows = rows_of(seq.tobytes().decode("ascii"), idx)
        words[np.unique(rows), c // 32] |= np.uint32(1 << (c % 32))
    persist_index_params(
        storage.kv, m, idx["h"], layout=idx["layout"], tile_rows=idx.get("tile-rows", 32),
        minimizer_window=idx.get("minimizer-window"), slot_scheme=idx.get("slot-scheme"),
        run_len=idx.get("run-len"),
    )
    SampleMetadata(storage.kv).add_samples(names)
    storage.save_matrix(BitSliceMatrix(words, n))
    total = time.perf_counter() - t0
    phases["plant_store_s"] = total - phases["host_memory_s"] - phases["draw_s"]
    return Index(words, names, [s.tobytes().decode("ascii") for s in sources], port_config,
                 total, pinned, phases)
