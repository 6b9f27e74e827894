"""Kernel L's strings form (``fused_lookup.presence_strings``) and the
facade's batched scoring against the JAX package.

The same inputs, made from seeded numpy, go through bigsi_tpu on the CPU
(its ``DeviceEngine.presence_matrix(and_rows(row_idx))`` per query, the
rows taken at the query's positions, ``[inverse]``, and the result
colour's column + 0x30) and through the port's wrapper on CPU tensors,
which runs the kernel's plain PyTorch version.  At tile_rows 64, where
the JAX engine's uint32 slot masks drop rows 32-63, the reference is
``HostEngine``.  Then the facade: scored ``search`` and ``search_batch``
on the port's ``DeviceEngine`` (device ``"cpu"``), with a staged insert
among the results, equal to bigsi_tpu's.  Outputs are bytes, so every
comparison is exact (tolerance zero).
"""

import numpy as np
import pytest
import torch

import bigsi_tpu
import bigsi_tpu_torch
from bigsi_tpu import storage as ref_storage
from bigsi_tpu.index import device_engine as jax_engine
from bigsi_tpu.index.host_engine import HostEngine as RefHostEngine
from bigsi_tpu.matrix.bitmatrix import BitSliceMatrix as RefMatrix
from bigsi_tpu_torch import storage
from bigsi_tpu_torch.index import device_engine
from bigsi_tpu_torch.index.device_engine import DeviceEngine
from bigsi_tpu_torch.index.host_engine import HostEngine
from bigsi_tpu_torch.kmers import seq_to_kmer_matrix, seq_to_kmers, unique_rows_with_inverse
from bigsi_tpu_torch.ops import fused_lookup, lookup

H = 3
SAMPLES = {1: 20, 4: 128, 33: 1050}  # W -> samples; 20 and 1,050 leave phantom samples
# name -> (source, tile_rows, bigsi_tpu DeviceEngine layout; None: its HostEngine)
SOURCES = {
    "classic": ("classic", 1, {}),
    "blocked16": ("slot", 16, {"layout": "blocked", "tile_rows": 16}),
    "minimizer8": ("cols", 8, {"layout": "minimizer", "tile_rows": 8}),
    "minimizer16": ("cols", 16, {"layout": "minimizer", "tile_rows": 16}),
    "minimizer32": ("cols", 32, {"layout": "minimizer", "tile_rows": 32}),
    "tile_rows64": ("slot", 64, None),
}
TILES = 11


def random_batch(rng, source, tile_rows, w, q, k):
    """A random matrix and Q queries of up to K distinct k-mers (the first
    query exactly K): row ids (tiled ones in one tile, at tile_rows 64
    half the queries' slots in rows 32-63), positions that visit every
    k-mer and some twice, and 0-3 results a query, every third query's
    last sample (beside the phantom ones) among them, in a shuffled
    order.  -> (words uint32[m, W], samples, [row ids], [positions],
    result queries, result colours)."""
    n = SAMPLES[w]
    m = 700 if source == "classic" else TILES * tile_rows
    words = rng.integers(0, 2**32, size=(m, w), dtype=np.uint32)
    if n % 32:  # phantom samples of the last word are zero
        words[:, -1] &= np.uint32((1 << (n % 32)) - 1)
    rows, positions, rq, rc = [], [], [], []
    for i in range(q):
        ki = k if i == 0 else int(rng.integers(1, k + 1))
        if source == "classic":
            rows.append(rng.integers(0, m, size=(ki, H)))
        else:
            low = 32 if tile_rows == 64 and i % 2 else 0
            tile = rng.integers(0, TILES, size=(ki, 1))
            rows.append(tile * tile_rows + rng.integers(low, tile_rows, size=(ki, H)))
        pos = np.concatenate([rng.permutation(ki), rng.integers(0, ki, size=ki // 3 + 1)])
        positions.append(rng.permutation(pos))
        colours = list(rng.choice(n, size=int(rng.integers(0, 4)), replace=False))
        if i % 3 == 0 and n - 1 not in colours:
            colours.append(n - 1)
        rq += [i] * len(colours)
        rc += colours
    order = rng.permutation(len(rq))
    return (words, n, rows, positions, np.array(rq, dtype=np.int64)[order],
            np.array(rc, dtype=np.int64)[order])


def i32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def wrapper_args(words, source, tile_rows, rows, positions, rq, rc):
    """The wrapper's arguments on CPU tensors."""
    mat = torch.from_numpy(words.view(np.int32))
    matrix = lookup.pack_tile_cols(mat, tile_rows) if source == "cols" else mat
    return (matrix, source, i32(np.concatenate(rows)),
            i32(np.cumsum([0] + [r.shape[0] for r in rows])), i32(np.concatenate(positions)),
            i32(np.cumsum([0] + [p.size for p in positions])), i32(rq), i32(rc))


def reference_strings(words, n, spec, rows, positions, rq, rc) -> list[bytes]:
    """bigsi_tpu's presence rows of each query, at its positions, the
    result colour's column + 0x30."""
    ref = RefMatrix(words, n)
    engine = RefHostEngine(ref) if spec is None else jax_engine.DeviceEngine(ref, **spec)
    x = [engine.presence_matrix(engine.and_rows(r), n) for r in rows]
    return [(x[q][positions[q]][:, c].astype(np.uint8) + 0x30).tobytes() for q, c in zip(rq, rc)]


def run_wrapper(matrix, source, rows, kmer_off, pos_kmer, pos_off, rq, rc, tile_rows=1):
    """The wrapper with the caller's offsets and output, as the engine
    passes them (the output filled with 0xEE first)."""
    res_off = lookup.string_offsets(pos_off, rq)
    out = torch.full((int(res_off[-1]),), 0xEE, dtype=torch.uint8)
    got, off = fused_lookup.presence_strings(matrix, source, rows, kmer_off, pos_kmer, pos_off,
                                             rq, rc, tile_rows, res_off=res_off, out=out)
    assert got is out and off is res_off
    return got, off


def split(out: torch.Tensor, res_off: torch.Tensor) -> list[bytes]:
    data, off = out.numpy().tobytes(), res_off.tolist()
    return [data[a:b] for a, b in zip(off, off[1:])]


@pytest.mark.parametrize("q,k", [(1, 1), (1, 300), (40, 1), (40, 300)])
@pytest.mark.parametrize("w", sorted(SAMPLES))
@pytest.mark.parametrize("name", sorted(SOURCES))
def test_strings_match_jax_package(name, w, q, k):
    source, tile_rows, spec = SOURCES[name]
    rng = np.random.default_rng([len(name), tile_rows, w, q, k])
    words, n, rows, positions, rq, rc = random_batch(rng, source, tile_rows, w, q, k)
    assert rq.size > 0
    args = wrapper_args(words, source, tile_rows, rows, positions, rq, rc)
    out, res_off = run_wrapper(*args, tile_rows)
    assert out.dtype == torch.uint8 and res_off.dtype == torch.int64
    assert split(out, res_off) == reference_strings(words, n, spec, rows, positions, rq, rc)


def test_no_results_gives_empty_strings():
    rng = np.random.default_rng(3)
    words, _, rows, positions, _, _ = random_batch(rng, "classic", 1, 4, 5, 20)
    none = np.zeros(0, dtype=np.int64)
    out, res_off = run_wrapper(*wrapper_args(words, "classic", 1, rows, positions, none, none))
    assert out.shape == (0,) and res_off.tolist() == [0]


WORDS = torch.zeros((64, 2), dtype=torch.int32)
ROWS = torch.zeros((4, 3), dtype=torch.int32)
OFF = torch.tensor([0, 4], dtype=torch.int32)
POS = torch.arange(4, dtype=torch.int32)
RES = torch.zeros(2, dtype=torch.int32)


def strings(matrix=WORDS, source="classic", rows=ROWS, kmer_off=OFF, pos_kmer=POS,
            pos_off=OFF, res_query=RES, res_colour=RES, tile_rows=1,
            res_off=torch.tensor([0, 4, 8]), out=torch.empty(8, dtype=torch.uint8)):
    return fused_lookup.presence_strings(matrix, source, rows, kmer_off, pos_kmer, pos_off,
                                         res_query, res_colour, tile_rows, res_off=res_off,
                                         out=out)


@pytest.mark.parametrize("call,error", [
    (lambda: strings(source="fat"), ValueError),
    (lambda: strings(matrix=WORDS.long()), TypeError),
    (lambda: strings(rows=ROWS.long()), TypeError),
    (lambda: strings(rows=POS), ValueError),
    (lambda: strings(kmer_off=OFF[:1]), ValueError),
    (lambda: strings(pos_off=OFF.long()), TypeError),
    (lambda: strings(pos_kmer=POS[None]), ValueError),
    (lambda: strings(res_colour=RES[:1]), ValueError),
    (lambda: strings(res_query=RES.to("meta")), ValueError),
    (lambda: strings(source="slot", tile_rows=48), ValueError),
    (lambda: strings(source="slot", tile_rows=0), ValueError),
    (lambda: strings(matrix=torch.zeros((8, 32), dtype=torch.uint8), source="cols",
                     tile_rows=16), ValueError),
    (lambda: strings(matrix=WORDS.float(), source="cols", tile_rows=8), TypeError),
    (lambda: strings(matrix=WORDS.t()), ValueError),
    (lambda: strings(res_off=torch.tensor([0, 3, 8])), ValueError),
    (lambda: strings(res_off=torch.tensor([0, 8])), ValueError),
    (lambda: strings(out=torch.empty(7, dtype=torch.uint8)), ValueError),
    (lambda: strings(out=torch.empty(8)), TypeError),
], ids=["source", "matrix-dtype", "rows-dtype", "rows-shape", "kmer-off-shape",
        "pos-off-dtype", "pos-kmer-shape", "colour-shape", "mixed-devices", "tile-rows-64",
        "tile-rows-0", "cols-tile-rows", "cols-dtype", "not-contiguous", "res-off-values",
        "res-off-shape", "out-size", "out-dtype"])
def test_wrapper_checks_its_arguments(call, error):
    with pytest.raises(error):
        call()


# -- the facade ----------------------------------------------------------------


def random_seq(rng, n):
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])


def mutate(rng, seq, snps):
    s = list(seq)
    for i in rng.choice(len(s), size=snps, replace=False):
        s[i] = "ACGT"[("ACGT".index(s[i]) + 1) % 4]
    return "".join(s)


FACADE = [("classic", None, "tpu"), ("blocked", 16, "tpu"), ("minimizer", 8, "tpu"),
          ("minimizer", 16, "tpu"), ("minimizer", 32, "tpu"), ("minimizer", 64, "numpy")]


def both_indexes(layout, tile_rows, reference, rng, tag, port_engine=None):
    """40 samples in 8 families, every other member a copy with one SNP
    (so a query hits several samples, in both words), built by each
    package into its own memory index, and a 41st sample (a copy of
    sample 0) inserted into both: staged, a side column.  The port's
    index is opened on its DeviceEngine (device "cpu"), or on
    ``port_engine`` where given.  -> (port, reference, genomes)."""
    config = {"storage-engine": "memory",
              "storage-config": {"filename": "ts-%s-%s-%s" % (tag, layout, tile_rows)},
              "k": 31, "m": 8192, "h": 3, "layout": layout}
    if tile_rows:
        config["tile-rows"] = tile_rows
    for store in (ref_storage, storage):
        store.get_storage(config).delete_all()
    roots = [random_seq(rng, 300) for _ in range(8)]
    genomes = [mutate(rng, roots[i % 8], (i // 8) % 2) for i in range(40)]
    names = ["s%d" % i for i in range(len(genomes))]
    kmers = [list(seq_to_kmers(g, 31)) for g in genomes]
    bigsi_tpu.BIGSI.build(config, [bigsi_tpu.BIGSI.bloom(config, km) for km in kmers], names)
    port = bigsi_tpu_torch.BIGSI.build(
        config, [bigsi_tpu_torch.BIGSI.bloom(config, km) for km in kmers], names, device="cpu")
    if port_engine is not None:
        port = bigsi_tpu_torch.BIGSI(dict(config, engine=port_engine))
    ref = bigsi_tpu.BIGSI(dict(config, engine=reference))
    new = list(seq_to_kmers(genomes[0], 31))
    port.insert(bigsi_tpu_torch.BIGSI.bloom(config, new), "staged")
    ref.insert(bigsi_tpu.BIGSI.bloom(config, new), "staged")
    assert port.side is not None
    assert isinstance(port.engine, DeviceEngine) == (port_engine is None)
    return port, ref, genomes


@pytest.fixture
def engine_calls(monkeypatch):
    """The facade's calls of DeviceEngine.presence_strings (their colour
    lists) and of the wrappers of kernel L's two forms."""
    calls = {"engine": [], "strings": 0, "rows": 0}
    real = DeviceEngine.presence_strings

    def engine(self, rows, inverses, colours, n):
        calls["engine"].append([list(c) for c in colours])
        return real(self, rows, inverses, colours, n)

    def count(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(DeviceEngine, "presence_strings", engine)
    monkeypatch.setattr(device_engine, "presence_strings",
                        count("strings", fused_lookup.presence_strings))
    monkeypatch.setattr(device_engine, "presence_rows",
                        count("rows", fused_lookup.presence_rows))
    return calls


@pytest.mark.parametrize("layout,tile_rows,reference", FACADE)
def test_scored_facade_matches_jax_package(layout, tile_rows, reference, engine_calls):
    """Scored search and search_batch at 0.7 and 1.0 equal bigsi_tpu's,
    with several results a query in both words and the staged sample
    among them; a batch's strings come from one engine call, the staged
    colour's from the side shard."""
    rng = np.random.default_rng([len(layout), tile_rows or 0])
    port, ref, genomes = both_indexes(layout, tile_rows, reference, rng, "f")
    queries = [genomes[0][:200], genomes[9], genomes[20][40:260], random_seq(rng, 200),
               genomes[3][:20], genomes[7]]
    for t in (0.7, 1.0):
        for q in queries:
            assert port.search(q, t, score=True) == ref.search(q, t, score=True)
        calls = len(engine_calls["engine"])
        got = port.search_batch(queries, t, score=True)
        assert got == ref.search_batch(queries, t, score=True)
        assert len(engine_calls["engine"]) == calls + 1
        colours = [c for cs in engine_calls["engine"][-1] for c in cs]
        assert len(colours) >= 8 and max(colours) >= 32, "results in both words"
        assert any(d["sample_name"] == "staged" and "kmer-presence" in d
                   for r in got for d in r), "the staged sample scored"
    assert engine_calls["strings"] == sum(1 for cs in engine_calls["engine"] if any(cs))
    assert engine_calls["rows"] == 0


@pytest.mark.parametrize("layout,tile_rows,reference", FACADE[:2])
def test_batch_without_hits_scores_nothing(layout, tile_rows, reference, engine_calls):
    """A scored batch with no hit query asks the engine for nothing and
    launches neither form of kernel L; the engine, given no colours,
    touches no tensor."""
    rng = np.random.default_rng(11)
    port, ref, _ = both_indexes(layout, tile_rows, reference, rng, "n")
    queries = [random_seq(rng, 150) for _ in range(4)]
    got = port.search_batch(queries, 1.0, score=True)
    assert got == ref.search_batch(queries, 1.0, score=True) == [[]] * 4
    uniq = unique_rows_with_inverse(seq_to_kmer_matrix(queries[0], 31))
    rows = port.kmer_matrix_to_row_idx(uniq[0])
    assert port.engine.presence_strings([rows, rows], [uniq[1]] * 2, [[], []], 41) == [[], []]
    assert engine_calls == {"engine": [[[], []]], "strings": 0, "rows": 0}


@pytest.mark.parametrize("layout,tile_rows", [("classic", None), ("blocked", 16)])
def test_scored_search_gathers_once_on_host_engine(layout, tile_rows, monkeypatch):
    """On an engine without a batched strings form (``engine: numpy``), a
    scored search scores from the AND-ed rows and staged presence that
    its filter already gathered: one ``and_rows`` and one side-shard
    gather a query, results equal to bigsi_tpu's."""
    rng = np.random.default_rng([7, tile_rows or 0])
    port, ref, genomes = both_indexes(layout, tile_rows, "numpy", rng, "h", "numpy")
    assert isinstance(port.engine, HostEngine)
    calls = {"and_rows": 0, "side": 0}
    and_rows, side = port.engine.and_rows, port.side.presence

    def count(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    monkeypatch.setattr(port.engine, "and_rows", count("and_rows", and_rows))
    monkeypatch.setattr(port.side, "presence", count("side", side))
    for t in (0.7, 1.0):
        got = port.search(genomes[0][:200], t, score=True)
        assert got == ref.search(genomes[0][:200], t, score=True)
        assert any(d["sample_name"] == "staged" and "kmer-presence" in d for d in got)
        assert len(got) >= 2
    assert calls == {"and_rows": 2, "side": 2}
