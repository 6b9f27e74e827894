"""Scoring's presence rows (kernel L, ``fused_lookup.presence_rows``)
against the JAX package.

The same inputs, made from seeded numpy, go through bigsi_tpu's
``DeviceEngine`` on the CPU (its jitted programs ``_and_rows_fat``,
``_blocked_and`` and ``_cols_and``) and through the port's wrapper on CPU
tensors, which runs the kernel's plain PyTorch version.  At tile_rows 64,
where the JAX engine's uint32 slot masks drop rows 32-63, the port is
held to ``HostEngine``.  Then the engines that score: the port's
``DeviceEngine`` (device ``"cpu"``) through the facade, the mesh engine
on 8 positions of ``"cpu"`` and the fleet's presence op, each equal to
the single-device engine.  Outputs are bit words, so every comparison is
exact (tolerance zero).
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
from bigsi_tpu_torch.index.device_engine import DeviceEngine, tile_streams
from bigsi_tpu_torch.kmers import seq_to_kmers
from bigsi_tpu_torch.matrix.bitmatrix import BitSliceMatrix
from bigsi_tpu_torch.ops import fused_lookup, lookup
from bigsi_tpu_torch.parallel import distributed
from bigsi_tpu_torch.parallel import sharding as sh

H = 3
SAMPLES = {1: 20, 4: 128, 33: 1050}  # W -> samples; 20 and 1,050 leave phantom samples
KS = [1, 37, 300]


def random_matrices(rng, m, n):
    """The same random bits as the port's and bigsi_tpu's matrix."""
    w = -(-n // 32)
    words = rng.integers(0, 2**32, size=(m, w), dtype=np.uint32)
    if n % 32:  # phantom samples of the last word are zero
        words[:, -1] &= np.uint32((1 << (n % 32)) - 1)
    return BitSliceMatrix(words, n), RefMatrix(words, n)


def tiled_rows(rng, k, num_tiles, tile_rows, h=H, low=0):
    """Row ids int32[K, h] whose h rows lie in one tile (slots in [low,
    tile_rows)), tiles in runs as the minimizer layout makes them."""
    tile = rng.integers(0, num_tiles, size=k)
    tile[1::3] = tile[0::3][: tile[1::3].shape[0]]
    slots = rng.integers(low, tile_rows, size=(k, h))
    return (tile[:, None] * tile_rows + slots).astype(np.int32)


def streams(row_idx: np.ndarray, tile_rows: int):
    idx = torch.from_numpy(row_idx)
    return tile_streams(idx, torch.ones(idx.shape[0], dtype=torch.bool), tile_rows)


def jax_rows(ref_matrix, row_idx, **layout) -> np.ndarray:
    """uint32[K, W]: bigsi_tpu's DeviceEngine presence program (its tile
    layouts may pad the word axis; the padding is cut)."""
    packed = jax_engine.DeviceEngine(ref_matrix, **layout).and_rows(row_idx)
    return np.asarray(packed.rows[: row_idx.shape[0], : ref_matrix.num_words])


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def bits(rows: np.ndarray, n: int) -> np.ndarray:
    return np.unpackbits(rows.view(np.uint8), axis=-1, bitorder="little")[:, :n]


# -- presence_rows (plain) against the JAX programs --------------------------


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("w", sorted(SAMPLES))
def test_classic_source_matches_and_rows_fat(w, k):
    rng = np.random.default_rng(w * 1000 + k)
    mat, ref_mat = random_matrices(rng, 700, SAMPLES[w])
    row_idx = rng.integers(0, 700, size=(k, H)).astype(np.int32)
    got = fused_lookup.presence_rows(torch.from_numpy(mat.words.view(np.int32)), "classic",
                                     torch.from_numpy(row_idx))
    assert got.dtype == torch.int32 and got.shape == (k, w)
    np.testing.assert_array_equal(u32(got), jax_rows(ref_mat, row_idx))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("w", sorted(SAMPLES))
@pytest.mark.parametrize("tile_rows", [8, 16, 32])
def test_slot_source_matches_blocked_and(tile_rows, w, k):
    rng = np.random.default_rng(tile_rows * 10000 + w * 1000 + k)
    num_tiles = 23
    mat, ref_mat = random_matrices(rng, num_tiles * tile_rows, SAMPLES[w])
    row_idx = tiled_rows(rng, k, num_tiles, tile_rows)
    tile, smask = streams(row_idx, tile_rows)
    got = fused_lookup.presence_rows(torch.from_numpy(mat.words.view(np.int32)), "slot", tile,
                                     smask, tile_rows)
    want = jax_rows(ref_mat, row_idx, layout="blocked", tile_rows=tile_rows)
    np.testing.assert_array_equal(u32(got), want)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("w", sorted(SAMPLES))
@pytest.mark.parametrize("tile_rows", [8, 16, 32])
def test_cols_source_matches_cols_and(tile_rows, w, k):
    """Each cols type (uint8, int16, int32); phantom samples come out 0."""
    rng = np.random.default_rng(tile_rows * 20000 + w * 1000 + k)
    num_tiles = 19
    mat, ref_mat = random_matrices(rng, num_tiles * tile_rows, SAMPLES[w])
    row_idx = tiled_rows(rng, k, num_tiles, tile_rows)
    tile, smask = streams(row_idx, tile_rows)
    cols = lookup.pack_tile_cols(torch.from_numpy(mat.words.view(np.int32)), tile_rows)
    assert cols.dtype == lookup.cols_dtype(tile_rows)
    got = fused_lookup.presence_rows(cols, "cols", tile, smask)
    want = jax_rows(ref_mat, row_idx, layout="minimizer", tile_rows=tile_rows)
    np.testing.assert_array_equal(u32(got), want)
    n = SAMPLES[w]
    if n % 32:
        assert not (u32(got)[:, -1] >> np.uint32(n % 32)).any()


@pytest.mark.parametrize("source", ["slot", "cols"])
def test_mask_zero_gives_all_ones(source):
    """A slot mask of 0 selects no row: the AND identity, phantom samples
    included, as the JAX programs give it."""
    rng = np.random.default_rng(5)
    mat, _ = random_matrices(rng, 10 * 16, 40)
    words = torch.from_numpy(mat.words.view(np.int32))
    matrix = words if source == "slot" else lookup.pack_tile_cols(words, 16)
    tile = torch.tensor([3, 7], dtype=torch.int32)
    smask = torch.tensor([0, 0], dtype=torch.int64)
    got = fused_lookup.presence_rows(matrix, source, tile, smask, 16)
    assert (u32(got) == 0xFFFFFFFF).all()


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("w", sorted(SAMPLES))
def test_slot_source_at_tile_rows_64_matches_host_engine(w, k):
    rng = np.random.default_rng(64000 + w * 1000 + k)
    num_tiles, n = 7, SAMPLES[w]
    mat, ref_mat = random_matrices(rng, num_tiles * 64, n)
    row_idx = tiled_rows(rng, k, num_tiles, 64, low=16)  # many in rows 32-63
    tile, smask = streams(row_idx, 64)
    got = fused_lookup.presence_rows(torch.from_numpy(mat.words.view(np.int32)), "slot", tile,
                                     smask, 64)
    host = RefHostEngine(ref_mat)
    np.testing.assert_array_equal(bits(u32(got), n),
                                  host.presence_matrix(host.and_rows(row_idx), n))


@pytest.mark.parametrize("slabs", [2, 3])
@pytest.mark.parametrize("source,tile_rows", [("slot", 16), ("slot", 64), ("cols", 8),
                                              ("cols", 32)])
def test_window_gives_zero_outside_and_slabs_or_to_the_whole(source, tile_rows, slabs):
    """Each slab of whole tiles with its window: the whole's rows where
    the k-mer's tile lies in it, 0 elsewhere; the slabs' rows ORed are
    the whole's."""
    rng = np.random.default_rng(tile_rows * slabs)
    per, n = 5, 70
    mat, _ = random_matrices(rng, per * slabs * tile_rows, n)
    words = torch.from_numpy(mat.words.view(np.int32))
    row_idx = tiled_rows(rng, 60, per * slabs, tile_rows)
    tile, smask = streams(row_idx, tile_rows)
    matrix = words if source == "slot" else lookup.pack_tile_cols(words, tile_rows)
    rows_per = per * tile_rows if source == "slot" else per
    whole = fused_lookup.presence_rows(matrix, source, tile, smask, tile_rows)
    joined = torch.zeros_like(whole)
    for q in range(slabs):
        slab = matrix[q * rows_per: (q + 1) * rows_per]
        part = fused_lookup.presence_rows(slab, source, tile, smask, tile_rows,
                                          window=(q * per, (q + 1) * per))
        here = ((tile >= q * per) & (tile < (q + 1) * per))[:, None]
        assert here.any() and (~here).any()
        np.testing.assert_array_equal(u32(part), u32(torch.where(here, whole, 0)))
        joined |= part
    np.testing.assert_array_equal(u32(joined), u32(whole))


WORDS = torch.zeros((64, 2), dtype=torch.int32)
TILE = torch.zeros(4, dtype=torch.int32)
SMASK = torch.ones(4, dtype=torch.int64)
ROWS = torch.zeros((4, 3), dtype=torch.int32)


@pytest.mark.parametrize("call,error", [
    (lambda: fused_lookup.presence_rows(WORDS, "fat", ROWS), ValueError),
    (lambda: fused_lookup.presence_rows(WORDS.long(), "classic", ROWS), TypeError),
    (lambda: fused_lookup.presence_rows(WORDS, "classic", ROWS.long()), TypeError),
    (lambda: fused_lookup.presence_rows(WORDS, "classic", TILE), ValueError),
    (lambda: fused_lookup.presence_rows(WORDS, "classic", ROWS, window=(0, 1)), ValueError),
    (lambda: fused_lookup.presence_rows(WORDS, "slot", TILE, SMASK.int(), 16), TypeError),
    (lambda: fused_lookup.presence_rows(WORDS, "slot", TILE, SMASK[:3], 16), ValueError),
    (lambda: fused_lookup.presence_rows(WORDS, "slot", TILE, None, 16), TypeError),
    (lambda: fused_lookup.presence_rows(WORDS, "slot", TILE, SMASK, 48), ValueError),
    (lambda: fused_lookup.presence_rows(WORDS, "slot", TILE, SMASK, 16, (0, 5)), ValueError),
    (lambda: fused_lookup.presence_rows(WORDS, "slot", TILE, SMASK, 16, (3, 2)), ValueError),
    (lambda: fused_lookup.presence_rows(WORDS.float(), "cols", TILE, SMASK), TypeError),
    (lambda: fused_lookup.presence_rows(WORDS[:, :1].contiguous().to(torch.uint8), "cols",
                                        TILE, SMASK), TypeError),
    (lambda: fused_lookup.presence_rows(WORDS.to("meta"), "classic", ROWS.to("meta")),
     ValueError),
    (lambda: fused_lookup.presence_rows(WORDS, "classic", ROWS.to("meta")), ValueError),
    (lambda: fused_lookup.presence_rows(WORDS.t(), "classic", ROWS), ValueError),
], ids=["source", "matrix-dtype", "rows-dtype", "rows-shape", "classic-window", "smask-dtype",
        "smask-shape", "smask-missing", "tile-rows", "window-wide", "window-order", "cols-dtype",
        "cols-width", "meta-device", "mixed-devices", "not-contiguous"])
def test_wrapper_checks_its_arguments(call, error):
    with pytest.raises(error):
        call()


def test_empty_rows():
    out = fused_lookup.presence_rows(WORDS, "slot", TILE[:0], SMASK[:0], 16)
    assert out.shape == (0, 2) and out.dtype == torch.int32


# -- the engines that score ----------------------------------------------------


def build_both(config, genomes):
    """Each package blooms the same k-mers into its own memory index."""
    for store in (ref_storage, storage):
        store.get_storage(config).delete_all()
    kmers = [list(seq_to_kmers(g, config["k"])) for g in genomes]
    names = ["s%d" % i for i in range(len(genomes))]
    bigsi_tpu.BIGSI.build(config, [bigsi_tpu.BIGSI.bloom(config, km) for km in kmers], names)
    bigsi_tpu_torch.BIGSI.build(config, [bigsi_tpu_torch.BIGSI.bloom(config, km)
                                         for km in kmers], names, device="cpu")


def random_seq(rng, n):
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])


@pytest.fixture
def presence_calls(monkeypatch):
    """Counts the engines' calls of the kernel L wrapper."""
    calls = []
    real = fused_lookup.presence_rows

    def spy(*args, **kw):
        calls.append(args[1])
        return real(*args, **kw)

    for module in (device_engine, sh, distributed):
        monkeypatch.setattr(module, "presence_rows", spy)
    return calls


@pytest.mark.parametrize("layout,tile_rows,reference", [
    ("classic", None, "tpu"), ("blocked", 16, "tpu"), ("minimizer", 8, "tpu"),
    ("minimizer", 16, "tpu"), ("minimizer", 32, "tpu"), ("minimizer", 64, "numpy"),
    ("blocked", 64, "numpy")])
def test_scored_search_matches_jax_package(layout, tile_rows, reference, presence_calls):
    """Scored search and search_batch on the port's DeviceEngine equal
    bigsi_tpu's on its JAX engine (the host engine at tile_rows 64):
    kernel L's wrapper runs once per scored search of a query with
    k-mers and once per hit query of a scored search_batch, with the
    layout's source."""
    rng = np.random.default_rng(len(layout) * 100 + (tile_rows or 0))
    config = {"storage-engine": "memory",
              "storage-config": {"filename": "tp-%s-%s" % (layout, tile_rows)},
              "k": 31, "m": 8192, "h": 3, "layout": layout}
    if tile_rows:
        config["tile-rows"] = tile_rows
    genomes = [random_seq(rng, 300) for _ in range(10)]
    build_both(config, genomes)
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    assert isinstance(port.engine, DeviceEngine)
    ref = bigsi_tpu.BIGSI(dict(config, engine=reference))
    queries = [genomes[0], genomes[1][:120], genomes[2][50:250], random_seq(rng, 150),
               genomes[3][:20]]
    for q in queries:
        assert port.search(q, 0.7, score=True) == ref.search(q, 0.7, score=True)
    if layout == "minimizer":
        want = "cols" if tile_rows <= 32 else "slot"
    else:
        want = "classic" if layout == "classic" else "slot"
    assert presence_calls == [want] * 4  # every query with k-mers, hits or none
    del presence_calls[:]
    got = port.search_batch(queries, 0.7, score=True)
    assert got == ref.search_batch(queries, 0.7, score=True)
    assert presence_calls == [want] * sum(1 for r in got if r)


def mesh_and_single(layout, tile_rows, axes, rng):
    """A random matrix on the mesh engine (8 positions of "cpu") and on
    the single-device engine; -> (mesh, single, row ids, samples)."""
    m, n = 40 * tile_rows, 300  # W 10: padded to 12 words on s = 4
    mat, _ = random_matrices(rng, m, n)
    kw = {"layout": layout, "tile_rows": tile_rows}
    row_shards = axes[3] if len(axes) > 3 else 1
    mesh = sh.MeshEngine(mat, mesh=sh.make_mesh(8, axes[:3], devices=["cpu"] * 8),
                         row_shards=row_shards, devices=["cpu"] * 8, **kw)
    single = DeviceEngine(mat, device="cpu", **kw)
    if layout == "classic":
        row_idx = rng.integers(0, m, size=(57, H)).astype(np.int32)
    else:
        row_idx = tiled_rows(rng, 57, 40, tile_rows, low=tile_rows // 4)
    return mesh, single, row_idx, n


@pytest.mark.parametrize("layout,tile_rows,axes,launches", [
    ("classic", 32, (2, 1, 4), 4), ("blocked", 16, (2, 2, 2), 2),
    ("minimizer", 16, (1, 2, 4), 4), ("minimizer", 8, (2, 1, 4), 4),
    ("minimizer", 64, (2, 2, 2), 2), ("minimizer", 16, (1, 2, 2, 2), 4),
    ("minimizer", 64, (1, 1, 2, 4), 8)],
    ids=["classic", "blocked16", "cols16", "cols8", "tr64", "slabs16", "slabs64"])
def test_mesh_presence_matches_single_device(layout, tile_rows, axes, launches,
                                             presence_calls):
    """One launch per sample shard, or per row slab of each."""
    mesh, single, row_idx, n = mesh_and_single(layout, tile_rows, axes,
                                               np.random.default_rng(len(axes) * tile_rows))
    got = mesh.presence_matrix(mesh.and_rows(row_idx), n)
    assert len(presence_calls) == launches
    np.testing.assert_array_equal(got, single.presence_matrix(single.and_rows(row_idx), n))


@pytest.mark.parametrize("layout,tile_rows,axes,row_shards,per_rank", [
    ("classic", 32, (2, 1, 2), 1, 1), ("minimizer", 16, (1, 1, 4), 1, 2),
    ("minimizer", 16, (1, 1, 2), 2, 2), ("minimizer", 64, (1, 1, 2), 4, 4)],
    ids=["classic", "minimizer16", "slabs16", "slabs64"])
def test_fleet_presence_matches_single_device(layout, tile_rows, axes, row_shards, per_rank,
                                              presence_calls, monkeypatch):
    """The fleet's presence op with both ranks' parts run in this process
    (each rank's service built as that rank, the gather replaced by the
    list of parts): equal to the single-device engine, with one launch
    per local sample shard or row slab on each rank."""
    rng = np.random.default_rng(tile_rows * row_shards)
    m, n = 24 * tile_rows, 300
    mat, _ = random_matrices(rng, m, n)
    gmesh = distributed.make_global_mesh(axes, world=2, device="cpu")
    services = []
    for rank in (0, 1):
        monkeypatch.setattr(distributed, "_process_group", lambda rank=rank: (rank, 2))
        services.append(distributed.DistributedQueryService(
            mat.words, gmesh, m=m, layout=layout, tile_rows=tile_rows, row_shards=row_shards,
            device="cpu"))
    monkeypatch.setattr(services[0], "_dispatch", lambda op, arrays, k=0, h=0: [
        svc._part(op, arrays, k, h) for svc in services])
    if layout == "classic":
        row_idx = rng.integers(0, m, size=(45, H)).astype(np.int32)
    else:
        row_idx = tiled_rows(rng, 45, 24, tile_rows, low=tile_rows // 4)
    got = services[0].presence(row_idx)
    assert len(presence_calls) == 2 * per_rank
    single = DeviceEngine(mat, device="cpu", layout=layout, tile_rows=tile_rows)
    np.testing.assert_array_equal(bits(got, n),
                                  single.presence_matrix(single.and_rows(row_idx), n))
    assert not got[:, mat.num_words:].any(), "phantom words are 0"
