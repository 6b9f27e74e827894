"""The port's grouped minimizer ops against the JAX package.

Grouped streams, kernel C (``grouped_tile_counts``: the contract of the
Pallas kernels P2 ``grouped_fused`` and P3 ``grouped_fused_v2`` and of
XLA ``grouped_counts``), kernel D (``pack_tile_cols``, and the cols
engine's load that packs chunk by chunk) and kernel E
(``cols_counts``: XLA ``grouped_counts_cols`` plus the exact AND).  The
same inputs, made from seeded numpy, go through the JAX function and
through the port's wrapper on CPU tensors, which runs the kernel's plain
PyTorch version.  Outputs are integer counts, bit words and stream
tensors, so every comparison is exact (tolerance zero).  The Pallas
kernels run in interpret mode on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigsi_tpu import native
from bigsi_tpu.ops import lookup as jax_lookup
from bigsi_tpu.ops import pallas_grouped, pallas_lookup
import bigsi_tpu_torch
from bigsi_tpu_torch import storage
from bigsi_tpu_torch.index import device_engine
from bigsi_tpu_torch.kmers import seq_to_kmers
from bigsi_tpu_torch.matrix.bitmatrix import BitSliceMatrix
from bigsi_tpu_torch.ops import fused_lookup
from bigsi_tpu_torch.ops import lookup

grouped_counts_jnp = jax.jit(jax_lookup.grouped_counts, static_argnums=3)
grouped_counts_cols_jnp = jax.jit(jax_lookup.grouped_counts_cols)
pack_tile_cols_jnp = jax.jit(jax_lookup.pack_tile_cols, static_argnums=1)
blocked_presence_jnp = jax.jit(jax_lookup.blocked_presence, static_argnums=3)
cols_presence_jnp = jax.jit(jax_lookup.cols_presence)
exact_and_reduce_jnp = jax.jit(jax.vmap(jax_lookup.exact_and_reduce))

UNSIGNED = {torch.uint8: np.uint8, torch.int16: np.uint16, torch.int32: np.uint32}


def as_torch(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def unsigned(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(UNSIGNED[x.dtype])


def random_words(rng, m, w):
    return rng.integers(0, 2**32, size=(m, w), dtype=np.uint32)


def run_streams(rng, b, k, num_tiles, max_run):
    """Per-k-mer tile ids in runs of 1..max_run k-mers on one tile, as the
    minimizer layout makes them."""
    tile = np.empty((b, k), dtype=np.int32)
    for i in range(b):
        j = 0
        while j < k:
            n = int(rng.integers(1, max_run + 1))
            tile[i, j : j + n] = rng.integers(0, num_tiles)
            j += n
    return tile


def slot_masks(rng, shape, tile_rows, h=3, pad=0.2):
    """Masks of h random rows below tile_rows; a share of them 0."""
    slots = rng.integers(0, tile_rows, size=(*shape, h)).astype(np.uint64)
    sm = np.bitwise_or.reduce(np.left_shift(np.uint64(1), slots), axis=-1)
    return np.where(rng.random(shape) < pad, np.uint64(0), sm)


def grouped_inputs(rng, b, u, r, num_tiles, tile_rows, pad=0.2):
    """Random grouped streams: utile int32[B, U], gmask uint64[B, U, R]
    with padding slots (0)."""
    utile = rng.integers(0, num_tiles, size=(b, u)).astype(np.int32)
    return utile, slot_masks(rng, (b, u, r), tile_rows, pad=pad)


def gm_torch(gmask: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(gmask).astype(np.uint64).view(np.int64))


# -- constants -----------------------------------------------------------------


def test_constants_restate_the_jax_package():
    assert lookup.GROUP_R == jax_lookup.GROUP_R
    for tile_rows in (1, 8, 9, 16, 17, 32, 33, 64):
        want = jax_lookup.cols_dtype(tile_rows)
        got = lookup.cols_dtype(tile_rows)
        if want is None:
            assert got is None
        else:
            assert torch.iinfo(got).bits == np.dtype(want).itemsize * 8


# -- the grouped stream builder ----------------------------------------------


STREAM_CASES = [  # b, k, r, max_run
    (4, 64, 6, 9), (3, 100, 1, 4), (2, 200, 20, 30), (5, 512, 20, 12), (3, 37, 6, 40),
]


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("b,k,r,max_run", STREAM_CASES)
def test_build_grouped_streams_matches_jax(monkeypatch, route, b, k, r, max_run):
    if route == "native":
        if not native.available():
            pytest.skip("the native library did not build")
    else:
        monkeypatch.setattr(native, "grouped_streams", lambda *a, **kw: None)
    rng = np.random.default_rng(b * 1000 + k + r)
    tile = run_streams(rng, b, k, 50, max_run)
    smask = slot_masks(rng, (b, k), 32, pad=0.0)
    smask[:, -3:] = 0  # trailing padding
    smask[0, k // 2] = 0  # padding inside a run
    smask[1, :] = 0  # an all-padding query
    want_u, want_g = jax_lookup.build_grouped_streams(tile, smask.astype(np.uint32), r=r)
    got_u, got_g = lookup.build_grouped_streams(as_torch(tile), gm_torch(smask), r=r)
    assert got_u.dtype == torch.int32 and got_g.dtype == torch.int64
    assert got_u.is_contiguous() and got_g.is_contiguous()
    np.testing.assert_array_equal(got_u.numpy(), want_u)
    np.testing.assert_array_equal(got_g.numpy(), want_g.astype(np.int64))
    assert got_u.shape[1] % 16 == 0 and not got_u[1].any() and not got_g[1].any()


@pytest.mark.parametrize("b", [0, 3])
def test_build_grouped_streams_without_kmers(b):
    utile, gmask = lookup.build_grouped_streams(
        torch.zeros((b, 0), dtype=torch.int32), torch.zeros((b, 0), dtype=torch.int64), r=20)
    assert utile.shape == (b, 16) and gmask.shape == (b, 16, 20)
    if b:
        want_u, want_g = jax_lookup.build_grouped_streams(
            np.zeros((b, 0), np.int32), np.zeros((b, 0), np.uint32), r=20)
        np.testing.assert_array_equal(utile.numpy(), want_u)
        np.testing.assert_array_equal(gmask.numpy(), want_g)


def test_build_grouped_streams_keeps_masks_past_bit_31():
    tile = torch.tensor([[7, 7, 7, 2]], dtype=torch.int32)
    smask = torch.tensor([[1 << 40, -(1 << 63), 5, 1 << 33]], dtype=torch.int64)  # bit 63
    utile, gmask = lookup.build_grouped_streams(tile, smask, r=2)
    assert utile[0, :3].tolist() == [7, 7, 2] and not utile[0, 3:].any()
    assert gmask[0, :3].tolist() == [[1 << 40, -(1 << 63)], [5, 0], [1 << 33, 0]]


# -- kernel C: grouped_tile_counts --------------------------------------------


def exact_oracle_jnp(words, utile, gmask, tile_rows):
    """exact_and_reduce over the JAX presence rows of every (entry, slot)."""
    b, u, r = gmask.shape
    tiles = jnp.asarray(words.reshape(-1, tile_rows * words.shape[1]))
    rows = blocked_presence_jnp(
        tiles, jnp.asarray(np.repeat(utile, r, axis=1).reshape(-1)),
        jnp.asarray(gmask.reshape(-1).astype(np.uint32)), tile_rows)
    return exact_and_reduce_jnp(rows.reshape(b, u * r, -1), jnp.asarray(gmask.reshape(b, -1) != 0))


@pytest.mark.parametrize("w", [1, 32, 33])
@pytest.mark.parametrize("tile_rows", [16, 32])
def test_grouped_counts_matches_jax(w, tile_rows):
    rng = np.random.default_rng(w * tile_rows)
    num_tiles, b, u, r = 29, 3, 21, 6
    words = random_words(rng, num_tiles * tile_rows, w)
    utile, gmask = grouped_inputs(rng, b, u, r, num_tiles, tile_rows)
    gmask[1] = 0  # an all-padding query
    want = grouped_counts_jnp(
        jnp.asarray(words.reshape(num_tiles, tile_rows * w)), jnp.asarray(utile),
        jnp.asarray(gmask.astype(np.uint32)), tile_rows)
    counts, exact = fused_lookup.grouped_tile_counts(
        as_torch(words), as_torch(utile), gm_torch(gmask), tile_rows)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        exact.numpy().view(np.uint32), np.asarray(exact_oracle_jnp(words, utile, gmask, tile_rows)))
    assert (exact[1].numpy().view(np.uint32) == 0xFFFFFFFF).all() and not counts[1].any()


def pallas_inputs(seed):
    """B = 2, U = 16, R = 6 at the Pallas kernels' W = 32, tile_rows 32."""
    rng = np.random.default_rng(seed)
    num_tiles, tr, w = 23, pallas_lookup.TILE_ROWS, pallas_lookup.W
    words = random_words(rng, num_tiles * tr, w)
    utile, gmask = grouped_inputs(rng, 2, 16, 6, num_tiles, tr)
    gmask[1, 9:] = 0  # a query that ends in padding entries
    return words, utile, gmask, tr


@pytest.mark.parametrize(
    "pallas_kernel", [pallas_lookup.grouped_fused, pallas_grouped.grouped_fused_v2],
    ids=["P2_grouped_fused", "P3_grouped_fused_v2"])
def test_grouped_tile_counts_matches_pallas(pallas_kernel):
    """Kernel C's contract against each Pallas kernel it replaces
    (interpret mode), and both against XLA grouped_counts."""
    words, utile, gmask, tr = pallas_inputs(7)
    tiles = jnp.asarray(words.reshape(-1, tr * words.shape[1]))
    g32 = jnp.asarray(gmask.astype(np.uint32))
    want_counts, want_exact = pallas_kernel(tiles, jnp.asarray(utile), g32, interpret=True)
    counts, exact = fused_lookup.grouped_tile_counts(
        as_torch(words), as_torch(utile), gm_torch(gmask), tr)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(exact.numpy().view(np.uint32), np.asarray(want_exact))
    np.testing.assert_array_equal(
        np.asarray(want_counts), np.asarray(grouped_counts_jnp(tiles, jnp.asarray(utile), g32, tr)))


def numpy_grouped_oracle(words, utile, gmask, tile_rows):
    """Bit by bit: each valid slot ANDs its absolute rows."""
    b, u, r = gmask.shape
    n = words.shape[1] * 32
    counts = np.zeros((b, n), dtype=np.int64)
    exact = np.full((b, words.shape[1]), 0xFFFFFFFF, dtype=np.uint32)
    for i in range(b):
        for e in range(u):
            for j in range(r):
                g = int(gmask[i, e, j])
                if g == 0:
                    continue
                p = np.full(words.shape[1], 0xFFFFFFFF, dtype=np.uint32)
                for s in range(tile_rows):
                    if g >> s & 1:
                        p &= words[int(utile[i, e]) * tile_rows + s]
                counts[i] += np.unpackbits(p.view(np.uint8), bitorder="little")
                exact[i] &= p
    return counts, exact


@pytest.mark.parametrize("w", [2, 32])
def test_grouped_tile_counts_tile_rows_64_matches_numpy_oracle(w):
    """tile_rows 64 needs 64-bit masks: every mask here selects a row
    past 31 (the JAX engine's uint32 masks would drop it)."""
    rng = np.random.default_rng(64 + w)
    num_tiles, tr, b, u, r = 9, 64, 3, 13, 6
    words = random_words(rng, num_tiles * tr, w)
    utile, gmask = grouped_inputs(rng, b, u, r, num_tiles, tr)
    high = np.left_shift(np.uint64(1), rng.integers(32, 64, size=gmask.shape).astype(np.uint64))
    gmask = np.where(gmask != 0, gmask | high, np.uint64(0))
    counts, exact = fused_lookup.grouped_tile_counts(
        as_torch(words), as_torch(utile), gm_torch(gmask), tr)
    want_counts, want_exact = numpy_grouped_oracle(words, utile, gmask, tr)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(exact.numpy().view(np.uint32), want_exact)


# -- kernel D: pack_tile_cols -------------------------------------------------


@pytest.mark.parametrize("w", [1, 32, 33])
@pytest.mark.parametrize("tile_rows", [1, 3, 5, 8, 12, 16, 24, 31, 32])
def test_pack_tile_cols_matches_jax(w, tile_rows):
    rng = np.random.default_rng(tile_rows + w)
    num_tiles = 19
    words = random_words(rng, num_tiles * tile_rows, w)
    cols = fused_lookup.pack_tile_cols(as_torch(words), tile_rows)
    assert cols.dtype == lookup.cols_dtype(tile_rows) and cols.shape == (num_tiles, w * 32)
    want = pack_tile_cols_jnp(jnp.asarray(words.reshape(num_tiles, tile_rows * w)), tile_rows)
    np.testing.assert_array_equal(unsigned(cols), np.asarray(want))
    np.testing.assert_array_equal(unsigned(cols), jax_lookup.pack_tile_cols_host(words, tile_rows))


def test_pack_tile_cols_chunks_do_not_change_the_result(monkeypatch):
    words = as_torch(random_words(np.random.default_rng(3), 16 * 41, 3))
    whole = lookup.pack_tile_cols(words, 16)
    monkeypatch.setattr(lookup, "PACK_CHUNK_BITS", 16 * 3 * 32 * 4)  # 4 tiles a chunk
    assert torch.equal(lookup.pack_tile_cols(words, 16), whole)


def test_pack_tile_cols_into_slices_of_one_cols():
    """``out=`` packs a run of tiles into its slice of one cols tensor;
    odd chunks of tiles give the whole pack."""
    words = as_torch(random_words(np.random.default_rng(4), 16 * 41, 3))
    whole = fused_lookup.pack_tile_cols(words, 16)
    cols = torch.zeros_like(whole)
    for t0 in range(0, 41, 7):
        t1 = min(41, t0 + 7)
        got = fused_lookup.pack_tile_cols(words[t0 * 16 : t1 * 16], 16, out=cols[t0:t1])
        assert got.data_ptr() == cols[t0:t1].data_ptr()
    assert torch.equal(cols, whole)
    with pytest.raises(TypeError):
        fused_lookup.pack_tile_cols(words, 16, out=torch.zeros((41, 96), dtype=torch.int32))
    with pytest.raises(ValueError):
        fused_lookup.pack_tile_cols(words, 16, out=torch.zeros((40, 96), dtype=torch.int16))


# -- the cols engine's streamed load ---------------------------------------------


@pytest.mark.parametrize("chunk_tiles", [1, 3, 1000])
@pytest.mark.parametrize("tile_rows", [8, 16, 32])
def test_cols_engine_loads_chunk_by_chunk(monkeypatch, tile_rows, chunk_tiles):
    """The cols engine packs its load chunk by chunk (chunks of 1 and 3
    tiles, and one chunk past every tile) into the cols of the whole
    matrix zero-padded to whole tiles, and never holds the row-major
    words."""
    rng = np.random.default_rng(tile_rows * 7 + chunk_tiles)
    m = tile_rows * 23 + 5  # not a multiple of tile_rows
    words = random_words(rng, m, 3)
    monkeypatch.setattr(device_engine, "LOAD_CHUNK_ROWS", tile_rows * chunk_tiles)
    packs = []
    real = device_engine.pack_tile_cols

    def spy(w, tr, out=None):
        packs.append(w.shape[0] // tr)
        return real(w, tr, out=out)

    monkeypatch.setattr(device_engine, "pack_tile_cols", spy)
    engine = device_engine.DeviceEngine(
        BitSliceMatrix(words, 96), device="cpu", layout="minimizer", tile_rows=tile_rows)
    assert engine.words is None and engine.cols.shape == (24, 96)
    assert packs == [min(chunk_tiles, 24 - t0) for t0 in range(0, 24, chunk_tiles)]
    np.testing.assert_array_equal(unsigned(engine.cols),
                                  jax_lookup.pack_tile_cols_host(words, tile_rows))


@pytest.mark.parametrize("chunk_tiles", [1, 3])
@pytest.mark.parametrize("tile_rows", [8, 16, 32])
def test_streamed_cols_engine_searches_as_the_host_engine(monkeypatch, tile_rows, chunk_tiles):
    """A minimizer index of m = 2,051 bits (not a multiple of tile_rows),
    loaded in chunks of 1 and 3 tiles: search_batch's result dicts equal
    the numpy host engine's."""
    rng = np.random.default_rng(tile_rows + chunk_tiles)
    config = {"storage-engine": "memory",
              "storage-config": {"filename": "tg-stream-%d-%d" % (tile_rows, chunk_tiles)},
              "k": 31, "m": 2051, "h": 3, "layout": "minimizer", "tile-rows": tile_rows}
    storage.get_storage(config).delete_all()
    genomes = ["".join(rng.choice(list("ACGT"), 300)) for _ in range(6)]
    blooms = [bigsi_tpu_torch.BIGSI.bloom(config, seq_to_kmers(g, 31)) for g in genomes]
    monkeypatch.setattr(device_engine, "LOAD_CHUNK_ROWS", tile_rows * chunk_tiles)
    port = bigsi_tpu_torch.BIGSI.build(config, blooms, ["s%d" % i for i in range(6)],
                                       device="cpu")
    assert port.engine.words is None and port.engine.cols is not None
    host = bigsi_tpu_torch.BIGSI(dict(config, engine="numpy"))
    queries = [genomes[0], genomes[1][:150], genomes[2][40:240], genomes[3][:100] + "A" * 60]
    for threshold in (1.0, 0.5):
        got = port.search_batch(queries, threshold)
        assert got == host.search_batch(queries, threshold)
        assert any(got)
    storage.get_storage(config).delete_all()


# -- kernel E: cols_counts ------------------------------------------------------


def cols_inputs(seed, tile_rows, w, b, u, r, num_tiles=31):
    rng = np.random.default_rng(seed)
    words = random_words(rng, num_tiles * tile_rows, w)
    cols = jax_lookup.pack_tile_cols_host(words, tile_rows)
    utile, gmask = grouped_inputs(rng, b, u, r, num_tiles, tile_rows)
    gmask[0, -2:] = 0  # padding entries
    n_valid = (gmask != 0).sum(axis=(1, 2)).astype(np.int32)
    return cols, utile, gmask, n_valid


def torch_cols(cols: np.ndarray) -> torch.Tensor:
    dtype = {np.uint8: torch.uint8, np.uint16: torch.int16, np.uint32: torch.int32}[cols.dtype.type]
    return torch.from_numpy(cols).view(dtype)


@pytest.mark.parametrize("tile_rows,w,b,u,r", [
    (8, 1, 3, 16, 6), (16, 32, 2, 21, 20), (32, 33, 3, 5, 1), (16, 2, 2, 1600, 20),
    (32, 2, 2, 1700, 20),
], ids=["tr8", "tr16", "tr32-W33", "tr16-UR-over-2^15", "tr32-UR-over-2^15"])
def test_cols_counts_matches_grouped_counts_cols(tile_rows, w, b, u, r):
    """U*R = 32,000 and 34,000 in the last two cases: past the JAX
    program's int16 accumulator bound."""
    cols, utile, gmask, n_valid = cols_inputs(tile_rows * u, tile_rows, w, b, u, r)
    want = grouped_counts_cols_jnp(
        jnp.asarray(cols), jnp.asarray(utile), jnp.asarray(gmask.astype(np.uint32)),
        jnp.asarray(n_valid))
    counts, _ = fused_lookup.cols_counts(
        torch_cols(cols), as_torch(utile), gm_torch(gmask), as_torch(n_valid))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want))


@pytest.mark.parametrize("tile_rows,w", [(8, 2), (16, 32), (32, 33)])
def test_cols_counts_exact_matches_cols_presence(tile_rows, w):
    cols, utile, gmask, n_valid = cols_inputs(w, tile_rows, w, 3, 17, 6)
    gmask[2] = 0  # no valid slot: all ones
    _, exact = fused_lookup.cols_counts(
        torch_cols(cols), as_torch(utile), gm_torch(gmask), as_torch(n_valid))
    b, u, r = gmask.shape
    rows = cols_presence_jnp(
        jnp.asarray(cols), jnp.asarray(np.repeat(utile, r, axis=1).reshape(-1)),
        jnp.asarray(gmask.reshape(-1).astype(np.uint32)))
    want = exact_and_reduce_jnp(rows.reshape(b, u * r, w), jnp.asarray(gmask.reshape(b, -1) != 0))
    np.testing.assert_array_equal(exact.numpy().view(np.uint32), np.asarray(want))
    assert (exact[2].numpy().view(np.uint32) == 0xFFFFFFFF).all()


@pytest.mark.parametrize("tile_rows", [8, 16, 32])
def test_cols_presence_matches_jax(tile_rows):
    cols, utile, gmask, _ = cols_inputs(5, tile_rows, 3, 1, 40, 1)
    tile, smask = utile[0], gmask[0, :, 0]
    got = lookup.cols_presence(torch_cols(cols), as_torch(tile), gm_torch(smask))
    want = cols_presence_jnp(jnp.asarray(cols), jnp.asarray(tile), jnp.asarray(smask.astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_cols_counts_equal_grouped_tile_counts_on_the_same_streams():
    """Kernels C and E on the same streams: the cols layout is the same
    bits, so with n_valid = the valid slots the counts agree."""
    rng = np.random.default_rng(11)
    tr, w, num_tiles = 16, 4, 27
    words = random_words(rng, num_tiles * tr, w)
    utile, gmask = grouped_inputs(rng, 4, 19, 20, num_tiles, tr)
    n_valid = (gmask != 0).sum(axis=(1, 2)).astype(np.int32)
    words_t = as_torch(words)
    cols = fused_lookup.pack_tile_cols(words_t, tr)
    got = fused_lookup.cols_counts(cols, as_torch(utile), gm_torch(gmask), as_torch(n_valid))
    want = fused_lookup.grouped_tile_counts(words_t, as_torch(utile), gm_torch(gmask), tr)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


@pytest.mark.parametrize("bits", [8, 16])
def test_field_hits_matches_the_plain_compare(bits):
    """Kernel E's packed test of a 32-bit word against ``(x & g) == g``
    per field: every (x, g) pair of 8-bit fields, and 2^20 random pairs
    plus the edge values of 16-bit fields."""
    per = 32 // bits
    if bits == 8:
        g = np.repeat(np.arange(256), 256)
        x = np.tile(np.arange(256), 256)
    else:
        rng = np.random.default_rng(16)
        edges = np.array([0, 1, 0x7FFF, 0x8000, 0x8001, 0xFFFE, 0xFFFF])
        g = np.concatenate([rng.integers(0, 1 << 16, 1 << 20), np.repeat(edges, len(edges))])
        x = np.concatenate([rng.integers(0, 1 << 16, 1 << 20), np.tile(edges, len(edges))])
        # a sparse g, as a slot mask of h bits is: most random pairs miss
        g[: 1 << 19] &= rng.integers(0, 1 << 16, 1 << 19) & rng.integers(0, 1 << 16, 1 << 19)
    n = len(x) // per * per
    x, g = x[:n].reshape(-1, per), g[:n].reshape(-1, per)
    g[:, 1:] = g[:, :1]  # one mask, repeated in every field
    shifts = np.arange(per) * bits
    words = torch.from_numpy((x.astype(np.int64) << shifts).sum(axis=1))
    rep = torch.from_numpy((g.astype(np.int64) << shifts).sum(axis=1))
    flags = lookup.field_hits(words, rep, bits).numpy()
    got = (flags[:, None] >> (shifts + bits - 1)) & 1
    np.testing.assert_array_equal(got.astype(bool), (x & g) == g)
    assert not (flags & ~np.int64(sum(1 << (s + bits - 1) for s in shifts))).any()


def seq_arm_streams(u_cap, tile_rows=16, num_tiles=31):
    """Kernel H's plain streams of three queries: one with a 60 bp repeat
    (its duplicate k-mers keep a slot with mask 0), a random one and an
    empty one; ``u_cap`` below the entries needed overflows them."""
    from bigsi_tpu_torch.ops import prep

    rng = np.random.default_rng(tile_rows + u_cap)
    seqs = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, (3, 320))].copy()
    seqs[0, 200:260] = seqs[0, 20:80]
    lens = np.array([320, 300, 0], dtype=np.int32)
    utile, gmask, n_valid, ok = prep.prep_streams(
        torch.from_numpy(seqs), torch.from_numpy(lens), k=31, s=13, num_tiles=num_tiles, h=3,
        tile_rows=tile_rows, r=20, u_cap=u_cap)
    return utile, gmask, n_valid, bool(ok)


@pytest.mark.parametrize("case", ["overflowed", "duplicates", "all-padding", "wide-masks"])
@pytest.mark.parametrize("tile_rows", [8, 16, 32])
def test_live_slot_counts_equal_grouped_counts_cols(case, tile_rows):
    """Kernel E counts only the live slots: hits over them + n_valid -
    live, bit-equal to the contract's sum over every slot minus U*R -
    n_valid, on the streams where the two could part."""
    rng = np.random.default_rng(tile_rows)
    num_tiles = 31
    cols = lookup.pack_tile_cols(as_torch(random_words(rng, num_tiles * tile_rows, 3)), tile_rows)
    if case in ("overflowed", "duplicates"):
        utile, gmask, n_valid, ok = seq_arm_streams(3 if case == "overflowed" else 290,
                                                    tile_rows, num_tiles)
        assert ok == (case == "duplicates")
        written = int((gmask[0] != 0).sum())
        assert written < int(n_valid[0]) if case == "overflowed" else written == int(n_valid[0])
        if case == "duplicates":  # the repeat's 30 k-mers are not distinct
            assert int(n_valid[0]) <= 290 - 30
    elif case == "all-padding":
        utile = as_torch(rng.integers(0, num_tiles, (3, 7)).astype(np.int32))
        gmask = torch.zeros((3, 7, 5), dtype=torch.int64)
        n_valid = torch.tensor([0, 4, 35], dtype=torch.int32)
    else:  # bits only above the cols width are padding once cut
        utile, gmask = grouped_inputs(rng, 3, 9, 6, num_tiles, tile_rows)
        gmask = gm_torch(gmask)
        utile = as_torch(utile)
        gmask[:, ::2] = gmask[:, ::2] << 32
        n_valid = (gmask != 0).sum(dim=(1, 2), dtype=torch.int32)
    got = lookup.grouped_counts_cols_live(cols, utile, gmask, n_valid)
    want = lookup.grouped_counts_cols(cols, utile, gmask, n_valid)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- the wrappers' checks -------------------------------------------------------


def test_grouped_wrappers_check_their_arguments():
    words = torch.zeros((64, 2), dtype=torch.int32)
    utile = torch.zeros((1, 4), dtype=torch.int32)
    gmask = torch.ones((1, 4, 3), dtype=torch.int64)
    n_valid = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError):
        fused_lookup.grouped_tile_counts(words, utile, gmask.int(), 32)
    with pytest.raises(ValueError):
        fused_lookup.grouped_tile_counts(words, utile, gmask, 48)  # 48 does not divide 64
    with pytest.raises(ValueError):
        fused_lookup.pack_tile_cols(words, 64)  # no cols layout past 32 rows
    cols = fused_lookup.pack_tile_cols(words, 16)
    with pytest.raises(ValueError):
        fused_lookup.cols_counts(cols, utile, gmask[:, :3], n_valid)
    with pytest.raises(TypeError):
        fused_lookup.cols_counts(cols.long(), utile, gmask, n_valid)
    with pytest.raises(ValueError):
        fused_lookup.cols_counts(cols.to("meta"), utile.to("meta"), gmask.to("meta"),
                               n_valid.to("meta"))
