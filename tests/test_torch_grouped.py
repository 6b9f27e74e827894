"""The port's grouped minimizer ops against the JAX package.

Grouped streams, kernel C (``grouped_tile_counts``: the contract of the
Pallas kernels P2 ``grouped_fused`` and P3 ``grouped_fused_v2`` and of
XLA ``grouped_counts``), kernel D (``pack_tile_cols``) and kernel E
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
@pytest.mark.parametrize("tile_rows", [8, 16, 32])
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
