"""The port's lookup ops (bigsi_tpu_torch.ops) against the JAX package.

The same inputs, made from seeded numpy, go through the JAX function and
through the port's kernel wrapper on CPU tensors, which runs the
kernel's plain PyTorch version.  Outputs are integer counts and bit
words, so every comparison is exact (tolerance zero).  The Pallas
kernel runs in interpret mode on the CPU, as in
tests/test_pallas_lookup.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigsi_tpu.index import device_engine as jax_engine
from bigsi_tpu.index.host_engine import HostEngine
from bigsi_tpu.matrix.bitmatrix import BitSliceMatrix
from bigsi_tpu.ops import lookup as jax_lookup
from bigsi_tpu.ops import pallas_lookup
from bigsi_tpu_torch.index.device_engine import load_words, tile_streams
from bigsi_tpu_torch.ops import fused_lookup
from bigsi_tpu_torch.ops import lookup


# jitted once per shape: eager JAX compiles every primitive on its own
batched_counts_jnp = jax.jit(jax_lookup.batched_counts_jnp)
query_counts_jnp = jax.jit(jax_lookup.query_counts_jnp)
blocked_counts_jnp = jax.jit(jax_lookup.blocked_counts, static_argnums=4)
blocked_presence_jnp = jax.jit(jax_lookup.blocked_presence, static_argnums=3)
exact_and_reduce_jnp = jax.jit(jax.vmap(jax_lookup.exact_and_reduce))


def as_torch(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def random_words(rng, m, w):
    return rng.integers(0, 2**32, size=(m, w), dtype=np.uint32)


def classic_inputs(rng, m, b, k, h, pad=0.2):
    idx = rng.integers(0, m, size=(b, k, h)).astype(np.int32)
    mask = rng.random((b, k)) >= pad
    return idx, mask


def tile_inputs(rng, num_tiles, tile_rows, b, k, h=3, pad=0.2):
    """Tile ids in runs (as the minimizer layout makes them), slot ids,
    and padding k-mers; -> tile int32, slots, validity."""
    tile = rng.integers(0, num_tiles, size=(b, k)).astype(np.int32)
    tile[:, 1::3] = tile[:, 0::3][:, : tile[:, 1::3].shape[1]]
    slots = rng.integers(0, tile_rows, size=(b, k, h))
    valid = rng.random((b, k)) >= pad
    return tile, slots, valid


def slot_mask(slots, valid, dtype):
    sm = np.bitwise_or.reduce(np.left_shift(np.uint64(1), slots.astype(np.uint64)), axis=-1)
    return np.where(valid, sm, 0).astype(dtype)


# -- kernel A: classic_counts ---------------------------------------------


@pytest.mark.parametrize("b,k,h,w", [(3, 40, 3, 32), (2, 17, 1, 8), (4, 33, 3, 3)])
def test_classic_counts_matches_counts_batch_fat(b, k, h, w):
    rng = np.random.default_rng(b * 100 + k)
    words = random_words(rng, 500, w)
    idx, mask = classic_inputs(rng, 500, b, k, h)
    fat, g = jax_engine.fat_pack(words)
    want = jax_engine._counts_batch_fat(jnp.asarray(fat), jnp.asarray(idx), jnp.asarray(mask), g, w)
    counts, _ = fused_lookup.classic_counts(as_torch(words), as_torch(idx), as_torch(mask))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("w", [1, 32, 33])
def test_classic_counts_matches_batched_and_query_counts_jnp(seed, w):
    rng = np.random.default_rng(seed)
    words = random_words(rng, 300, w)
    idx, mask = classic_inputs(rng, 300, 4, 50, 3)
    mask[1] = False  # a query with no valid k-mer: exact is all ones
    counts, exact = fused_lookup.classic_counts(as_torch(words), as_torch(idx), as_torch(mask))
    want = batched_counts_jnp(jnp.asarray(words), jnp.asarray(idx), jnp.asarray(mask))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want))
    for i in range(idx.shape[0]):
        qc, qe = query_counts_jnp(
            jnp.asarray(words), jnp.asarray(idx[i]), jnp.asarray(mask[i]))
        np.testing.assert_array_equal(counts[i].numpy(), np.asarray(qc))
        np.testing.assert_array_equal(u32(exact[i]), np.asarray(qe))
        one_c, one_e = lookup.query_counts(as_torch(words), as_torch(idx[i]), as_torch(mask[i]))
        np.testing.assert_array_equal(one_c.numpy(), np.asarray(qc))
        np.testing.assert_array_equal(u32(one_e), np.asarray(qe))
    assert (u32(exact[1]) == 0xFFFFFFFF).all()


def test_classic_counts_without_kmers():
    words = as_torch(random_words(np.random.default_rng(0), 64, 2))
    counts, exact = fused_lookup.classic_counts(
        words, torch.zeros((2, 0, 3), dtype=torch.int32), torch.zeros((2, 0), dtype=torch.bool))
    assert counts.shape == (2, 64) and not counts.any()
    assert (u32(exact) == 0xFFFFFFFF).all()


# -- kernel B: tile_counts ------------------------------------------------


@pytest.mark.parametrize("seed,b,k", [(0, 2, pallas_lookup.CHUNK), (1, 1, 2 * pallas_lookup.CHUNK)])
def test_tile_counts_matches_pallas_fused_query(seed, b, k):
    """Kernel B's contract against the Pallas kernel it replaces (P1,
    query_counts_exact, interpret mode): W = 32, tile_rows 32."""
    rng = np.random.default_rng(seed)
    num_tiles, tr, w = 37, pallas_lookup.TILE_ROWS, pallas_lookup.W
    words = random_words(rng, num_tiles * tr, w)
    tile, slots, valid = tile_inputs(rng, num_tiles, tr, b, k, pad=0.15)
    want_counts, want_exact = pallas_lookup.query_counts_exact(
        np.ascontiguousarray(words.reshape(num_tiles * 8, 128)), tile,
        slot_mask(slots, valid, np.uint32))
    counts, exact = fused_lookup.tile_counts(
        as_torch(words), as_torch(tile), as_torch(slot_mask(slots, valid, np.int64)), tr)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(u32(exact), want_exact)


@pytest.mark.parametrize("w", [1, 3, 33])
@pytest.mark.parametrize("tile_rows", [8, 16, 32])
def test_tile_counts_matches_blocked_counts(w, tile_rows):
    rng = np.random.default_rng(w * tile_rows)
    num_tiles, b, k = 23, 3, 40
    words = random_words(rng, num_tiles * tile_rows, w)
    tile, slots, valid = tile_inputs(rng, num_tiles, tile_rows, b, k)
    tiles = jnp.asarray(words.reshape(num_tiles, tile_rows * w))
    sm32 = jnp.asarray(slot_mask(slots, valid, np.uint32))
    want = blocked_counts_jnp(tiles, jnp.asarray(tile), sm32, jnp.asarray(valid), tile_rows)
    presence = blocked_presence_jnp(
        tiles, jnp.asarray(tile.reshape(-1)), sm32.reshape(-1), tile_rows).reshape(b, k, w)
    want_exact = exact_and_reduce_jnp(presence, jnp.asarray(valid))
    counts, exact = fused_lookup.tile_counts(
        as_torch(words), as_torch(tile), as_torch(slot_mask(slots, valid, np.int64)), tile_rows)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want))
    np.testing.assert_array_equal(u32(exact), np.asarray(want_exact))


@pytest.mark.parametrize("w", [2, 32])
def test_tile_counts_tile_rows_64_matches_host_engine(w):
    """tile_rows 64 needs 64-bit slot masks: the oracle is the host
    engine ANDing the k-mers' absolute rows."""
    rng = np.random.default_rng(w)
    num_tiles, tr, b, k = 11, 64, 3, 30
    words = random_words(rng, num_tiles * tr, w)
    tile, slots, valid = tile_inputs(rng, num_tiles, tr, b, k)
    slots[:, :, 0] = rng.integers(32, 64, size=(b, k))  # a row past 31 per k-mer
    counts, exact = fused_lookup.tile_counts(
        as_torch(words), as_torch(tile), as_torch(slot_mask(slots, valid, np.int64)), tr)
    host = HostEngine(BitSliceMatrix(words, w * 32))
    for i in range(b):
        packed = host.and_rows(tile[i][valid[i]][:, None] * tr + slots[i][valid[i]])
        np.testing.assert_array_equal(counts[i].numpy(), host.counts(packed, w * 32))
        np.testing.assert_array_equal(u32(exact[i]), np.bitwise_and.reduce(packed, axis=0))


# -- presence rows --------------------------------------------------------


@pytest.mark.parametrize("h", [1, 3])
def test_and_rows_matches_and_rows_jnp(h):
    rng = np.random.default_rng(h)
    words = random_words(rng, 200, 5)
    idx = rng.integers(0, 200, size=(37, h)).astype(np.int32)
    got = lookup.and_rows(as_torch(words), as_torch(idx))
    want = jax_lookup.and_rows_jnp(jnp.asarray(words), jnp.asarray(idx))
    np.testing.assert_array_equal(u32(got), np.asarray(want))


@pytest.mark.parametrize("w,tile_rows", [(1, 8), (33, 32), (4, 16)])
def test_blocked_presence_matches_jax(w, tile_rows):
    rng = np.random.default_rng(w + tile_rows)
    num_tiles = 13
    words = random_words(rng, num_tiles * tile_rows, w)
    tile, slots, valid = tile_inputs(rng, num_tiles, tile_rows, 1, 45)
    valid[:] = True
    got = lookup.blocked_presence(
        as_torch(words), as_torch(tile[0]), as_torch(slot_mask(slots, valid, np.int64)[0]),
        tile_rows)
    want = blocked_presence_jnp(
        jnp.asarray(words.reshape(num_tiles, tile_rows * w)), jnp.asarray(tile[0]),
        jnp.asarray(slot_mask(slots, valid, np.uint32)[0]), tile_rows)
    np.testing.assert_array_equal(u32(got), np.asarray(want))


# -- device state ----------------------------------------------------------


@pytest.mark.parametrize("tile_rows,m_pad", [(None, 100), (32, 128), (64, 128), (8, 104)])
def test_load_words_pads_to_whole_tiles(tile_rows, m_pad):
    words = random_words(np.random.default_rng(5), 100, 3)
    got = load_words(words, "cpu", tile_rows)
    assert got.dtype == torch.int32 and got.shape == (m_pad, 3)
    np.testing.assert_array_equal(u32(got[:100]), words)
    assert not got[100:].any()


def test_load_words_reads_a_read_only_mmap(tmp_path):
    words = random_words(np.random.default_rng(6), 70, 2)
    words.tofile(tmp_path / "rows.bin")
    mm = np.memmap(tmp_path / "rows.bin", dtype=np.uint32, mode="r", shape=words.shape)
    np.testing.assert_array_equal(u32(load_words(mm, "cpu", 32)[:70]), words)


def test_tile_streams_keep_slots_past_31():
    row_idx = torch.tensor([[[64 * 3 + 40, 64 * 3 + 2, 64 * 3 + 63]], [[5, 6, 7]]],
                           dtype=torch.int32)
    tile, smask = tile_streams(row_idx, torch.tensor([[True], [False]]), 64)
    assert tile.dtype == torch.int32 and tile.tolist() == [[3], [0]]
    assert smask.dtype == torch.int64
    want = np.array((1 << 40) | (1 << 2) | (1 << 63), dtype=np.uint64).view(np.int64)
    assert smask[0, 0].item() == want and smask[1, 0].item() == 0


def test_wrappers_check_their_arguments():
    words = torch.zeros((64, 2), dtype=torch.int32)
    idx = torch.zeros((1, 4, 3), dtype=torch.int32)
    mask = torch.ones((1, 4), dtype=torch.bool)
    with pytest.raises(TypeError):
        fused_lookup.classic_counts(words.long(), idx, mask)
    with pytest.raises(ValueError):
        fused_lookup.classic_counts(words, idx, mask[:, :3])
    with pytest.raises(ValueError):
        fused_lookup.tile_counts(words, idx[..., 0].contiguous(),
                                 torch.ones((1, 4), dtype=torch.int64), 48)
    with pytest.raises(ValueError):
        fused_lookup.classic_counts(words.to("meta"), idx.to("meta"), mask.to("meta"))
