"""The port's device build (bigsi_tpu_torch.ops.build, kernels J's and K's
plain versions on the CPU) against the JAX package's ``ops/build_jax.py``
and the host build pipeline.

The same numpy inputs go through the JAX function (JAX on the CPU), the
port on CPU tensors and the port's host build (``BloomFilter``,
``transpose_blooms``); blooms and matrices are bit words, so every
comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigsi_tpu.ops.build_jax import device_bloom as jax_device_bloom
from bigsi_tpu.ops.build_jax import device_transpose as jax_device_transpose
from bigsi_tpu_torch.bloom import BloomFilter
from bigsi_tpu_torch.kmers import ascii_to_strings, convert_query_kmers
from bigsi_tpu_torch.matrix.bitmatrix import transpose_blooms
from bigsi_tpu_torch.matrix.packing import pack_bits_lsb
from bigsi_tpu_torch.ops import fused_lookup
from bigsi_tpu_torch.ops.build import device_bloom, device_transpose

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_kmers(rng, k, n):
    return ACGT[rng.integers(0, 4, size=(n, k))]


def jax_bloom(kmers, **kw) -> np.ndarray:
    return np.asarray(jax_device_bloom(jnp.asarray(kmers), **kw)).view(np.int32)


def host_bloom(kmers, m, h, layout, tile_rows=32) -> np.ndarray:
    """The port's host build: BIGSI.bloom's canonical k-mers into a
    BloomFilter, packed LSB-first."""
    bf = BloomFilter(m=m, h=h, layout=layout, tile_rows=tile_rows)
    bf.update(convert_query_kmers(ascii_to_strings(kmers)))
    return pack_bits_lsb(np.asarray(bf.bitarray)[None, :])[0].view(np.int32)


@pytest.mark.parametrize("layout", ["classic", "blocked"])
@pytest.mark.parametrize("m, tile_rows", [(4096, 32), (1000, 8), (1000, 64), (100_003, 32)])
@pytest.mark.parametrize("klen", [9, 31])
def test_device_bloom_matches_jax_and_host(layout, m, tile_rows, klen):
    rng = np.random.default_rng(m + klen)
    kmers = random_kmers(rng, klen, 50)
    got = device_bloom(kmers, m=m, h=3, layout=layout, tile_rows=tile_rows, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (-(-m // 32),)
    np.testing.assert_array_equal(
        got.numpy(), jax_bloom(kmers, m=m, h=3, layout=layout, tile_rows=tile_rows))
    np.testing.assert_array_equal(got.numpy(), host_bloom(kmers, m, 3, layout, tile_rows))


@pytest.mark.parametrize("m, tile_rows", [(5, 8), (20, 32), (20, 64), (40, 64)])
def test_blocked_bloom_below_tile_rows_matches_jax(m, tile_rows):
    """m below tile_rows: one tile of tile_rows rows, so rows reach past
    m; those inside the bloom's last word are set and the rest dropped,
    as JAX's scatter (mode="drop") does."""
    kmers = random_kmers(np.random.default_rng(m), 31, 40)
    got = device_bloom(kmers, m=m, h=3, layout="blocked", tile_rows=tile_rows, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), jax_bloom(kmers, m=m, h=3, layout="blocked", tile_rows=tile_rows))


def mixed_kmers(rng, n, k):
    """n k-mers: ordinary ACGT ones among all-N ones, ones of N and
    lowercase bytes, and reverse-complement palindromes (an N in the
    middle at odd k), interleaved so each kind shares a run of kernel J
    (128 k-mers) with the others."""
    odd = np.frombuffer(b"ACGTNacgtn", dtype=np.uint8)
    comp = np.arange(256, dtype=np.uint8)
    comp[ACGT] = np.frombuffer(b"TGCA", dtype=np.uint8)
    out = random_kmers(rng, k, n)
    kind = rng.integers(0, 8, n)
    out[kind == 0] = ord("N")
    out[kind == 1] = odd[rng.integers(0, 10, size=(int((kind == 1).sum()), k))]
    for i in np.nonzero(kind >= 6)[0]:
        half = random_kmers(rng, k // 2, 1)[0]
        out[i] = np.concatenate([half, np.full(k % 2, ord("N"), np.uint8), comp[half[::-1]]])
    return out


@pytest.mark.parametrize("layout, m, tile_rows", [
    ("classic", 100_003, 1), ("blocked", 100_003, 32), ("blocked", 100_003, 64),
    ("blocked", 100_003, 24), ("blocked", 20, 24)])
@pytest.mark.parametrize("k, n", [(31, 255), (31, 256), (31, 257), (31, 4097), (63, 257),
                                  (64, 256), (100, 255)])
def test_device_bloom_reader_edges_match_jax(layout, m, tile_rows, k, n):
    """Kernel J's contract where its staged reader's runs (128 k-mers, 81
    at k = 100) end, on mixed N, lowercase and palindromic
    k-mers; tile_rows 24 and 64, which do not divide 32 (a k-mer's rows
    may span two bloom words), 24 also above m (rows in [m, 32) kept)."""
    kmers = mixed_kmers(np.random.default_rng(n + k + tile_rows), n, k)
    got = device_bloom(kmers, m=m, h=3, layout=layout, tile_rows=tile_rows, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), jax_bloom(kmers, m=m, h=3, layout=layout, tile_rows=tile_rows))


@pytest.mark.parametrize("layout, tile_rows", [("classic", 1), ("blocked", 32), ("blocked", 24)])
@pytest.mark.parametrize("offset", [1, 3])
def test_device_bloom_of_offset_views(layout, tile_rows, offset):
    """x[1:] and x[3:] of 31-mers: views whose bytes start off a 16-byte
    boundary give the bloom of their rows, as JAX and the host build do."""
    kmers = random_kmers(np.random.default_rng(offset), 31, 700)
    view = torch.from_numpy(kmers)[offset:]
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    got = device_bloom(view, m=4096, h=3, layout=layout, tile_rows=tile_rows)
    np.testing.assert_array_equal(
        got.numpy(), jax_bloom(kmers[offset:], m=4096, h=3, layout=layout, tile_rows=tile_rows))
    np.testing.assert_array_equal(got.numpy(),
                                  host_bloom(kmers[offset:], 4096, 3, layout, tile_rows))


@pytest.mark.parametrize("layout", ["classic", "blocked"])
def test_device_bloom_256_duplicate_kmers(layout):
    """A k-mer repeated 256 times still sets its bits: the scatter is a
    maximum (an OR), not an add that would wrap a byte to zero."""
    kmer = np.frombuffer(b"ACGTACGTA", dtype=np.uint8)
    once = device_bloom(kmer[None, :], m=4096, h=3, layout=layout, device="cpu")
    many = device_bloom(np.tile(kmer, (256, 1)), m=4096, h=3, layout=layout, device="cpu")
    assert torch.equal(once, many)
    assert once.any()
    np.testing.assert_array_equal(
        many.numpy(), jax_bloom(np.tile(kmer, (256, 1)), m=4096, h=3, layout=layout))


def test_device_bloom_bit_order_and_edges():
    """LSB-first: bloom bit p is bit p % 32 of word p // 32; no k-mers
    give an empty bloom; minimizer raises."""
    kmers = random_kmers(np.random.default_rng(3), 31, 20)
    words = device_bloom(kmers, m=1000, h=3, device="cpu").numpy().view(np.uint32)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")[:1000].astype(bool)
    bf = BloomFilter(m=1000, h=3)
    bf.update(convert_query_kmers(ascii_to_strings(kmers)))
    np.testing.assert_array_equal(bits, bf.bitarray)
    empty = device_bloom(np.zeros((0, 31), dtype=np.uint8), m=1000, h=3, device="cpu")
    assert empty.shape == (32,) and not empty.any()
    with pytest.raises(ValueError, match="classic/blocked"):
        device_bloom(kmers, m=1000, h=3, layout="minimizer", device="cpu")


@pytest.mark.parametrize("n", [1, 33, 70])
@pytest.mark.parametrize("m", [1000, 4096])
@pytest.mark.parametrize("rows_chunk", [256, 4096])
def test_device_transpose_matches_jax_and_host(n, m, rows_chunk):
    """Exactly ceil(N / 32) words: equal to the host's lane-padded
    transpose_blooms on its first words, whose rest is zero."""
    rng = np.random.default_rng(n * m)
    blooms = [rng.random(m) < 0.3 for _ in range(n)]
    want = transpose_blooms(blooms, m)
    packed = pack_bits_lsb(np.stack([np.pad(b, (0, (-m) % 32)) for b in blooms]))
    got = device_transpose(packed.view(np.int32), m, rows_chunk=rows_chunk, device="cpu")
    w = -(-n // 32)
    assert got.dtype == torch.int32 and got.shape == (m, w)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want[:, :w])
    assert np.all(want[:, w:] == 0)
    jax_got = np.asarray(jax_device_transpose(jnp.asarray(packed), m, rows_chunk=rows_chunk))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), jax_got)


@pytest.mark.parametrize("m, w", [(4096, 1), (1024, 3), (2048, 32)])
def test_device_transpose_inverts_pack_tile_cols(m, w):
    """Kernel D at tile_rows 32 maps words [m, W] to cols int32[m / 32, N]
    with cols[t, n] == blooms[n, t]: the transpose of D's cols is the
    blooms, and device_transpose gives the words back."""
    rng = np.random.default_rng(m + w)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, size=(m, w), dtype=np.int64)
                             .astype(np.int32))
    blooms = fused_lookup.pack_tile_cols(words, 32).t().contiguous()
    assert torch.equal(device_transpose(blooms, m), words)


def test_device_transpose_refuses_bad_arguments(monkeypatch):
    blooms = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        device_transpose(blooms.long(), 100)
    with pytest.raises(ValueError):
        device_transpose(blooms[0], 100)
    for m in (0, 8 * 32 + 1):
        with pytest.raises(ValueError):
            device_transpose(blooms, m)
    km = torch.zeros((4, 31), dtype=torch.uint8)
    seeds = torch.arange(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        fused_lookup.bloom_scatter(km.int(), seeds, "classic", 100)
    with pytest.raises(ValueError):
        fused_lookup.bloom_scatter(km, seeds, "minimizer", 100)
    with pytest.raises(ValueError):
        fused_lookup.bloom_scatter(km, seeds, "classic", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        device_bloom(km.numpy(), m=100, h=3)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        device_transpose(blooms.numpy(), 100)
