"""The port's k-mer hashing (bigsi_tpu_torch.ops.hash, kernel I's plain
versions on the CPU) against the JAX package's ``ops/hash_jax.py`` and the
host hashers.

The same numpy inputs go through the JAX function (JAX on the CPU) and
the port on CPU tensors; hashes, rows and bytes are integers, so every
comparison is exact.  The cases of tests/test_hashing.py are ported, the
hypothesis property included, and the hazards of a straight translation
each have a case: logical shifts, the signed floor-mod, the tail and the
length, non-ACGT bytes and palindromes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from bigsi_tpu.hashing.murmur3 import murmur3_32_batch as jax_pkg_murmur3_batch
from bigsi_tpu.kmers import canonicalize_kmer_matrix as jax_pkg_canonicalize
from bigsi_tpu.ops.hash_jax import canonicalize_jax, murmur3_32_jax, row_indices_jax
from bigsi_tpu_torch.hashing.murmur3 import hash_kmer_matrix, murmur3_32 as scalar_murmur3
from bigsi_tpu_torch.hashing.scheme import row_indices as scheme_row_indices
from bigsi_tpu_torch.ops import fused_lookup, hash as kh

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
LENGTHS = list(range(1, 10)) + [16, 31, 32, 33]  # every k % 4, k // 4 up to 8


def mat(kmers) -> np.ndarray:
    return np.stack([np.frombuffer(k.encode(), dtype=np.uint8) for k in kmers])


def cpu(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def revcomp(row: np.ndarray) -> np.ndarray:
    table = np.arange(256, dtype=np.uint8)
    table[ACGT] = np.frombuffer(b"TGCA", dtype=np.uint8)
    return table[row[::-1]]


# -- tests/test_hashing.py, ported ---------------------------------------------


@pytest.mark.parametrize("h, m, want", [(3, 25, {2, 15, 17}), (1, 25, {15}), (2, 50, {15, 27})])
def test_row_indices_golden(h, m, want):
    """generate_hashes("ATT", h, m) of the reference suite."""
    assert set(kh.row_indices(mat(["ATT"]), h, m, device="cpu")[0].tolist()) == want


def test_murmur3_matches_scalar_kmers():
    kmers = ["ATT", "ATC", "GGG", "TTT", "ACG"]
    out = kh.murmur3_32(mat(kmers), range(5), device="cpu")
    assert out.dtype == torch.int32
    for i, k in enumerate(kmers):
        for s in range(5):
            assert out[i, s] == scalar_murmur3(k.encode(), s)


@settings(deadline=None, max_examples=40)
@given(
    st.lists(st.text(alphabet="ACGT", min_size=31, max_size=31), min_size=1, max_size=20),
    st.integers(min_value=1, max_value=5),
    st.integers(min_value=10, max_value=10 ** 7),
)
def test_row_indices_mod_matches_scalar(kmers, h, m):
    idx = kh.row_indices(mat(kmers), h, m, device="cpu")
    for i, k in enumerate(kmers):
        assert idx[i].tolist() == [scalar_murmur3(k.encode(), s) % m for s in range(h)]


@pytest.mark.parametrize("length", LENGTHS)
def test_various_lengths_match_scalar(length):
    """The k % 4 tail bytes and ``h ^= k`` with the k-mer's own length."""
    s = ("ACGTACGTACGTACGTACGTACGTACGTACGTACGT"[:length]).encode()
    out = kh.murmur3_32(np.frombuffer(s, dtype=np.uint8)[None, :], [0, 1, 99], device="cpu")
    assert out[0].tolist() == [scalar_murmur3(s, seed) for seed in (0, 1, 99)]


@pytest.mark.parametrize("length", LENGTHS)
def test_murmur3_matches_jax_and_numpy(length):
    """Any bytes, any seeds (taken mod 2^32): the JAX function, the host's
    numpy hasher and the port agree bit for bit; the hashes with the top
    bit set (negative) are where an arithmetic shift would differ."""
    rng = np.random.default_rng(length)
    data = rng.integers(0, 256, size=(64, length), dtype=np.uint8)
    seeds = np.array([0, 1, 99, 2**31, 2**32 - 1], dtype=np.uint32)
    want = np.asarray(murmur3_32_jax(jnp.asarray(data), jnp.asarray(seeds)))
    got = kh.murmur3_32(data, seeds.astype(np.int64), device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_pkg_murmur3_batch(data, seeds))
    assert (got < 0).any() and (got > 0).any()


@pytest.mark.parametrize("m", [25, 1000, 25_000_000, 2**31 - 1])
def test_row_indices_match_jax_and_host(m):
    rng = np.random.default_rng(1)
    kmers = rng.integers(65, 85, size=(64, 31), dtype=np.uint8)
    got = kh.row_indices(kmers, 3, m, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(row_indices_jax(jnp.asarray(kmers), 3, m)))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), hash_kmer_matrix(kmers, 3, m))


def test_signed_floor_mod():
    """murmur3 is a signed int32 and rows take Python's floor-mod: a
    negative hash h gives h % m in [0, m), not the unsigned (h mod 2^32)
    % m nor C's truncated remainder."""
    rng = np.random.default_rng(2)
    kmers = ACGT[rng.integers(0, 4, size=(200, 31))]
    hashes = kh.murmur3_32(kmers, [0], device="cpu")[:, 0].long()
    rows = kh.row_indices(kmers, 1, 25, device="cpu")[:, 0].long()
    neg = hashes < 0
    assert neg.any()
    assert torch.equal(rows, hashes % 25)
    assert ((rows >= 0) & (rows < 25)).all()
    unsigned = (hashes & 0xFFFFFFFF) % 25
    truncated = torch.fmod(hashes, 25)
    assert (rows[neg] != unsigned[neg]).any() and (rows[neg] != truncated[neg]).any()
    assert torch.equal(kh.signed(torch.tensor([2**32 - 5])) % 25, torch.tensor([20]))


# -- canonical k-mers ----------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 5, 8, 31, 32])
def test_canonicalize_matches_jax_and_host(k):
    """Random k-mers, reverse-complement palindromes (even k), rows with N
    and lowercase bytes (which complement to themselves), and leading
    dimensions [B, K, k]."""
    rng = np.random.default_rng(21 + k)
    kmers = ACGT[rng.integers(0, 4, size=(257, k))]
    kmers[7, 0] = ord("N")
    odd = np.frombuffer(b"ACGTNacgtn", dtype=np.uint8)
    kmers[8:40] = odd[rng.integers(0, 10, size=(32, k))]
    if k % 2 == 0:
        half = ACGT[rng.integers(0, 4, size=(16, k // 2))]
        kmers[40:56] = [np.concatenate([x, revcomp(x)]) for x in half]
    if k == 5:
        kmers[3] = np.frombuffer(b"ACGTN", dtype=np.uint8)
    want = np.asarray(canonicalize_jax(jnp.asarray(kmers)))
    got = kh.canonicalize(kmers, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_pkg_canonicalize(kmers))
    if k % 2 == 0:  # a palindrome is its own canonical form
        np.testing.assert_array_equal(got[40:56], kmers[40:56])
    batched = kh.canonicalize(kmers[:256].reshape(4, 64, k), device="cpu")
    np.testing.assert_array_equal(batched.reshape(256, k).numpy(), want[:256])


@pytest.mark.parametrize("k", [3, 9, 31])
def test_canonical_rows_in_one_launch(k):
    """kmer_rows(canonical=True), the full step's single launch, hashes
    the canonical forms: the same rows as canonicalize then row_indices,
    and as JAX's two steps."""
    rng = np.random.default_rng(k)
    kmers = ACGT[rng.integers(0, 4, size=(100, k))]
    got = fused_lookup.kmer_rows(cpu(kmers), torch.arange(3, dtype=torch.int32), "classic",
                                 canonical=True, m=4096)
    two = kh.row_indices(kh.canonicalize(kmers, device="cpu"), 3, 4096)
    want = row_indices_jax(canonicalize_jax(jnp.asarray(kmers)), 3, 4096)
    assert torch.equal(got, two)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- blocked rows ----------------------------------------------------------------


@pytest.mark.parametrize("tile_rows", [8, 24, 32, 64])
@pytest.mark.parametrize("m", [5, 20, 1000, 100_003, 25_000_000])
@pytest.mark.parametrize("h", [1, 3, 8])
def test_blocked_rows_match_scheme(tile_rows, m, h):
    """Seed 0 floor-mod max(1, m // tile_rows) the tile, seeds 1..h
    floor-mod tile_rows the slots: the port's host scheme
    (hashing/scheme.py:row_indices, layout blocked), m below tile_rows and
    m not a multiple of 32 included."""
    rng = np.random.default_rng(m + h)
    kmers = ACGT[rng.integers(0, 4, size=(300, 31))]
    got = kh.blocked_row_indices(kmers, h, m, tile_rows, device="cpu")
    want = scheme_row_indices(kmers, h, m, "blocked", tile_rows)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


# -- the staged reader's edges ---------------------------------------------------
# Kernel I reads runs of up to 128 consecutive k-mers (8,192 bytes) from
# any byte address; these hold its contract (the plain version here) to
# JAX and the host hashers where a run or a view's alignment could slip.

ODD = np.frombuffer(b"ACGTNacgtn", dtype=np.uint8)


def mixed_kmers(rng, n: int, k: int) -> np.ndarray:
    """n k-mers: ordinary ACGT ones among all-N ones, ones of N and
    lowercase bytes, and reverse-complement palindromes (an N in the
    middle at odd k), interleaved so each kind shares a run with the
    others."""
    out = ACGT[rng.integers(0, 4, size=(n, k))]
    kind = rng.integers(0, 8, n)
    out[kind == 0] = ord("N")
    out[kind == 1] = ODD[rng.integers(0, 10, size=(int((kind == 1).sum()), k))]
    for i in np.nonzero(kind >= 6)[0]:
        half = ACGT[rng.integers(0, 4, k // 2)]
        out[i] = np.concatenate([half, np.full(k % 2, ord("N"), np.uint8), revcomp(half)])
    return out


def assert_kmer_rows_match_jax(kmers: np.ndarray, t: torch.Tensor):
    """Every output of kmer_rows on ``t`` (the rows of ``kmers``, maybe a
    view) equal to JAX's: canonical bytes, raw hashes, canonical classic
    rows (and the host's rows of the canonical k-mers)."""
    canon = np.asarray(canonicalize_jax(jnp.asarray(kmers)))
    got = fused_lookup.kmer_rows(t, torch.empty(0, dtype=torch.int32), "canonical")
    np.testing.assert_array_equal(got.numpy(), canon)
    np.testing.assert_array_equal(got.numpy(), jax_pkg_canonicalize(kmers))
    seeds = np.array([0, 1, 99, 2**32 - 1], dtype=np.uint32)
    got = fused_lookup.kmer_rows(t, kh.seed_tensor(seeds, "cpu"), "hashes")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(murmur3_32_jax(jnp.asarray(kmers), jnp.asarray(seeds))))
    m = 25_000_000
    got = fused_lookup.kmer_rows(t, torch.arange(3, dtype=torch.int32), "classic",
                                 canonical=True, m=m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(row_indices_jax(jnp.asarray(canon), 3, m)))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), hash_kmer_matrix(canon, 3, m))


@pytest.mark.parametrize("n", [255, 256, 257, 4097])
@pytest.mark.parametrize("k", [31, 63, 64, 100])
def test_reader_edges_match_jax_and_host(k, n):
    """K around runs' ends (128 k-mers a run at k 31, 63 and 64, 81 at
    k = 100), mixed N, lowercase and palindromic k-mers in one run; each
    palindrome is its own canonical form."""
    kmers = mixed_kmers(np.random.default_rng(1000 * k + n), n, k)
    assert_kmer_rows_match_jax(kmers, cpu(kmers))
    canon = kh.canonicalize(kmers, device="cpu").numpy()
    pal = np.array([np.array_equal(revcomp(x), x) for x in kmers])
    assert pal.sum() > n // 16
    np.testing.assert_array_equal(canon[pal], kmers[pal])


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("k", [31, 100])
def test_offset_views_match_jax(offset, k):
    """x[1:] and x[3:]: contiguous views whose bytes start offset * k bytes
    into x, off a 16-byte boundary; the wrapper takes them as they are."""
    base = mixed_kmers(np.random.default_rng(offset + k), 600, k)
    t = cpu(base)[offset:]
    assert t.is_contiguous() and t.data_ptr() % 16 != 0
    assert_kmer_rows_match_jax(base[offset:], t)


# -- the wrapper's checks ----------------------------------------------------------


def test_kmer_rows_refuses_bad_arguments():
    km = torch.zeros((4, 31), dtype=torch.uint8)
    seeds = torch.arange(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        fused_lookup.kmer_rows(km.int(), seeds, "classic", m=100)
    with pytest.raises(ValueError):
        fused_lookup.kmer_rows(km[None], seeds, "classic", m=100)
    with pytest.raises(TypeError):
        fused_lookup.kmer_rows(km, seeds.long(), "classic", m=100)
    with pytest.raises(ValueError):
        fused_lookup.kmer_rows(km, seeds[None], "classic", m=100)
    with pytest.raises(ValueError):
        fused_lookup.kmer_rows(km, seeds, "minimizer", m=100)
    for m in (0, 2**31):
        with pytest.raises(ValueError):
            fused_lookup.kmer_rows(km, seeds, "classic", m=m)
    with pytest.raises(ValueError):
        fused_lookup.kmer_rows(km, seeds, "blocked", m=100, tile_rows=0)
    with pytest.raises(ValueError):
        fused_lookup.kmer_rows(km, seeds[:0], "blocked", m=100, tile_rows=8)
    with pytest.raises(ValueError):
        fused_lookup.kmer_rows(km.t(), seeds, "classic", m=100)  # not contiguous


def test_wrappers_refuse_non_contiguous_and_take_offset_views():
    """Kernels I and J take a contiguous uint8[K, k] from any byte address
    (a view such as x[3:]) and refuse a strided one."""
    kmers = cpu(mixed_kmers(np.random.default_rng(5), 300, 31))
    seeds = torch.arange(3, dtype=torch.int32)
    for bad in (kmers[::2], kmers[:, 1:], kmers[:31].t()):
        with pytest.raises(ValueError, match="contiguous"):
            fused_lookup.kmer_rows(bad, seeds, "classic", m=1000)
        with pytest.raises(ValueError, match="contiguous"):
            fused_lookup.bloom_scatter(bad, seeds, "classic", 1000)
    view = kmers[3:]
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    for out in ("hashes", "classic", "canonical"):
        assert torch.equal(fused_lookup.kmer_rows(view, seeds, out, canonical=True, m=1000),
                           fused_lookup.kmer_rows(view.clone(), seeds, out, canonical=True, m=1000))
    assert torch.equal(fused_lookup.bloom_scatter(view, seeds, "classic", 1000),
                       fused_lookup.bloom_scatter(view.clone(), seeds, "classic", 1000))


def test_empty_inputs():
    empty = np.zeros((0, 31), dtype=np.uint8)
    assert kh.row_indices(empty, 3, 100, device="cpu").shape == (0, 3)
    assert kh.blocked_row_indices(empty, 3, 100, 8, device="cpu").shape == (0, 3)
    assert kh.murmur3_32(np.zeros((1, 3), dtype=np.uint8), [], device="cpu").shape == (1, 0)
    assert kh.canonicalize(empty, device="cpu").shape == (0, 31)


def test_numpy_inputs_without_cuda_raise(monkeypatch):
    """device=None means CUDA, and a CUDA request without CUDA raises:
    nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kmers = mat(["ATT"])
    for call in (lambda: kh.murmur3_32(kmers, [0]), lambda: kh.canonicalize(kmers),
                 lambda: kh.row_indices(kmers, 3, 25),
                 lambda: kh.blocked_row_indices(kmers, 3, 64, 8),
                 lambda: kh.row_indices(kmers, 3, 25, device="cuda")):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            call()
    # a tensor runs where it lies
    assert kh.row_indices(cpu(kmers), 3, 25).device.type == "cpu"
