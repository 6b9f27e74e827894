"""bigsi_tpu_torch.ops.prep (the plain version of kernel H) against the JAX
package's ``prep_streams_device`` (JAX on the CPU) and against numpy
uint64: the same padded query bytes, identical utile, gmask, n_valid and
ok (tolerance zero: integers and bit words)."""

import numpy as np
import pytest
import torch

from bigsi_tpu.hashing.scheme import MINIMIZER_SEED, pack_codes_v3
from bigsi_tpu.hashing.scheme import splitmix64 as np_splitmix64
from bigsi_tpu.ops.prep_jax import prep_streams_device
from bigsi_tpu_torch.ops import fused_lookup, prep

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
U64 = 2**64


def rand_seqs(rng, b, l):
    return BASES[rng.integers(0, 4, size=(b, l))]


def as_u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def as_t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def edge_u64(rng, n):
    """Random uint64 values, half of them with bit 63 set, plus the edges."""
    vals = rng.integers(0, U64, size=n, dtype=np.uint64)
    vals[: n // 2] |= np.uint64(1 << 63)
    edges = [0, 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1, 2**63, U64 - 2, U64 - 1]
    return np.concatenate([vals, np.array(edges, dtype=np.uint64)])


# -- the 64-bit helpers ---------------------------------------------------------


def test_splitmix64_matches_scheme_on_values_with_bit_63_set():
    vals = edge_u64(np.random.default_rng(0), 513)
    np.testing.assert_array_equal(as_u64(prep.splitmix64(as_t(vals))), np_splitmix64(vals))


def test_int64_multiplication_and_addition_wrap_like_uint64():
    rng = np.random.default_rng(1)
    a, b = edge_u64(rng, 200), edge_u64(rng, 200)[::-1].copy()
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(as_u64(as_t(a) * as_t(b)), a * b)
        np.testing.assert_array_equal(as_u64(as_t(a) + prep.SM_GAMMA),
                                      a + np.uint64(0x9E3779B97F4A7C15))


@pytest.mark.parametrize("n", [0, 1, 6, 27, 30, 31, 32, 33, 63])
def test_shr_is_a_logical_shift(n):
    vals = edge_u64(np.random.default_rng(n), 100)
    np.testing.assert_array_equal(as_u64(prep.shr(as_t(vals), n)), vals >> np.uint64(n))


def test_unsigned_min_and_compare():
    rng = np.random.default_rng(2)
    a, b = edge_u64(rng, 300), edge_u64(rng, 300)
    b[::3] = a[::3]  # ties
    np.testing.assert_array_equal(prep.ult(as_t(a), as_t(b)).numpy(), a < b)
    np.testing.assert_array_equal(as_u64(prep.umin(as_t(a), as_t(b))), np.minimum(a, b))


@pytest.mark.parametrize("d", [1, 3, 7, 16, 781_250, 1_562_500, (1 << 28) - 1, 1 << 20,
                               (1 << 31) - 1])
def test_unsigned_modulus(d):
    vals = edge_u64(np.random.default_rng(d), 200)
    np.testing.assert_array_equal(prep.umod(as_t(vals), d).numpy().astype(np.uint64),
                                  vals % np.uint64(d))


@pytest.mark.parametrize("length", [1, 13, 21, 31, 32])
def test_windows_match_pack_codes_v3_with_non_acgt_bytes(length):
    rng = np.random.default_rng(length)
    alphabet = np.frombuffer(b"ACGTNacgt-", dtype=np.uint8)
    seq = alphabet[rng.integers(0, len(alphabet), size=(1, 90))]
    kmers = np.lib.stride_tricks.sliding_window_view(seq[0], length)
    want_f, want_rc = pack_codes_v3(np.ascontiguousarray(kmers))
    t = torch.from_numpy(seq)
    fwd, canon = prep.canonical(prep.byte_codes(t), prep.byte_comp_codes(t), length)
    np.testing.assert_array_equal(as_u64(fwd[0]), want_f)
    np.testing.assert_array_equal(as_u64(canon[0]), np.minimum(want_f, want_rc))


# -- prep_streams against the JAX package ----------------------------------------


def assert_prep_matches_jax(seqs, lens, **kw):
    """-> ok; every output equal to prep_streams_device's."""
    want = [np.asarray(x) for x in prep_streams_device(seqs, lens, seed=MINIMIZER_SEED, **kw)]
    got = prep.prep_streams(torch.from_numpy(seqs), torch.from_numpy(lens), **kw)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int64
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.bool and got[3].dim() == 0
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1].astype(np.int64))
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert bool(got[3]) == bool(want[3])
    return bool(got[3])


def headline_kw(k=31, window=19, tile_rows=16, r=20, num_tiles=1_562_500, u_cap=96, h=3):
    return dict(k=k, s=k - window + 1, num_tiles=num_tiles, h=h, tile_rows=tile_rows, r=r,
                u_cap=u_cap)


@pytest.mark.parametrize("window,tile_rows,r,num_tiles", [
    (3, 8, 4, 4099),            # short window: many short runs
    (11, 32, 6, 781_250),       # the default minimizer/32 config
    (19, 16, 20, 1_562_500),    # the headline minimizer/16 config
])
def test_prep_matches_jax_by_window(window, tile_rows, r, num_tiles):
    rng = np.random.default_rng(window)
    seqs = rand_seqs(rng, 5, 160)
    lens = np.array([160, 150, 97, 40, 31], dtype=np.int32)
    assert assert_prep_matches_jax(seqs, lens, **headline_kw(
        window=window, tile_rows=tile_rows, r=r, num_tiles=num_tiles, u_cap=130))


@pytest.mark.parametrize("k,window", [(15, 3), (15, 11), (31, 19), (32, 11), (32, 19)])
def test_prep_matches_jax_by_k(k, window):
    rng = np.random.default_rng(k * 100 + window)
    seqs = rand_seqs(rng, 4, 120)
    lens = np.array([120, 119, k + 5, 0], dtype=np.int32)
    assert_prep_matches_jax(seqs, lens, **headline_kw(k=k, window=window, u_cap=100, h=4))


def test_poly_t_at_k32_is_one_distinct_kmer():
    """The all-T 32-mer's code is 2^64 - 1 (int64 -1 here)."""
    seqs = np.full((3, 48), ord("T"), dtype=np.uint8)
    seqs[1] = ord("A")  # poly-A: poly-T's reverse complement, a k-mer of its own
    seqs[2, 20:] = ord("A")  # T^20 A^28: 17 distinct k-mers
    lens = np.array([48, 48, 48], dtype=np.int32)
    kw = dict(k=32, s=13, num_tiles=1024, h=3, tile_rows=16, r=21, u_cap=9)
    assert assert_prep_matches_jax(seqs, lens, **kw)
    n_valid = prep.prep_streams(torch.from_numpy(seqs), torch.from_numpy(lens), **kw)[2]
    assert n_valid.tolist() == [1, 1, 17]


@pytest.mark.parametrize("num_tiles", [1, 2, 1024, 1 << 20, 4097, 1_562_500, (1 << 28) - 1])
def test_prep_matches_jax_by_num_tiles(num_tiles):
    rng = np.random.default_rng(num_tiles % 1000)
    seqs = rand_seqs(rng, 3, 100)
    lens = np.full(3, 100, dtype=np.int32)
    assert_prep_matches_jax(seqs, lens, **headline_kw(num_tiles=num_tiles, u_cap=70))


@pytest.mark.parametrize("lens", [[0, 0], [30, 5], [31, 31], [32, 0], [95, 31]])
def test_prep_matches_jax_on_short_and_empty_queries(lens):
    rng = np.random.default_rng(sum(lens))
    seqs = rand_seqs(rng, 2, 95)
    seqs[:, 60:] = ord("G")  # padding bytes are arbitrary
    assert assert_prep_matches_jax(seqs, np.array(lens, dtype=np.int32), **headline_kw())


@pytest.mark.parametrize("gap", [200, 700, 2900])
def test_duplicates_keep_their_slot_with_mask_zero(gap):
    """Planted repeats within 1,024 positions and across them (2,900
    bytes apart: the JAX prep's PREP_CHUNK boundary lies between): the
    first occurrence wins, the repeat keeps its slot with mask 0."""
    rng = np.random.default_rng(gap)
    l = gap + 200
    seqs = rand_seqs(rng, 2, l)
    seqs[0, gap : gap + 120] = seqs[0, 10:130]
    lens = np.array([l, l - 7], dtype=np.int32)
    kw = headline_kw(u_cap=l // 5)
    assert assert_prep_matches_jax(seqs, lens, **kw)
    _, gmask, n_valid, _ = prep.prep_streams(torch.from_numpy(seqs), torch.from_numpy(lens), **kw)
    # n_valid is the reference's len(set(kmers)) over raw strings
    for q, n in enumerate(lens):
        assert int(n_valid[q]) == len({bytes(seqs[q, i : i + 31]) for i in range(n - 31 + 1)})
    assert int(n_valid[0]) <= l - 31 + 1 - (120 - 31 + 1)  # the repeats were found
    # each repeat keeps its slot, with mask 0: the query's nonzero masks
    # are exactly its distinct k-mers
    assert int((gmask[0] != 0).sum()) == int(n_valid[0])


def test_a_kmer_beside_its_reverse_complement_counts_twice():
    """The dedup key is the forward code, not the canonical one: a query
    holding a k-mer and its reverse complement keeps both, as the
    reference's set(kmers) over raw strings does."""
    rng = np.random.default_rng(5)
    fwd = rand_seqs(rng, 1, 31)[0]
    comp = {ord("A"): ord("T"), ord("C"): ord("G"), ord("G"): ord("C"), ord("T"): ord("A")}
    rc = np.array([comp[c] for c in fwd[::-1]], dtype=np.uint8)
    seqs = np.concatenate([fwd, rc, fwd])[None, :]
    lens = np.array([93], dtype=np.int32)
    kw = headline_kw(u_cap=63)
    assert assert_prep_matches_jax(seqs, lens, **kw)
    utile, gmask, n_valid, _ = prep.prep_streams(torch.from_numpy(seqs), torch.from_numpy(lens),
                                                 **kw)
    # positions 0 and 31 share the canonical k-mer, so its tile and mask
    nonzero = gmask[0][gmask[0] != 0]
    assert int(n_valid[0]) == 62 and int(nonzero.numel()) == 62


@pytest.mark.parametrize("u_cap", [0, 1, 2, 5])
def test_overflow_writes_nothing_past_u_cap(u_cap):
    rng = np.random.default_rng(9)
    seqs = rand_seqs(rng, 2, 110)
    lens = np.full(2, 110, dtype=np.int32)
    kw = dict(k=31, s=21, num_tiles=1 << 20, h=3, tile_rows=16, r=4, u_cap=u_cap)
    assert not assert_prep_matches_jax(seqs, lens, **kw)


def test_prep_without_queries():
    seqs = torch.zeros((0, 64), dtype=torch.uint8)
    utile, gmask, n_valid, ok = prep.prep_streams(
        seqs, torch.zeros(0, dtype=torch.int32), **headline_kw())
    assert utile.shape == (0, 96) and gmask.shape == (0, 96, 20) and n_valid.shape == (0,)
    assert bool(ok)


# -- the wrapper of kernel H on the CPU ---------------------------------------------


def test_seq_streams_runs_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(4)
    seqs = torch.from_numpy(rand_seqs(rng, 3, 90))
    lens = torch.tensor([90, 60, 12], dtype=torch.int32)
    before = fused_lookup.seq_streams.launches
    got = fused_lookup.seq_streams(seqs, lens, **headline_kw())
    want = prep.prep_streams(seqs, lens, **headline_kw())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fused_lookup.seq_streams.launches == before


def test_seq_streams_checks_its_arguments():
    seqs = torch.full((2, 64), ord("A"), dtype=torch.uint8)
    lens = torch.full((2,), 64, dtype=torch.int32)
    kw = headline_kw()
    with pytest.raises(TypeError):
        fused_lookup.seq_streams(seqs.int(), lens, **kw)
    with pytest.raises(TypeError):
        fused_lookup.seq_streams(seqs, lens.long(), **kw)
    with pytest.raises(ValueError):
        fused_lookup.seq_streams(seqs, lens[:1], **kw)
    with pytest.raises(ValueError):
        fused_lookup.seq_streams(seqs[:, :20], lens, **kw)  # L < k
    for bad in (dict(tile_rows=64), dict(tile_rows=24), dict(h=11), dict(k=33, s=13),
                dict(num_tiles=0), dict(num_tiles=1 << 31), dict(r=0), dict(u_cap=-1)):
        with pytest.raises(ValueError):
            fused_lookup.seq_streams(seqs, lens, **dict(kw, **bad))
    with pytest.raises(ValueError):
        fused_lookup.seq_streams(seqs.to("meta"), lens.to("meta"), **kw)
