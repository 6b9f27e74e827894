// bigsi_tpu_torch's native host runtime: the build-path data plane.
// bigsi_tpu's native/bigsi_native.cpp, copied so the port builds and
// loads its own library (bigsi_tpu_torch/native.py).
//
// TPU-native equivalents of the reference's native substrate
// (SURVEY.md §2.2): mmh3's MurmurHash3_x86_32 (bigsi/bloom/
// bloomfilter.py:5-13 binds the C++ mmh3 wheel), bitarray's packed-bit
// ops, and the numpy transpose (bigsi/matrix/transpose.py:33-43).
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).
//
// Layout contracts (must match bigsi_tpu_torch/matrix/packing.py):
//   * bloom files / bloom bitmaps: MSB-first within each byte
//   * matrix rows: little-endian uint32, LSB-first within each word
//   * 2-bit cortex kmer words: see bigsi_tpu_torch/io/cortex.py

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <algorithm>
#include <thread>
#include <vector>

#if defined(__AVX512F__)
#include <immintrin.h>
#define BIGSI_AVX512 1
#endif

extern "C" {

// ---------------------------------------------------------------- murmur3

static inline uint32_t rotl32(uint32_t x, int8_t r) {
  return (x << r) | (x >> (32 - r));
}

static inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// MurmurHash3_x86_32 of one key.
uint32_t murmur3_32(const uint8_t* data, int len, uint32_t seed) {
  const int nblocks = len / 4;
  uint32_t h1 = seed;
  const uint32_t c1 = 0xcc9e2d51u, c2 = 0x1b873593u;
  for (int i = 0; i < nblocks; i++) {
    uint32_t k1;
    std::memcpy(&k1, data + 4 * i, 4);
    k1 *= c1; k1 = rotl32(k1, 15); k1 *= c2;
    h1 ^= k1; h1 = rotl32(h1, 13); h1 = h1 * 5 + 0xe6546b64u;
  }
  const uint8_t* tail = data + nblocks * 4;
  uint32_t k1 = 0;
  switch (len & 3) {
    case 3: k1 ^= (uint32_t)tail[2] << 16; [[fallthrough]];
    case 2: k1 ^= (uint32_t)tail[1] << 8;  [[fallthrough]];
    case 1: k1 ^= tail[0];
            k1 *= c1; k1 = rotl32(k1, 15); k1 *= c2; h1 ^= k1;
  }
  h1 ^= (uint32_t)len;
  return fmix32(h1);
}

// Batch: K keys of fixed length k (row-major [K, k]) x h seeds 0..h-1,
// bucket = ((int32_t)hash) mod m with Python floor-mod semantics.
// out: int64 [K, h].
void hash_kmer_batch(const uint8_t* kmers, int64_t K, int k, int h,
                     int64_t m, int64_t* out) {
  for (int64_t i = 0; i < K; i++) {
    const uint8_t* key = kmers + i * k;
    for (int s = 0; s < h; s++) {
      int32_t v = (int32_t)murmur3_32(key, k, (uint32_t)s);
      int64_t r = (int64_t)v % m;
      if (r < 0) r += m;
      out[i * h + s] = r;
    }
  }
}

// ---------------------------------------------------------------- bloom

// Set bloom bits (byte bitmap, one byte per bit for simplicity on the
// host side) for K fixed-length kmers.
void bloom_insert_batch(const uint8_t* kmers, int64_t K, int k, int h,
                        int64_t m, uint8_t* bloom) {
  for (int64_t i = 0; i < K; i++) {
    const uint8_t* key = kmers + i * k;
    for (int s = 0; s < h; s++) {
      int32_t v = (int32_t)murmur3_32(key, k, (uint32_t)s);
      int64_t r = (int64_t)v % m;
      if (r < 0) r += m;
      bloom[r] = 1;
    }
  }
}

// ------------------------------------------------------------- transpose

// Transpose N bloom byte-bitmaps (bloom[n][row] in {0,1}, each length
// num_rows) into packed uint32 bitslice rows out[num_rows][W_out]
// (LSB-first: sample n -> word n>>5, bit n&31).  blooms: pointer array.
void transpose_blooms(const uint8_t* const* blooms, int64_t n,
                      int64_t num_rows, uint32_t* out, int64_t w_out) {
  std::memset(out, 0, sizeof(uint32_t) * (size_t)(num_rows * w_out));
  for (int64_t s = 0; s < n; s++) {
    const uint8_t* b = blooms[s];
    const int64_t w = s >> 5;
    const uint32_t bit = 1u << (s & 31);
    uint32_t* col = out + w;
    for (int64_t r = 0; r < num_rows; r++) {
      if (b[r]) col[r * w_out] |= bit;
    }
  }
}

// Pack an MSB-first bloom byte stream (as stored in .bloom files) into
// a 0/1 byte bitmap.
void unpack_bloom_bytes(const uint8_t* data, int64_t nbytes, uint8_t* out) {
  for (int64_t i = 0; i < nbytes; i++) {
    uint8_t v = data[i];
    uint8_t* o = out + i * 8;
    o[0] = (v >> 7) & 1; o[1] = (v >> 6) & 1; o[2] = (v >> 5) & 1;
    o[3] = (v >> 4) & 1; o[4] = (v >> 3) & 1; o[5] = (v >> 2) & 1;
    o[6] = (v >> 1) & 1; o[7] = v & 1;
  }
}

// ---------------------------------------------------------------- cortex

// Decode R cortex-packed uint64 kmers to ASCII [R, k]
// (bit layout: bigsi_tpu_torch/io/cortex.py docstring).
void decode_cortex_kmers(const uint64_t* packed, int64_t R, int k,
                         uint8_t* out) {
  static const char BASES[4] = {'A', 'G', 'C', 'T'};
  for (int64_t i = 0; i < R; i++) {
    uint64_t v = packed[i];
    uint8_t* row = out + (int64_t)i * k;
    for (int p = 0; p < k; p++) {
      int j = k - 1 - p;
      unsigned lo = (v >> (2 * j)) & 1u;
      unsigned hi = (v >> (2 * j + 1)) & 1u;
      row[p] = (uint8_t)BASES[lo * 2 + hi];
    }
  }
}

// Canonicalize ASCII kmers in place: row = min(row, revcomp(row)).
void canonicalize_kmers(uint8_t* kmers, int64_t K, int k) {
  uint8_t comp[256];
  for (int i = 0; i < 256; i++) comp[i] = (uint8_t)i;
  comp['A'] = 'T'; comp['T'] = 'A'; comp['C'] = 'G'; comp['G'] = 'C';
  uint8_t rc[64];
  for (int64_t i = 0; i < K; i++) {
    uint8_t* row = kmers + i * k;
    for (int p = 0; p < k; p++) rc[p] = comp[row[k - 1 - p]];
    if (std::memcmp(rc, row, (size_t)k) < 0) std::memcpy(row, rc, (size_t)k);
  }
}

// ------------------------------------------------------------ minimizer

// Strand-invariant minimizer tile per k-mer (the serving hot path's
// host side; numpy version in bigsi_tpu_torch/hashing/scheme.py
// minimizer_tiles costs ~530 ms per [256, 512] query batch — it hashes
// every s-mer window of every k-mer twice).  Semantics are identical:
// tile = (min over the k-mer's w = k-s+1 windows of
//         min(murmur3(smer), murmur3(revcomp(smer)))) % num_tiles.
//
// Rolling reuse: consecutive rows of a query's k-mer matrix overlap by
// k-1 bytes (sliding window k-mers, order-preserving dedupe), so row
// i+1's windows are row i's shifted by one plus ONE new window.  The
// overlap is detected by memcmp, so the routine is correct for any
// input ordering — overlap only makes it ~10x faster.  The tile is
// invariant under reverse-complement of the whole k-mer (the window
// hash set is identical), so callers may pass pre-canonical k-mers,
// which preserve overlap where canonicalized ones would break it.
void minimizer_tiles_batch(const uint8_t* kmers, int64_t K, int k, int s,
                           uint32_t seed, int64_t num_tiles, int64_t* out) {
  if (s < 1 || s > k || s > 64 || k - s + 1 > 64 || K <= 0) return;
  const int w = k - s + 1;
  uint8_t comp[256];
  for (int i = 0; i < 256; i++) comp[i] = (uint8_t)i;
  comp['A'] = 'T'; comp['T'] = 'A'; comp['C'] = 'G'; comp['G'] = 'C';
  uint32_t hw[64];  // window hashes, hw[p] for window at byte offset p
  uint8_t rc[64];
  auto window_hash = [&](const uint8_t* smer) -> uint32_t {
    uint32_t hf = murmur3_32(smer, s, seed);
    for (int j = 0; j < s; j++) rc[j] = comp[smer[s - 1 - j]];
    uint32_t hr = murmur3_32(rc, s, seed);
    return hf < hr ? hf : hr;
  };
  bool have_prev = false;
  for (int64_t i = 0; i < K; i++) {
    const uint8_t* row = kmers + i * k;
    if (have_prev && w > 1 &&
        std::memcmp(row, kmers + (i - 1) * k + 1, (size_t)(k - 1)) == 0) {
      std::memmove(hw, hw + 1, sizeof(uint32_t) * (size_t)(w - 1));
      hw[w - 1] = window_hash(row + (w - 1));
    } else {
      for (int p = 0; p < w; p++) hw[p] = window_hash(row + p);
    }
    uint32_t mn = hw[0];
    for (int p = 1; p < w; p++) {
      if (hw[p] < mn) mn = hw[p];
    }
    out[i] = (int64_t)((uint64_t)mn % (uint64_t)num_tiles);
    have_prev = true;
  }
}

// ----------------------------------------------- minimizer slot-scheme v2
//
// Serving-oriented hash scheme for the minimizer layout (an index-wide
// build-time choice persisted in the manifest as ksi:slot_scheme=2; the
// reference has no analogue — its only scheme is classic h-murmur,
// bigsi/bloom/bloomfilter.py:5-13, which stays bit-exact in scheme v1):
//
//   * window order hash = murmur3(canonical s-mer, seed), where
//     canonical s-mer = lexicographic min(smer, revcomp(smer)) — ONE
//     murmur per window instead of v1's min(h(smer), h(rc)).
//   * slot_j = (murmur3(canonical kmer, 0) >> (6*j)) % tile_rows —
//     h slots from disjoint bit fields of ONE murmur instead of h
//     independent murmurs (needs 6*h <= 32, i.e. h <= 5).
//
// Both remain strand-invariant.  This is 3x less host hashing on the
// serving critical path (the numpy oracle lives in
// bigsi_tpu_torch/hashing/scheme.py and is parity-tested against this file).

// 16-lane MurmurHash3_x86_32 over 16 independent keys of one fixed
// length (AVX-512: two 8-lane 64-bit-pointer gathers per 4-byte block).
// Bit-exact with murmur3_32 — the serving prep's hash engine; the
// scalar path remains both the fallback and the parity oracle
// (tests/test_native.py).
#ifdef BIGSI_AVX512
static inline __m512i rotl512(__m512i x, int r) {
  return _mm512_or_si512(_mm512_slli_epi32(x, r),
                         _mm512_srli_epi32(x, 32 - r));
}

static void murmur3_32_x16(const uint8_t* const* keys, int len,
                           uint32_t seed, uint32_t* out) {
  const __m512i c1 = _mm512_set1_epi32((int)0xcc9e2d51u);
  const __m512i c2 = _mm512_set1_epi32((int)0x1b873593u);
  __m512i h1 = _mm512_set1_epi32((int)seed);
  const int nblocks = len / 4;
  __m512i lo_ptr = _mm512_loadu_si512(keys);      // keys[0..7]
  __m512i hi_ptr = _mm512_loadu_si512(keys + 8);  // keys[8..15]
  for (int i = 0; i < nblocks; i++) {
    const __m256i lo =
        _mm512_i64gather_epi32(_mm512_add_epi64(lo_ptr, _mm512_set1_epi64(4 * i)),
                               nullptr, 1);
    const __m256i hi =
        _mm512_i64gather_epi32(_mm512_add_epi64(hi_ptr, _mm512_set1_epi64(4 * i)),
                               nullptr, 1);
    __m512i k1 = _mm512_inserti64x4(_mm512_castsi256_si512(lo), hi, 1);
    k1 = _mm512_mullo_epi32(k1, c1);
    k1 = rotl512(k1, 15);
    k1 = _mm512_mullo_epi32(k1, c2);
    h1 = _mm512_xor_si512(h1, k1);
    h1 = rotl512(h1, 13);
    h1 = _mm512_add_epi32(
        _mm512_mullo_epi32(h1, _mm512_set1_epi32(5)),
        _mm512_set1_epi32((int)0xe6546b64u));
  }
  const int ntail = len & 3;
  if (ntail) {
    // gather the last full word containing the tail bytes is unsafe at
    // buffer ends; assemble the tail scalar per lane (rare: len%4 != 0)
    alignas(64) uint32_t k1s[16];
    for (int l = 0; l < 16; l++) {
      const uint8_t* tail = keys[l] + nblocks * 4;
      uint32_t k1 = 0;
      if (ntail >= 3) k1 ^= (uint32_t)tail[2] << 16;
      if (ntail >= 2) k1 ^= (uint32_t)tail[1] << 8;
      k1 ^= tail[0];
      k1s[l] = k1;
    }
    __m512i k1 = _mm512_load_si512(k1s);
    k1 = _mm512_mullo_epi32(k1, c1);
    k1 = rotl512(k1, 15);
    k1 = _mm512_mullo_epi32(k1, c2);
    h1 = _mm512_xor_si512(h1, k1);
  }
  h1 = _mm512_xor_si512(h1, _mm512_set1_epi32(len));
  h1 = _mm512_xor_si512(h1, _mm512_srli_epi32(h1, 16));
  h1 = _mm512_mullo_epi32(h1, _mm512_set1_epi32((int)0x85ebca6bu));
  h1 = _mm512_xor_si512(h1, _mm512_srli_epi32(h1, 13));
  h1 = _mm512_mullo_epi32(h1, _mm512_set1_epi32((int)0xc2b2ae35u));
  h1 = _mm512_xor_si512(h1, _mm512_srli_epi32(h1, 16));
  _mm512_storeu_si512(out, h1);
}
#endif  // BIGSI_AVX512

// Hash a batch of keys (pointer array, fixed len) with one seed —
// SIMD 16 at a time when available, scalar otherwise/remainder.
static void hash_ptr_batch(const uint8_t* const* keys, int64_t n, int len,
                           uint32_t seed, uint32_t* out) {
  int64_t i = 0;
#ifdef BIGSI_AVX512
  for (; i + 16 <= n; i += 16) murmur3_32_x16(keys + i, len, seed, out + i);
#endif
  for (; i < n; i++) out[i] = murmur3_32(keys[i], len, seed);
}

struct RollState {
  // Reverse-complement arena, written right-to-left so the rc of the
  // CURRENT kmer is the contiguous range [p, p+k).  Grows strictly
  // leftward (``floor`` = lowest used index): a segment reset starts
  // BELOW everything already written, so pointers into earlier
  // segments stay valid for deferred (batched) hashing.
  std::vector<uint8_t> rc;
  int64_t p = 0;
  int64_t floor = 0;
  uint32_t hw[64];  // rolling window-order hashes
  bool have_prev = false;
};

static inline uint32_t window_hash_v2(const uint8_t* fwd, const uint8_t* rc,
                                      int s, uint32_t seed) {
  const uint8_t* key = std::memcmp(fwd, rc, (size_t)s) <= 0 ? fwd : rc;
  return murmur3_32(key, s, seed);
}

static const uint8_t* COMP_TABLE() {
  static uint8_t comp[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; i++) comp[i] = (uint8_t)i;
    comp['A'] = 'T'; comp['T'] = 'A'; comp['C'] = 'G'; comp['G'] = 'C';
    init = true;
  }
  return comp;
}

// Per-kmer v2 tile ids with rolling-window reuse (standalone variant of
// the fused prep below, for the build path and layout experiments).
void minimizer_tiles_v2(const uint8_t* kmers, int64_t K, int k, int s,
                        uint32_t seed, int64_t num_tiles, int64_t* out) {
  if (s < 1 || s > k || s > 64 || k - s + 1 > 64 || K <= 0) return;
  const int w = k - s + 1;
  const uint8_t* comp = COMP_TABLE();
  RollState st;
  st.rc.resize((size_t)(K + k));
  st.floor = (int64_t)st.rc.size();
  for (int64_t i = 0; i < K; i++) {
    const uint8_t* row = kmers + i * k;
    const bool overlap =
        st.have_prev &&
        std::memcmp(row, kmers + (i - 1) * k + 1, (size_t)(k - 1)) == 0;
    if (overlap) {
      st.p -= 1;
      st.rc[(size_t)st.p] = comp[row[k - 1]];
      if (w > 1)
        std::memmove(st.hw, st.hw + 1, sizeof(uint32_t) * (size_t)(w - 1));
      // new window = last window of this row; its rc smer starts at p
      st.hw[w - 1] =
          window_hash_v2(row + (w - 1), st.rc.data() + st.p, s, seed);
    } else {
      st.p = (int64_t)st.rc.size() - k;
      for (int j = 0; j < k; j++)
        st.rc[(size_t)(st.p + j)] = comp[row[k - 1 - j]];
      // rc smer of window j starts at rc offset (k - s - j)
      for (int j = 0; j < w; j++)
        st.hw[j] = window_hash_v2(row + j, st.rc.data() + st.p + (k - s - j),
                                  s, seed);
    }
    uint32_t mn = st.hw[0];
    for (int j = 1; j < w; j++) mn = std::min(mn, st.hw[j]);
    out[i] = (int64_t)((uint64_t)mn % (uint64_t)num_tiles);
    st.have_prev = true;
  }
}

// Fused serving prep (minimizer layout, slot scheme v2): raw ASCII
// k-mer rows in, grouped device streams out — tiles (rolling canonical
// s-mer minimizer), canonical pick (rc-buffer pointer select, no
// copies), slot mask (one murmur), and grouped-stream building in one
// pass, threaded over queries.  Replaces the 4-stage
// canonicalize/minimizer/hash/streams serving prep (~28 ms per
// [256, 512] batch) with one ~3 ms call.
//
// kmers: [n, k] rows, concatenated per-query sliding windows (deduped
// order-preserving; overlap only accelerates, never required).
// qstart: [B+1] row offsets per query.  utile [B, K_cap] and
// gmask [B, K_cap, r] must be zeroed by the caller; n_valid [B].
// Returns the max entry count over the batch (callers bucket it), or
// -1 on invalid parameters.
int64_t prep_minimizer_v2(const uint8_t* kmers, const int64_t* qstart,
                          int64_t B, int k, int s, uint32_t seed,
                          int64_t num_tiles, int h, int tile_rows, int r,
                          int64_t K_cap, int nthreads, int32_t* utile,
                          uint32_t* gmask, int32_t* n_valid) {
  if (s < 1 || s > k || s > 64 || k - s + 1 > 64 || h < 1 || h > 5 ||
      tile_rows < 1 || r < 1 || B < 0 || num_tiles < 1)
    return -1;
  const int w = k - s + 1;
  const uint8_t* comp = COMP_TABLE();
  if (nthreads < 1) nthreads = 1;
  if (nthreads > B) nthreads = B > 0 ? (int)B : 1;
  std::vector<int64_t> u_max_per((size_t)std::max(nthreads, 1), 0);

  auto run = [&](int t, int64_t b0, int64_t b1) {
    // Three passes per query so the murmurs run 16-wide (AVX-512):
    //   A (scalar): rc buffer + overlap detection -> canonical s-mer
    //     pointer per DISTINCT window, canonical k-mer pointer per row;
    //   B (SIMD): batch-hash both pointer lists (hash_ptr_batch);
    //   C (scalar): rolling window minima -> tile, slot mask, streams.
    RollState st;
    int64_t max_rows = 0;
    for (int64_t q = b0; q < b1; q++)
      max_rows = std::max(max_rows, qstart[q + 1] - qstart[q]);
    // arena worst case: every row opens a segment (k bytes each) —
    // pointers into earlier segments must stay valid until pass B
    st.rc.resize((size_t)(max_rows * (int64_t)k + k));
    // worst case (no row overlap): w distinct windows per row
    std::vector<const uint8_t*> wptr((size_t)(max_rows * (int64_t)w + 16));
    std::vector<uint32_t> whash(wptr.size());
    std::vector<const uint8_t*> kptr((size_t)max_rows + 16);
    std::vector<uint32_t> khash(kptr.size());
    std::vector<int64_t> wbase((size_t)max_rows + 1);
    int64_t u_max = 0;
    for (int64_t q = b0; q < b1; q++) {
      const int64_t r0 = qstart[q], r1 = qstart[q + 1];
      const int64_t nrow = r1 - r0;
      n_valid[q] = (int32_t)nrow;
      // -- pass A: canonical pointers
      int64_t nw = 0;
      st.have_prev = false;
      st.floor = (int64_t)st.rc.size();
      for (int64_t i = r0; i < r1; i++) {
        const uint8_t* row = kmers + i * k;
        const bool overlap =
            st.have_prev &&
            std::memcmp(row, kmers + (i - 1) * k + 1, (size_t)(k - 1)) == 0;
        if (overlap) {
          st.p -= 1;
          st.rc[(size_t)st.p] = comp[row[k - 1]];
          // one new window: the row's LAST (its rc s-mer starts at p)
          const uint8_t* f = row + (w - 1);
          const uint8_t* rcp = st.rc.data() + st.p;
          wptr[(size_t)nw++] =
              std::memcmp(f, rcp, (size_t)s) <= 0 ? f : rcp;
        } else {
          st.p = st.floor - k;  // fresh segment BELOW all earlier ones
          for (int j = 0; j < k; j++)
            st.rc[(size_t)(st.p + j)] = comp[row[k - 1 - j]];
          for (int j = 0; j < w; j++) {
            const uint8_t* f = row + j;
            const uint8_t* rcp = st.rc.data() + st.p + (k - s - j);
            wptr[(size_t)nw++] =
                std::memcmp(f, rcp, (size_t)s) <= 0 ? f : rcp;
          }
        }
        wbase[(size_t)(i - r0)] = nw - w;  // row windows = [nw-w, nw)
        // canonical kmer = lexmin(row, rc) -- pointer pick, no copy
        kptr[(size_t)(i - r0)] =
            std::memcmp(row, st.rc.data() + st.p, (size_t)k) <= 0
                ? row
                : st.rc.data() + st.p;
        st.have_prev = true;
        st.floor = st.p;
      }
      // -- pass B: 16-wide murmurs
      hash_ptr_batch(wptr.data(), nw, s, seed, whash.data());
      hash_ptr_batch(kptr.data(), nrow, k, 0, khash.data());
      // -- pass C: window minima + slot masks + grouped streams
      int32_t* urow = utile + q * K_cap;
      uint32_t* grow = gmask + q * K_cap * r;
      int64_t entry = -1;
      int32_t cur_tile = -1;
      int slot = r;
      for (int64_t i = 0; i < nrow; i++) {
        const uint32_t* hwv = whash.data() + wbase[(size_t)i];
        uint32_t mn = hwv[0];
        for (int j = 1; j < w; j++) mn = std::min(mn, hwv[j]);
        const int32_t tile = (int32_t)((uint64_t)mn % (uint64_t)num_tiles);
        const uint32_t hv = khash[(size_t)i];
        uint32_t smask = 0;
        for (int j = 0; j < h; j++)
          smask |= 1u << ((hv >> (6 * j)) % (uint32_t)tile_rows);
        if (entry < 0 || tile != cur_tile || slot == r) {
          entry++;
          cur_tile = tile;
          urow[entry] = tile;
          slot = 0;
        }
        grow[entry * r + slot] = smask;
        slot++;
      }
      u_max = std::max(u_max, entry + 1);
    }
    u_max_per[(size_t)t] = u_max;
  };

  if (nthreads <= 1 || B <= 1) {
    run(0, 0, B);
    return u_max_per[0];
  }
  std::vector<std::thread> threads;
  const int64_t per = (B + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    const int64_t b0 = (int64_t)t * per;
    const int64_t b1 = std::min(B, b0 + per);
    if (b0 >= b1) break;
    threads.emplace_back(run, t, b0, b1);
  }
  for (auto& th : threads) th.join();
  int64_t u_max = 0;
  for (int64_t v : u_max_per) u_max = std::max(u_max, v);
  return u_max;
}

// ----------------------------------------------- minimizer slot-scheme v3
//
// Rolling-hash serving scheme (persisted as ksi:slot_scheme=3; the
// serving default for new minimizer builds): k-mers and s-mers are
// 2-bit packed (A=0 C=1 G=2 T=3, other bytes -> 0) into uint64 codes
// maintained INCREMENTALLY along the sliding window — O(1) per k-mer,
// no byte hashing at all:
//
//   canon = min(fwd_code, rc_code)       (MSB-first packing preserves
//                                         lexicographic order on ACGT)
//   slot_j = (splitmix64(canon_kmer) >> (6*j)) % tile_rows
//   window order hash = splitmix64(canon_smer)
//   tile = (min over windows) % num_tiles
//
// Strand invariance holds by construction (min of the two strands'
// codes).  splitmix64 is the standard finalizer (Steele et al. 2014);
// the numpy oracle lives in bigsi_tpu_torch/hashing/scheme.py and is
// parity-tested against this file.

static inline uint64_t splitmix64(uint64_t z) {
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

static inline uint64_t base_code(uint8_t b) {
  // A=0 C=1 G=2 T=3; any other byte (N, lowercase, ...) maps to 0 —
  // deterministic on both build and query sides, so lookups agree
  switch (b) {
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    default: return 0;
  }
}

static inline uint64_t comp_code(uint8_t b) {
  // code of the BYTE-complemented base: complement only ACGT (matching
  // kmers.py reverse_comp / canonicalize_kmers, which leave non-ACGT
  // bytes unchanged -> code 0).  Equals 3 - base_code(b) on ACGT but
  // NOT on other bytes — using 3 - code there made rc codes differ
  // between raw (query) and byte-canonicalized (build) forms of
  // N-containing k-mers: silent false negatives.  Parity oracle:
  // scheme.py pack_codes_v3.
  switch (b) {
    case 'A': return 3;
    case 'C': return 2;
    case 'G': return 1;
    case 'T': return 0;
    default: return 0;
  }
}

// Fused serving prep, slot scheme v3 (same contract as
// prep_minimizer_v2).  One rolling pass: per ROW an O(1) code update
// (overlap) or an O(k) rebuild (segment start), a window-minimum scan,
// and the grouped-stream append.
int64_t prep_minimizer_v3(const uint8_t* kmers, const int64_t* qstart,
                          int64_t B, int k, int s, uint64_t seed,
                          int64_t num_tiles, int h, int tile_rows, int r,
                          int64_t K_cap, int nthreads, int32_t* utile,
                          uint32_t* gmask, int32_t* n_valid) {
  if (s < 1 || s > k || k > 32 || k - s + 1 > 64 || h < 1 || h > 10 ||
      tile_rows < 1 || r < 1 || B < 0 || num_tiles < 1)
    return -1;
  const int w = k - s + 1;
  const uint64_t kmask = (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  const uint64_t smask_code = (1ull << (2 * s)) - 1;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > B) nthreads = B > 0 ? (int)B : 1;
  std::vector<int64_t> u_max_per((size_t)std::max(nthreads, 1), 0);

  auto run = [&](int t, int64_t b0, int64_t b1) {
    // ring buffer of window-order hashes + amortized sliding minimum:
    // track the min's ring slot; only rescan the w-window when the
    // minimum falls off the left edge (expected every ~w/2 rows)
    uint64_t hw[64];
    int64_t u_max = 0;
    for (int64_t q = b0; q < b1; q++) {
      const int64_t r0 = qstart[q], r1 = qstart[q + 1];
      n_valid[q] = (int32_t)(r1 - r0);
      int32_t* urow = utile + q * K_cap;
      uint32_t* grow = gmask + q * K_cap * r;
      int64_t entry = -1;
      int32_t cur_tile = -1;
      int slot = r;
      bool have_prev = false;
      uint64_t fwd = 0, rc = 0;  // rolling 2-bit codes of the kmer
      int head = 0;              // ring slot of the OLDEST window
      uint64_t mn = 0;
      int mn_slot = 0;           // ring slot holding the minimum
      for (int64_t i = r0; i < r1; i++) {
        const uint8_t* row = kmers + i * k;
        const bool overlap =
            have_prev &&
            std::memcmp(row, kmers + (i - 1) * k + 1, (size_t)(k - 1)) == 0;
        if (overlap) {
          const uint8_t b = row[k - 1];
          fwd = ((fwd << 2) | base_code(b)) & kmask;
          rc = (rc >> 2) | (comp_code(b) << (2 * (k - 1)));
          const uint64_t sf = fwd & smask_code;
          const uint64_t sr = (rc >> (2 * (k - s))) & smask_code;
          const uint64_t hv = splitmix64(seed ^ std::min(sf, sr));
          const int expired = head;  // oldest window leaves
          hw[head] = hv;             // newest takes its ring slot
          head = head + 1 == w ? 0 : head + 1;
          if (hv <= mn) {
            mn = hv;
            mn_slot = expired;
          } else if (mn_slot == expired) {
            mn = hw[0];  // the minimum fell off: rescan the window
            mn_slot = 0;
            for (int j = 1; j < w; j++)
              if (hw[j] < mn) { mn = hw[j]; mn_slot = j; }
          }
        } else {
          fwd = 0;
          rc = 0;
          for (int j = 0; j < k; j++) {
            fwd = (fwd << 2) | base_code(row[j]);
            rc |= comp_code(row[j]) << (2 * j);
          }
          mn = ~0ull;
          for (int j = 0; j < w; j++) {
            const uint64_t sf = (fwd >> (2 * (k - s - j))) & smask_code;
            const uint64_t sr = (rc >> (2 * j)) & smask_code;
            hw[j] = splitmix64(seed ^ std::min(sf, sr));
            if (hw[j] < mn) { mn = hw[j]; mn_slot = j; }
          }
          head = 0;
        }
        have_prev = true;
        const int32_t tile = (int32_t)(mn % (uint64_t)num_tiles);
        const uint64_t hv = splitmix64(std::min(fwd, rc));
        uint32_t sm = 0;
        for (int j = 0; j < h; j++)
          sm |= 1u << ((uint32_t)(hv >> (6 * j)) % (uint32_t)tile_rows);
        if (entry < 0 || tile != cur_tile || slot == r) {
          entry++;
          cur_tile = tile;
          urow[entry] = tile;
          slot = 0;
        }
        grow[entry * r + slot] = sm;
        slot++;
      }
      u_max = std::max(u_max, entry + 1);
    }
    u_max_per[(size_t)t] = u_max;
  };

  if (nthreads <= 1 || B <= 1) {
    run(0, 0, B);
    return u_max_per[0];
  }
  std::vector<std::thread> threads;
  const int64_t per = (B + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    const int64_t b0 = (int64_t)t * per;
    const int64_t b1 = std::min(B, b0 + per);
    if (b0 >= b1) break;
    threads.emplace_back(run, t, b0, b1);
  }
  for (auto& th : threads) th.join();
  int64_t u_max = 0;
  for (int64_t v : u_max_per) u_max = std::max(u_max, v);
  return u_max;
}

// Fused serving prep, slot scheme v3, straight from SEQUENCES: the
// k-mer windows are implied, so there is no [n, k] row materialization,
// no per-row overlap memcmp, and raw-kmer DEDUP (the reference's
// ``set(kmers)``, bigsi/graph/bigsi.py:178 via index.py:45) happens
// inline in the same rolling pass via a per-query open-addressed code
// table.  ACGT-only input is the caller's contract (the Python side
// falls back to the row path for sequences with other bytes, where
// 2-bit codes are not injective and dedup semantics would drift).
//
// seqs: concatenated query bytes; sstart: [B+1] offsets.  Outputs as
// prep_minimizer_v3 (utile [B, K_cap], gmask [B, K_cap, r] zeroed by
// caller, n_valid [B] = DISTINCT k-mer count per query).  Returns max
// entry count, or -1 on bad parameters.
int64_t prep_minimizer_v3_seqs(const uint8_t* seqs, const int64_t* sstart,
                               int64_t B, int k, int s, uint64_t seed,
                               int64_t num_tiles, int h, int tile_rows,
                               int r, int64_t K_cap, int nthreads,
                               int32_t* utile, uint32_t* gmask,
                               int32_t* n_valid) {
  if (s < 1 || s > k || k > 32 || k - s + 1 > 64 || h < 1 || h > 10 ||
      tile_rows < 1 || r < 1 || B < 0 || num_tiles < 1 ||
      (uint64_t)num_tiles >= (1ull << 32) ||
      (uint64_t)tile_rows >= (1ull << 32))
    return -1;
  const int w = k - s + 1;
  const uint64_t kmask = (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  const uint64_t smask_code = (1ull << (2 * s)) - 1;
  // NOTE: plain hardware '%' here — a reciprocal-multiply FastMod was
  // measured SLOWER on this host (scripts/microexp/prep_variants.cpp:
  // 2.25 vs 1.83 ms/batch without dedup); the div pipelines behind the
  // loop's other work.  tile_rows is a power of two in practice and the
  // compiler keeps the u32 mod cheap.
  if (nthreads < 1) nthreads = 1;
  if (nthreads > B) nthreads = B > 0 ? (int)B : 1;
  std::vector<int64_t> u_max_per((size_t)std::max(nthreads, 1), 0);

  // dedup table size: pow2 >= 2 * K_cap (load factor <= 0.5)
  uint64_t tsize = 16;
  while (tsize < (uint64_t)(2 * K_cap)) tsize <<= 1;
  const uint64_t tmask = tsize - 1;

  auto run = [&](int t, int64_t b0, int64_t b1) {
    uint64_t hw[64];
    std::vector<uint64_t> seen((size_t)tsize);
    // separate occupancy bits: a sentinel IN the key space would make
    // some k-mer undedupable (fwd+1 wraps to 0 for the all-T k-mer at
    // k=32 — caught in round-4 review)
    std::vector<uint64_t> used((size_t)((tsize + 63) / 64));
    int64_t u_max = 0;
    for (int64_t q = b0; q < b1; q++) {
      const int64_t p0 = sstart[q], p1 = sstart[q + 1];
      const int64_t len = p1 - p0;
      const int64_t nk = len >= k ? len - k + 1 : 0;
      int32_t* urow = utile + q * K_cap;
      uint32_t* grow = gmask + q * K_cap * r;
      int64_t entry = -1;
      int32_t cur_tile = -1;
      int slot = r;
      int32_t distinct = 0;
      if (nk > 0)
        std::memset(used.data(), 0, sizeof(uint64_t) * used.size());
      uint64_t fwd = 0, rc = 0;
      int head = 0;
      uint64_t mn = 0;
      int mn_slot = 0;
      const uint8_t* sq = seqs + p0;
      for (int64_t i = 0; i < nk; i++) {
        if (i == 0) {
          fwd = 0;
          rc = 0;
          for (int j = 0; j < k; j++) {
            fwd = (fwd << 2) | base_code(sq[j]);
            rc |= comp_code(sq[j]) << (2 * j);
          }
          mn = ~0ull;
          for (int j = 0; j < w; j++) {
            const uint64_t sf = (fwd >> (2 * (k - s - j))) & smask_code;
            const uint64_t sr = (rc >> (2 * j)) & smask_code;
            hw[j] = splitmix64(seed ^ std::min(sf, sr));
            if (hw[j] < mn) { mn = hw[j]; mn_slot = j; }
          }
          head = 0;
        } else {
          const uint8_t b = sq[i + k - 1];
          fwd = ((fwd << 2) | base_code(b)) & kmask;
          rc = (rc >> 2) | (comp_code(b) << (2 * (k - 1)));
          const uint64_t sf = fwd & smask_code;
          const uint64_t sr = (rc >> (2 * (k - s))) & smask_code;
          const uint64_t hv = splitmix64(seed ^ std::min(sf, sr));
          const int expired = head;
          hw[head] = hv;
          head = head + 1 == w ? 0 : head + 1;
          if (hv <= mn) {
            mn = hv;
            mn_slot = expired;
          } else if (mn_slot == expired) {
            mn = hw[0];
            mn_slot = 0;
            for (int j = 1; j < w; j++)
              if (hw[j] < mn) { mn = hw[j]; mn_slot = j; }
          }
        }
        // dedup on the raw-strand code (== raw k-mer bytes for ACGT):
        // matches the reference's set() of raw query k-mer strings
        uint64_t probe = splitmix64(fwd) & tmask;
        bool dup = false;
        for (;;) {
          const bool occ =
              (used[(size_t)(probe >> 6)] >> (probe & 63)) & 1ull;
          if (!occ) {
            used[(size_t)(probe >> 6)] |= 1ull << (probe & 63);
            seen[(size_t)probe] = fwd;
            break;
          }
          if (seen[(size_t)probe] == fwd) { dup = true; break; }
          probe = (probe + 1) & tmask;
        }
        if (dup) continue;
        distinct++;
        const int32_t tile = (int32_t)(mn % (uint64_t)num_tiles);
        const uint64_t hv = splitmix64(std::min(fwd, rc));
        uint32_t sm = 0;
        for (int j = 0; j < h; j++)
          sm |= 1u << ((uint32_t)(hv >> (6 * j)) % (uint32_t)tile_rows);
        if (entry < 0 || tile != cur_tile || slot == r) {
          entry++;
          cur_tile = tile;
          urow[entry] = tile;
          slot = 0;
        }
        grow[entry * r + slot] = sm;
        slot++;
      }
      n_valid[q] = distinct;
      u_max = std::max(u_max, entry + 1);
    }
    u_max_per[(size_t)t] = u_max;
  };

  if (nthreads <= 1 || B <= 1) {
    run(0, 0, B);
    return u_max_per[0];
  }
  std::vector<std::thread> threads;
  const int64_t per = (B + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    const int64_t b0 = (int64_t)t * per;
    const int64_t b1 = std::min(B, b0 + per);
    if (b0 >= b1) break;
    threads.emplace_back(run, t, b0, b1);
  }
  for (auto& th : threads) th.join();
  int64_t u_max = 0;
  for (int64_t v : u_max_per) u_max = std::max(u_max, v);
  return u_max;
}

// Standalone v3 tiles (build path / oracle cross-checks).
void minimizer_tiles_v3(const uint8_t* kmers, int64_t K, int k, int s,
                        uint64_t seed, int64_t num_tiles, int64_t* out) {
  if (s < 1 || s > k || k > 32 || k - s + 1 > 64 || K <= 0) return;
  const int w = k - s + 1;
  const uint64_t smask_code = (1ull << (2 * s)) - 1;
  const uint64_t kmask = (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  uint64_t hw[64];
  bool have_prev = false;
  uint64_t fwd = 0, rc = 0;
  for (int64_t i = 0; i < K; i++) {
    const uint8_t* row = kmers + i * k;
    const bool overlap =
        have_prev &&
        std::memcmp(row, kmers + (i - 1) * k + 1, (size_t)(k - 1)) == 0;
    if (overlap) {
      const uint8_t b = row[k - 1];
      fwd = ((fwd << 2) | base_code(b)) & kmask;
      rc = (rc >> 2) | (comp_code(b) << (2 * (k - 1)));
      if (w > 1)
        std::memmove(hw, hw + 1, sizeof(uint64_t) * (size_t)(w - 1));
      const uint64_t sf = fwd & smask_code;
      const uint64_t sr = (rc >> (2 * (k - s))) & smask_code;
      hw[w - 1] = splitmix64(seed ^ std::min(sf, sr));
    } else {
      fwd = 0;
      rc = 0;
      for (int j = 0; j < k; j++) {
        fwd = (fwd << 2) | base_code(row[j]);
        rc |= comp_code(row[j]) << (2 * j);
      }
      for (int j = 0; j < w; j++) {
        const uint64_t sf = (fwd >> (2 * (k - s - j))) & smask_code;
        const uint64_t sr = (rc >> (2 * j)) & smask_code;
        hw[j] = splitmix64(seed ^ std::min(sf, sr));
      }
    }
    have_prev = true;
    uint64_t mn = hw[0];
    for (int j = 1; j < w; j++) mn = std::min(mn, hw[j]);
    out[i] = (int64_t)(mn % (uint64_t)num_tiles);
  }
}

// --------------------------------------------------------- query (host)

// AND h packed rows per kmer and accumulate per-sample counts.
// matrix: uint32 [m, W]; idx: int64 [K, h]; counts: int64 [W*32].
void and_count_rows(const uint32_t* matrix, int64_t w,
                    const int64_t* idx, int64_t K, int h,
                    int64_t* counts) {
  for (int64_t i = 0; i < K; i++) {
    const int64_t* rows = idx + i * h;
    for (int64_t word = 0; word < w; word++) {
      uint32_t acc = matrix[rows[0] * w + word];
      for (int j = 1; j < h; j++) acc &= matrix[rows[j] * w + word];
      while (acc) {
        int b = __builtin_ctz(acc);
        counts[word * 32 + b]++;
        acc &= acc - 1;
      }
    }
  }
}

// Classic-semantics verification restricted to candidate words — the
// verify stage of two-stage search (screen on device, verify on host
// over the mmap'd canonical rows.bin).  For each k-mer, AND the chosen
// word of its h classic hash rows and count set bits per sample.
// matrix: uint32 [m, W] (typically an mmap of rows.bin); idx: int64
// [K, h]; wids: int32 [nw] candidate word ids; out: int64 [nw*32]
// (caller-zeroed) — counts for bit b of candidate word j at out[j*32+b].
// Traffic: K*h*nw word loads instead of the classic path's K*h full
// rows — the candidate restriction is what keeps verification below
// screening cost (reference semantics: bigsi/graph/bigsi.py:211-230).
void and_count_words(const uint32_t* matrix, int64_t W,
                     const int64_t* idx, int64_t K, int h,
                     const int32_t* wids, int64_t nw, int64_t* out) {
  // The pass is DRAM-LATENCY-bound: h random row touches per k-mer
  // into a matrix far beyond cache (3.2 GB at reference m).  An
  // 8-k-mer prefetch lookahead keeps more misses in flight — measured
  // 24.5 -> 14.7 ms per 256x512x3 verify batch at 2 threads (bench.py
  // verified-serving field).  A forced-LOAD lookahead was tried for
  // the TLB-miss case (prefetch can be dropped there) and measured
  // WORSE (46 ms: the touches serialize on the dependency chain).
  constexpr int64_t PD = 8;
  for (int64_t i = 0; i < K; i++) {
    if (i + PD < K) {
      const int64_t* prows = idx + (i + PD) * h;
      for (int t = 0; t < h; t++) {
        const uint32_t* base = matrix + prows[t] * W;
        for (int64_t j = 0; j < nw; j++)
          __builtin_prefetch(base + wids[j], 0, 1);
      }
    }
    const int64_t* rows = idx + i * h;
    for (int64_t j = 0; j < nw; j++) {
      const int64_t col = (int64_t)wids[j];
      uint32_t acc = matrix[rows[0] * W + col];
      for (int t = 1; t < h; t++) acc &= matrix[rows[t] * W + col];
      int64_t* o = out + j * 32;
      while (acc) {
        int b = __builtin_ctz(acc);
        o[b]++;
        acc &= acc - 1;
      }
    }
  }
}

// Batched variant over queries (qstart spans into idx), threaded.
// out: int64 [B, nw*32] caller-zeroed.
void and_count_words_batch(const uint32_t* matrix, int64_t W,
                           const int64_t* idx, const int64_t* qstart,
                           int64_t B, int h, const int32_t* wids,
                           const int64_t* wstart, int64_t nw_cap,
                           int nthreads, int64_t* out) {
  if (nthreads < 1) nthreads = 1;
  if (nthreads > B) nthreads = B > 0 ? (int)B : 1;
  auto run = [&](int64_t b0, int64_t b1) {
    for (int64_t q = b0; q < b1; q++) {
      const int64_t nw = wstart[q + 1] - wstart[q];
      if (!nw) continue;
      and_count_words(matrix, W, idx + qstart[q] * h,
                      qstart[q + 1] - qstart[q], h, wids + wstart[q], nw,
                      out + q * nw_cap * 32);
    }
  };
  if (nthreads <= 1 || B <= 1) {
    run(0, B);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t per = (B + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    const int64_t b0 = (int64_t)t * per;
    const int64_t b1 = std::min(B, b0 + per);
    if (b0 >= b1) break;
    threads.emplace_back(run, b0, b1);
  }
  for (auto& th : threads) th.join();
}

// Grouped (tile-dedup) stream prep for the minimizer query path —
// the serving hot path's host side (bigsi_tpu_torch/ops/lookup.py
// build_grouped_streams; the numpy version costs ~8 ms per [256,512]
// batch vs ~1.4 ms of device time).  Semantics are identical:
// consecutive equal tiles merge into one entry; runs longer than r
// spill into fresh entries; smask==0 kmers are padding.  utile/gmask
// must be zero-initialized with capacity [B,K] / [B,K,r]; returns the
// max entry count over the batch (callers bucket it).
int64_t grouped_streams(const int32_t* tile, const uint32_t* smask,
                        int64_t B, int64_t K, int r,
                        int32_t* utile, uint32_t* gmask) {
  int64_t u_max = 0;
  for (int64_t b = 0; b < B; b++) {
    const int32_t* trow = tile + b * K;
    const uint32_t* srow = smask + b * K;
    int32_t* urow = utile + b * K;
    uint32_t* grow = gmask + b * K * r;
    int64_t entry = -1;
    int32_t cur_tile = -1;
    int slot = r;  // force a new entry on the first valid kmer
    bool in_run = false;
    for (int64_t i = 0; i < K; i++) {
      if (srow[i] == 0) {
        in_run = false;  // a pad breaks the run
        continue;
      }
      if (!in_run || trow[i] != cur_tile || slot == r) {
        entry++;
        cur_tile = trow[i];
        urow[entry] = cur_tile;
        slot = 0;
        in_run = true;
      }
      grow[entry * r + slot] = srow[i];
      slot++;
    }
    if (entry + 1 > u_max) u_max = entry + 1;
  }
  return u_max;
}

}  // extern "C"
