// Lookup kernels of bigsi_tpu_torch for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (bigsi_tpu_torch/ops/_build.py,
// wrappers in bigsi_tpu_torch/ops/fused_lookup.py).
//
// Kernels A, B and C read the bitslice matrix as uint32[m, W], row-major:
// bit n % 32 of words[r * W + n / 32] says whether bloom row r is set in
// sample n.  Per query they AND the rows of each valid k-mer, count per
// sample how many k-mers survived (counts int32[B, W * 32], sample order)
// and AND the survivors (exact uint32[B, W]; all ones when no k-mer is
// valid).  Padding k-mers add nothing to either.  Kernels D and E work on
// the cols layout of a minimizer index, described at their code below.
//
// * classic_counts (kernel A) replaces the XLA program
//   bigsi_tpu/index/device_engine.py:_counts_batch_fat (the contract of
//   bigsi_tpu/ops/lookup.py:batched_counts_jnp) and adds the exact AND of
//   ops/lookup.py:exact_and_reduce.  A k-mer is h absolute row ids.
// * tile_counts (kernel B) replaces the Pallas kernel
//   bigsi_tpu/ops/pallas_lookup.py:fused_query (wrapper
//   query_counts_exact); the same contract covers
//   ops/lookup.py:blocked_counts.  A k-mer is a tile id and a 64-bit slot
//   mask: bit s selects row tile * tile_rows + s.  Mask 0 is padding.
// * grouped_tile_counts (kernel C) replaces the Pallas kernels
//   bigsi_tpu/ops/pallas_lookup.py:grouped_fused (P2) and
//   bigsi_tpu/ops/pallas_grouped.py:grouped_fused_v2 (P3); the same
//   contract covers ops/lookup.py:grouped_counts.  The k-mers come in
//   grouped streams: entry u of a query is one tile id and R slot masks,
//   one per k-mer of a run that shares the tile (mask 0 = padding slot).
//   P2/P3 read each entry's tile once for all R slots; here every slot
//   reads its own rows and the rows its entry's other slots share come
//   from L1 (a second kernel that copies each entry's rows once into
//   shared memory measured slower; below).  The TPU kernels' W == 32
//   limit, U % 16 == 0 and twisted lanes served the TPU's vector unit
//   and do not carry over; their carry-save planes return here as B's
//   and C's counters (below).
// * tile_counts_only is kernel B built without the exact AND and its
//   write (template kExact = false): the counts-only stage k2 of the
//   bisection probe scripts/bisect_kernel.py:49 (S3).
//
// Kernels F and G, gather_rows and tile_xor, are the probes' kernels,
// kernel H, seq_streams, is the seq serving arm's prep, kernels I, J
// and K, kmer_rows, bloom_scatter and bloom_transpose, hash k-mers and
// build an index on the card, and kernel L, presence_rows, gives
// scoring's per-k-mer presence rows: each is described at its code
// below.
//
// What bounds kernels A, B and C on an H100: gathered bytes, at random
// rows.  At m = 2.5e7 and W = 32 the matrix is 3.2 GB, far beyond the 50
// MB L2, so each k-mer costs h HBM reads of one 128-byte row segment;
// they read such rows at 1.0-1.2 TB/s, about a third of the card's 3.35
// TB/s, and the rate does not rise when the rows come from 512 MB rather
// than 3.2 GB (PERF.md, section 7).  All three run on one kernel
// (slot_counts_kernel, below), whose items are A's classic k-mers, B's
// slots or C's entries' slots: one block per (query, 32-word chunk) of 8
// warps, so two blocks share an SM and B = 256 queries fill the card in
// one wave, the warps splitting the query's live items into contiguous
// runs, lane l owning word 32 * chunk + l.  Row ids (or tiles and masks)
// are staged in shared memory first, so no read waits on an index load,
// and the warps' counters meet in shared memory at the end and leave in
// one coalesced write.  The design for Hopper:
//   - Bit-plane counters (Planes, below) in place of per-bit adds, which
//     cost 64 instructions a k-mer and 32 registers.  A lane keeps its 32
//     samples' counts as vertical counters, plane d holding bit d of all
//     32.  Eight presence words enter at once through a Harley-Seal tree
//     of carry-save adders (two LOP3 each), whose carry of eights
//     ripples into the upper planes only as deep as a count can reach so
//     far: about 5 logic ops a word.  The planes are unpacked into 32
//     counts only when they flush into the block's shared counters,
//     before any count could pass 2^16 - 1 and at the end.
//   - Live items only.  Staging drops padding (a k-mer not valid, a slot
//     of mask 0), which adds nothing to counts and all ones to exact: at
//     R = 6 about half of C's slots.
//   - Reads in flight while counting: the reads of the next 8 items'
//     rows are issued into registers before the current 8 are counted,
//     a row that several slots of an entry select coming again from L1.
//     No shared memory holds rows: C's per-warp [tile_rows][32] buffers
//     (128 KB a block) are gone, and a block stages only its items.  A
//     per-warp cp.async ring of each entry's selected rows, compacted,
//     was measured slower for both B and C on an H100 80GB HBM3
//     (PERF.md, section 6).
//   - The whole card for small batches (kernel A).  B x ceil(W / 32)
//     blocks leave most of 132 SMs idle when B is small: a single query
//     (B = 1, every classic search) took one block on one SM, 1.45 ms for
//     20,000 k-mers.  The wrapper then splits each query's items into
//     contiguous ranges, one block each (grid (B, chunks, ranges); how
//     many from B, K, W and the SM count, fused_lookup.classic_splits),
//     and the blocks add their counts and AND their exact words into
//     outputs set to 0 and all ones.  A batch that fills the card (B =
//     256) takes one range, as before.
// The TPU kernel's run-deduplicated DMA streams, twisted count order,
// bank-alternated slots and W == 32 limit served the TPU's DMA issue
// rate and scalar memory; here L1 and L2 serve a repeated tile.
//
// Offsets into the matrix are size_t: row * W * 4 reaches 3.2e9 bytes.

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;  // warps of a tile_xor block
constexpr int kThreads = 32 * kWarps;
constexpr int kStride = 33;   // padded row of the shared counters
constexpr unsigned kAllOnes = 0xFFFFFFFFu;

// Writes query b's slice of counts from the block's counters s_cnt (32
// per word, sample order) and, with kExact, exact for this chunk.  With
// kAdd the block took one range of the query's items: it adds its counts
// into counts and ANDs its exact into exact, which start at 0 and all
// ones.
template <bool kExact, bool kAdd = false>
__device__ __forceinline__ void store_counts(const int* s_cnt, const unsigned* s_exact, int b,
                                             int chunk, int W, int32_t* __restrict__ counts,
                                             int32_t* __restrict__ exact) {
  const int nw = min(32, W - chunk * 32);
  const size_t word0 = static_cast<size_t>(b) * W + static_cast<size_t>(chunk) * 32;
  int32_t* out = counts + word0 * 32;
  for (int i = threadIdx.x; i < nw * 32; i += blockDim.x) {
    const int c = s_cnt[(i >> 5) * kStride + (i & 31)];
    if (!kAdd) {
      out[i] = c;
    } else if (c != 0) {
      atomicAdd(out + i, c);
    }
  }
  if (kExact && threadIdx.x < nw) {
    const int32_t e = static_cast<int32_t>(s_exact[threadIdx.x]);
    if (!kAdd) {
      exact[word0 + threadIdx.x] = e;
    } else if (e != -1) {
      atomicAnd(exact + word0 + threadIdx.x, e);
    }
  }
}

// The contiguous run [lo, hi) of a staged chunk of n k-mers that this
// warp of a block of kNumWarps consumes.
template <int kNumWarps = kWarps>
__device__ __forceinline__ void warp_run(int n, int& lo, int& hi) {
  const int per = (n + kNumWarps - 1) / kNumWarps;
  lo = min(n, (static_cast<int>(threadIdx.x) >> 5) * per);
  hi = min(n, lo + per);
}

// -- kernels A, B and C: bit-plane counters over a stream of items --------
//
// All three count a stream of items per query, an item being one k-mer
// and the rows whose AND says which samples hold it: for kernel A a
// classic k-mer, h absolute row ids (ClassicRows); for kernels B and C a
// slot, a tile id and a 64-bit mask whose set bits s select the tile's
// rows s (SlotRows; bits at or past tile_rows select nothing, mask 0 is
// padding).  Kernel B's k-mers are slots, one to a tile; kernel C's entry
// is one tile and R slots.  So one kernel, slot_counts_kernel, runs all
// three.  A warp walks its run of staged items kBGroup at a time and
// issues the reads of the next group's rows (the first kBRows of each
// item; any further rows are read when the item is counted) before it
// counts the current group.  A row that several slots of an entry select
// is read again, from L1.

constexpr size_t kStageBytes = 32 * 1024;  // shared memory for staged items

constexpr int kPlanes = 16;                    // count bits a lane keeps per sample
constexpr int kPlaneMax = (1 << kPlanes) - 1;  // the largest count the planes hold

// Carry-save adder, bitwise: hi * 2 + lo = a + b + c.
__device__ __forceinline__ void csa(unsigned& hi, unsigned& lo, unsigned a, unsigned b,
                                    unsigned c) {
  const unsigned u = a ^ b;
  hi = (a & b) | (u & c);
  lo = u ^ c;
}

// One lane's 32 per-sample counts as bit planes: bit j of p[d] is bit d of
// sample j's count.  `since`, the same on every lane of a warp, counts the
// words added since the last flush and so bounds every count: the planes
// past its bit length are zero, and no add or unpack touches them.
struct Planes {
  unsigned p[kPlanes];
  int since;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int d = 0; d < kPlanes; ++d) p[d] = 0u;
    since = 0;
  }

  // Adds the counts into the block's counters s_cnt_lane[0, 32) and
  // clears the planes.
  __device__ __forceinline__ void flush(int* s_cnt_lane) {
    const int depth = 32 - __clz(since);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      int c = 0;
#pragma unroll
      for (int d = 0; d < kPlanes; ++d) {
        if (d >= depth) break;
        c |= static_cast<int>((p[d] >> j) & 1u) << d;
      }
      if (c != 0) atomicAdd(&s_cnt_lane[j], c);
    }
    init();
  }

  // Adds eight presence words (0 adds nothing): a Harley-Seal tree into
  // planes 0-2, then its carry of eights into planes 3 and up, as deep as
  // the counts can reach.  Flushes first when a count could pass
  // kPlaneMax.
  __device__ __forceinline__ void add8(const unsigned (&c)[8], int* s_cnt_lane) {
    if (since > kPlaneMax - 8) flush(s_cnt_lane);
    unsigned t1, t2, f1, f2, e;
    csa(t1, p[0], p[0], c[0], c[1]);
    csa(t2, p[0], p[0], c[2], c[3]);
    csa(f1, p[1], p[1], t1, t2);
    csa(t1, p[0], p[0], c[4], c[5]);
    csa(t2, p[0], p[0], c[6], c[7]);
    csa(f2, p[1], p[1], t1, t2);
    csa(e, p[2], p[2], f1, f2);
    since += 8;
    const int depth = 32 - __clz(since);
#pragma unroll
    for (int d = 3; d < kPlanes; ++d) {
      if (d >= depth) break;
      const unsigned t = p[d] & e;
      p[d] ^= e;
      e = t;
    }
  }
};

constexpr int kBWarps = 8;
constexpr int kBThreads = 32 * kBWarps;
constexpr int kBGroup = 8;  // items counted together, one Planes::add8
constexpr int kBRows = 4;   // rows of an item read ahead; any further rows are
                            // read when it is counted

// Kernels B and C: item i of query b is slot i of T tiles of R slots, tile
// tile[b, i / R] and mask mask[b, i], live when the mask is not 0.  A
// block stages [kc] masks, then [kc] tiles, one per live slot.
struct SlotRows {
  const int32_t* __restrict__ tile;
  const int64_t* __restrict__ mask;
  int T, R, tile_rows;
  unsigned long long* s_mask;  // the block's staged slots, set by bind
  int32_t* s_tile;
  unsigned long long rows_mask;  // the bits that select a row, set by bind

  static constexpr size_t kStaged = sizeof(unsigned long long) + sizeof(int32_t);
  static constexpr bool kSplit = false;  // a query's slots stay in one block
  __host__ __device__ size_t staged_bytes() const { return kStaged; }
  __host__ __device__ int items() const { return T * R; }

  // Points the streams at query b and the staging at the block's smem.
  __device__ __forceinline__ void bind(int b, unsigned long long* smem, int kc) {
    tile += static_cast<size_t>(b) * T;
    mask += static_cast<size_t>(b) * T * R;
    s_mask = smem;
    s_tile = reinterpret_cast<int32_t*>(smem + kc);
    rows_mask = tile_rows >= 64 ? ~0ull : (1ull << tile_rows) - 1ull;
  }
  // Item i's key, 0 for padding: its mask.
  __device__ __forceinline__ unsigned long long key(int i) const {
    return static_cast<unsigned long long>(mask[i]);
  }
  __device__ __forceinline__ void stage(int at, int i, unsigned long long key) const {
    s_mask[at] = key;
    s_tile[at] = tile[R == 1 ? i : i / R];
  }
  __device__ __forceinline__ unsigned long long selected(int e) const {
    return s_mask[e] & rows_mask;
  }
  // Issues the reads of the first kBRows rows that staged slot e selects
  // into v (all ones where it has no such row, or past the run's end hi);
  // col points at this lane's word of row 0.
  __device__ __forceinline__ void first(unsigned (&v)[kBRows], int e, int hi,
                                        const unsigned* col, int W, bool live) const {
    unsigned long long sel = e < hi ? selected(e) : 0ull;
    const size_t base = e < hi ? static_cast<size_t>(s_tile[e]) * tile_rows : 0;
#pragma unroll
    for (int i = 0; i < kBRows; ++i) {
      v[i] = kAllOnes;
      if (sel != 0ull) {
        const size_t s = __ffsll(static_cast<long long>(sel)) - 1;
        sel &= sel - 1ull;
        if (live) v[i] = __ldg(col + (base + s) * W);
      }
    }
  }
  // ANDs into c the rows of staged slot e past its first kBRows.
  __device__ __forceinline__ void rest(unsigned& c, int e, const unsigned* col, int W,
                                       bool live) const {
    unsigned long long sel = selected(e);
    if (__popcll(sel) <= kBRows) return;
    for (int i = 0; i < kBRows; ++i) sel &= sel - 1ull;
    const size_t base = static_cast<size_t>(s_tile[e]) * tile_rows;
    for (; sel != 0ull; sel &= sel - 1ull) {
      const size_t s = __ffsll(static_cast<long long>(sel)) - 1;
      if (live) c &= __ldg(col + (base + s) * W);
    }
  }
};

// Kernel A: item i of query b is k-mer i, rows row_idx[b, i, 0..h), live
// when valid[b, i].  A block stages [kc][h] row ids, one row per live
// k-mer.
struct ClassicRows {
  const int32_t* __restrict__ row_idx;
  const uint8_t* __restrict__ valid;
  int K, h;
  int32_t* s_rows;  // the block's staged row ids, set by bind

  static constexpr bool kSplit = true;  // a query's k-mers may span blocks
  __host__ __device__ size_t staged_bytes() const { return h * sizeof(int32_t); }
  __host__ __device__ int items() const { return K; }

  __device__ __forceinline__ void bind(int b, unsigned long long* smem, int) {
    row_idx += static_cast<size_t>(b) * K * h;
    valid += static_cast<size_t>(b) * K;
    s_rows = reinterpret_cast<int32_t*>(smem);
  }
  // Item i's key, 0 for padding: its valid flag.
  __device__ __forceinline__ unsigned long long key(int i) const { return valid[i]; }
  __device__ __forceinline__ void stage(int at, int i, unsigned long long) const {
    const int32_t* r = row_idx + static_cast<size_t>(i) * h;
    for (int j = 0; j < h; ++j) s_rows[at * h + j] = r[j];
  }
  __device__ __forceinline__ void first(unsigned (&v)[kBRows], int e, int hi,
                                        const unsigned* col, int W, bool live) const {
#pragma unroll
    for (int i = 0; i < kBRows; ++i) {
      v[i] = kAllOnes;
      if (e < hi && i < h && live) v[i] = __ldg(col + static_cast<size_t>(s_rows[e * h + i]) * W);
    }
  }
  __device__ __forceinline__ void rest(unsigned& c, int e, const unsigned* col, int W,
                                       bool live) const {
    for (int j = kBRows; j < h; ++j) {
      if (live) c &= __ldg(col + static_cast<size_t>(s_rows[e * h + j]) * W);
    }
  }
};

// The first reads of the items [e0, e0 + kBGroup) of a warp's run [., hi).
template <typename Rows>
__device__ __forceinline__ void rows_ahead(unsigned (&v)[kBGroup][kBRows], const Rows& rows,
                                           int e0, int hi, const unsigned* col, int W,
                                           bool live) {
#pragma unroll
  for (int u = 0; u < kBGroup; ++u) rows.first(v[u], e0 + u, hi, col, W, live);
}

// grid (B, ceil(W / 32), S): block (b, chunk, z) counts range z of S of
// query b's items for 32-word chunk `chunk` (S > 1 adds into outputs the
// caller set to 0 and all ones).  Only live items are staged, in
// warp-sized runs of stream order: padding adds nothing to counts and all
// ones to exact, so dropping it changes neither, and the warps split the
// live items evenly.  kExact = false is the counts-only build: exact is
// not written (and may be null).  Dynamic shared memory: [kc] staged items
// (Rows::staged_bytes each).
template <bool kExact, typename Rows>
__global__ void __launch_bounds__(kBThreads)
slot_counts_kernel(const unsigned* __restrict__ words, int W, Rows rows, int kc,
                   int32_t* __restrict__ counts, int32_t* __restrict__ exact) {
  extern __shared__ unsigned long long s_stage[];
  __shared__ int s_cnt[32 * kStride];
  __shared__ unsigned s_exact[32];
  __shared__ int s_staged;
  const int b = blockIdx.x;
  rows.bind(b, s_stage, kc);
  const int chunk = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = chunk * 32 + lane;
  const bool live = w < W;
  const unsigned* col = words + w;
  int* cnt = s_cnt + lane * kStride;
  const int items = rows.items();
  const int splits = Rows::kSplit ? gridDim.z : 1;
  const int per = (items + splits - 1) / splits;
  const int begin = min(items, static_cast<int>(blockIdx.z) * per);
  const int end = min(items, begin + per);
  for (int i = threadIdx.x; i < 32 * kStride; i += blockDim.x) s_cnt[i] = 0;
  if (threadIdx.x < 32) s_exact[threadIdx.x] = kAllOnes;
  __syncthreads();
  Planes acc;
  acc.init();
  unsigned ex = kAllOnes;
  for (int k0 = begin; k0 < end; k0 += kc) {
    const int n = min(kc, end - k0);
    __syncthreads();  // the previous chunk is consumed
    if (threadIdx.x == 0) s_staged = 0;
    __syncthreads();
    for (int i0 = 0; i0 < n; i0 += blockDim.x) {
      const int i = i0 + threadIdx.x;
      const unsigned long long key = i < n ? rows.key(k0 + i) : 0ull;
      const bool keep = key != 0ull;
      const unsigned kept = __ballot_sync(kAllOnes, keep);
      int at = 0;
      if (lane == 0 && kept != 0u) at = atomicAdd(&s_staged, __popc(kept));
      at = __shfl_sync(kAllOnes, at, 0) + __popc(kept & ((1u << lane) - 1u));
      if (keep) rows.stage(at, k0 + i, key);
    }
    __syncthreads();
    int lo, hi;
    warp_run<kBWarps>(s_staged, lo, hi);
    unsigned v[kBGroup][kBRows];
    if (lo < hi) rows_ahead(v, rows, lo, hi, col, W, live);
    for (int e0 = lo; e0 < hi; e0 += kBGroup) {
      unsigned c[kBGroup];
#pragma unroll
      for (int u = 0; u < kBGroup; ++u) {
        c[u] = v[u][0];
#pragma unroll
        for (int i = 1; i < kBRows; ++i) c[u] &= v[u][i];
      }
      // the next group's reads are in flight while this one is counted
      if (e0 + kBGroup < hi) rows_ahead(v, rows, e0 + kBGroup, hi, col, W, live);
#pragma unroll
      for (int u = 0; u < kBGroup; ++u) {
        const int e = e0 + u;
        if (e < hi) rows.rest(c[u], e, col, W, live);
        if (kExact) ex &= c[u];
        if (e >= hi) c[u] = 0u;  // past the run: counts nothing
      }
      acc.add8(c, cnt);
    }
  }
  acc.flush(cnt);
  if (kExact) atomicAnd(&s_exact[lane], ex);
  __syncthreads();
  if (splits == 1) {
    store_counts<kExact>(s_cnt, s_exact, b, chunk, W, counts, exact);
  } else {
    store_counts<kExact, true>(s_cnt, s_exact, b, chunk, W, counts, exact);
  }
}

// Kernels A, B and C: B queries of `rows`' items, each split into
// `splits` ranges (1 unless Rows::kSplit).
template <bool kExact, typename Rows>
int launch_counts(const void* words, int W, const Rows& rows, int B, int splits, void* counts,
                  void* exact, cudaStream_t stream) {
  if (splits != 1 && !Rows::kSplit) return static_cast<int>(cudaErrorInvalidValue);
  const size_t per_item = rows.staged_bytes();
  const int kc = static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>(rows.items(), kStageBytes / per_item)));
  const dim3 grid(B, (W + 31) / 32, splits);
  slot_counts_kernel<kExact, Rows><<<grid, kBThreads, kc * per_item, stream>>>(
      static_cast<const unsigned*>(words), W, rows, kc, static_cast<int32_t*>(counts),
      static_cast<int32_t*>(exact));
  return static_cast<int>(cudaGetLastError());
}

// B or C: T tiles of R slots per query.
template <bool kExact>
int launch_slots(const void* words, int W, const void* tile, const void* mask, int B, int T,
                 int R, int tile_rows, void* counts, void* exact, cudaStream_t stream) {
  if (B <= 0 || W <= 0 || T < 0 || R < 0 || tile_rows < 1 || tile_rows > 64 ||
      static_cast<int64_t>(T) * R > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SlotRows rows{static_cast<const int32_t*>(tile), static_cast<const int64_t*>(mask), T, R,
                      tile_rows, nullptr, nullptr, 0ull};
  return launch_counts<kExact>(words, W, rows, B, 1, counts, exact, stream);
}


// -- the cols layout: kernels D and E ------------------------------------
//
// The minimizer layout puts all h rows of a k-mer in one tile of
// tile_rows consecutive bitslice rows.  The cols layout transposes each
// tile once, at engine load: cols[t, n] holds sample n's tile_rows bits
// of tile t (bit s = row t * tile_rows + s), in the narrowest unsigned
// type (tile_rows <= 8: 8 bits, <= 16: 16 bits, <= 32: 32 bits).  A
// k-mer with slot mask g is then present in sample n iff
// (cols[t, n] & g) == g: one compare per sample, whatever h is.
//
// * pack_tile_cols (kernel D) replaces the XLA program
//   bigsi_tpu/ops/lookup.py:pack_tile_cols, run at engine load
//   (bigsi_tpu/index/device_engine.py:262-280).  An in-tile bit
//   transpose that reads the matrix once and writes it once (3.2 GB each
//   at m = 2.5e7, 1,024 samples), so it is bound by bytes.  Its design
//   for Hopper:
//   - A transpose in registers, every bit used.  A thread takes one
//     item, G = 32 / tile_rows consecutive words of one tile (a word
//     group), and holds its 32 bit rows: row r = g * tile_rows + s is
//     row s of word g.  A 32 x 32 bit transpose in registers (5 stages
//     of 16 masked swaps, about 400 logic ops for 128 bytes) leaves in
//     register c the column of sample c of all G words, word g in bits
//     [g * tile_rows, (g + 1) * tile_rows).  At tile_rows 16 and 8 no
//     bit is padding; the ballots it replaces (96 warp instructions a
//     word, the lanes past tile_rows idle) bound the kernel by its
//     instruction rate.
//   - Bytes in flight.  At tile_rows 8, 16 and 32 (the tile_rows an
//     index can have; compile-time builds) an item is 128 bytes in, read
//     as tile_rows loads of G words, and 128 bytes out, and a warp's 32
//     consecutive items read whole 128-byte row segments of 1-4 tiles
//     and write 4 KB of cols, one contiguous run.  No loop carries a
//     dependence between items, so the 4 blocks of 8 warps that fit an
//     SM at 64 registers a thread keep up to 128 KB of reads in flight.
//     The grid is persistent: the SM count times the blocks that fit an
//     SM, striding over the items.
//   - Wide stores.  A thread's 128 bytes go to the warp's 4 KB of shared
//     memory (16-byte chunks swizzled by lane, no bank conflict either
//     way) and leave as 16-byte stores, each warp store one contiguous
//     512 bytes.
//   - Chunks.  The function takes any run of whole tiles: the engine
//     packs each staged chunk of rows into its slice of cols.
//   Any other tile_rows in 1..32, a W that is not a multiple of G or a
//   pointer not aligned for the vector accesses takes a generic build:
//   word loads, the same transpose, element stores.
// * cols_counts (kernel E) replaces the XLA program
//   bigsi_tpu/ops/lookup.py:grouped_counts_cols.  Grouped streams in
//   (entry u of query b: tile utile[b, u] and R slot masks, mask 0 =
//   padding slot), counts[b, n] = sum over (u, j) of
//   [(cols[utile[b, u], n] & g) == g] - (U * R - n_valid[b]) out, as the
//   JAX program writes it (padding slots compare true and are
//   subtracted), plus exact[b, w]: the AND over the slots with g != 0,
//   bit n % 32 of word n / 32 (all ones when no slot is valid).  The
//   JAX program's two half-U chains and int16 accumulator served the
//   TPU's vector unit and are not ported.  Its design for Hopper:
//   - Live slots only.  A valid k-mer's mask has h >= 1 bits, so the
//     block keeps, per chunk of entries, only the slots whose mask is
//     nonzero once cut to the cols width (a block scan compacts them in
//     entry order; entries with none are dropped and never read).
//     Padding slots compare true, so counts = hits over the live slots
//     + n_valid - live: bit-equal to the contract in every case,
//     overflowed streams included, with no work spent on padding (at
//     least 64 % of the slots at R = 20, 37 % at R = 6).
//   - Several samples per register.  A thread owns one 16-byte vector
//     of a cols row: 16 samples of uint8, 8 of 16 bits or 4 of 32.  A
//     field is in when ~x & g is zero there (g repeated in every field):
//     d = ~x & g; miss = ((d & low) + low) | d sets a field's top bit iff
//     d != 0 there (low = 0x7F.. or 0x7FFF.. per field), so one add and
//     three logic ops test a whole register.  The in-flags add into
//     packed per-field counters, flushed into 32-bit counters before a
//     field can wrap (every 255 live slots at 8 bits, 65,535 at 16).
//   - Asynchronous copy.  An entry's slice of its cols row is one
//     contiguous run, so thread 0 keeps a ring of kEStages slices in
//     flight with 1-D bulk copies (cp.async.bulk, TMA) into shared
//     memory, each completing on its own mbarrier; all threads consume
//     the slices in order and a block barrier frees each stage before
//     it is refilled.  No thread spends registers or issue slots on the
//     loads.
//   - Sizing.  A block of kEThreads = 64 threads takes one query and a
//     1 KB slice of the row (kESliceBytes): grid (B, row bytes / 1 KB),
//     so at B = 256 and N = 1,024 the grid is 512 blocks at 16-bit cols
//     and 1,024 at 32-bit.  A ring of 16 stages is 16 KB; the staged
//     masks of a chunk take at most 16 KB more (the whole query at
//     U = 72, R = 20 or U = 136, R = 6), so 6-9 blocks fit an SM and
//     every SM holds 4-8 of them, 64-128 KB of rows in flight per SM --
//     what HBM's latency needs at full rate.
//
// Offsets into cols are size_t: t * N reaches 1.6e9 elements.

constexpr int kPackWarps = 8;
constexpr int kPackThreads = 32 * kPackWarps;

// In place: bit s of a[c] becomes bit c of the old a[s].  Stage j swaps,
// in every pair of rows (k, k + j) with bit j clear in k, the columns of
// row k with bit j set and those of row k + j with bit j clear.
__device__ __forceinline__ void transpose32(unsigned (&a)[32]) {
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const unsigned m = kAllOnes / ((1u << j) + 1u);  // columns with bit j clear
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (k & j) continue;
      const unsigned t = ((a[k] >> j) ^ a[k + j]) & m;
      a[k + j] ^= t;
      a[k] ^= t << j;
    }
  }
}

// tile_rows kTr in {8, 16, 32}, T its cols type (G * sizeof(T) == 4), W a
// multiple of G, words aligned to G words and cols to 16 bytes.  Item i
// is word group q = i % (W / G) of tile i / (W / G); its 128 bytes of
// cols start at byte 128 * i.  A warp takes 32 consecutive items a step.
template <typename T, int kTr>
__global__ void __launch_bounds__(kPackThreads)
pack_tile_cols_kernel(const unsigned* __restrict__ words, int W, int64_t num_tiles,
                      T* __restrict__ cols) {
  constexpr int kG = 32 / kTr;
  static_assert(kG * sizeof(T) == 4, "an item is 128 bytes out");
  __shared__ uint4 s_out[kPackWarps][256];  // a warp's 4 KB of cols
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint4* stage = s_out[warp];
  const int64_t groups = W / kG;
  const int64_t items = num_tiles * groups;
  uint4* out = reinterpret_cast<uint4*>(cols);
  const int64_t step = static_cast<int64_t>(gridDim.x) * kPackThreads;
  for (int64_t base = (static_cast<int64_t>(blockIdx.x) * kPackWarps + warp) * 32; base < items;
       base += step) {
    const int64_t i = base + lane;
    unsigned a[32];
    if (i < items) {
      const int64_t t = i / groups;
      const unsigned* src = words + (t * kTr * W + (i - t * groups) * kG);
#pragma unroll
      for (int s = 0; s < kTr; ++s) {
        const unsigned* row = src + static_cast<size_t>(s) * W;
        if constexpr (kG == 1) {
          a[s] = __ldg(row);
        } else if constexpr (kG == 2) {
          const uint2 v = __ldg(reinterpret_cast<const uint2*>(row));
          a[s] = v.x;
          a[kTr + s] = v.y;
        } else {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(row));
          a[s] = v.x;
          a[kTr + s] = v.y;
          a[2 * kTr + s] = v.z;
          a[3 * kTr + s] = v.w;
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < 32; ++r) a[r] = 0u;
    }
    transpose32(a);
    // the item's 32 words of cols, in memory order: word g's 32 samples,
    // then word g + 1's
    unsigned o[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      if constexpr (kTr == 32) {
        o[c] = a[c];
      } else if constexpr (kTr == 16) {  // samples 2j, 2j + 1 of word g
        const int g = c / 16, j = c % 16;
        o[c] = __byte_perm(a[2 * j], a[2 * j + 1], g ? 0x7632 : 0x5410);
      } else {  // samples 4j .. 4j + 3 of word g: byte g of each
        const int g = c / 8, j = c % 8;
        const unsigned sel = g | (g + 4) << 4;
        o[c] = __byte_perm(__byte_perm(a[4 * j], a[4 * j + 1], sel),
                           __byte_perm(a[4 * j + 2], a[4 * j + 3], sel), 0x5410);
      }
    }
    // chunk v of lane l at slot l * 8 + (v ^ (l & 7)): 8 lanes of a
    // store phase hit 8 distinct 16-byte bank groups, and so do the 8
    // chunks of one item on the way out
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      stage[lane * 8 + (v ^ (lane & 7))] =
          make_uint4(o[4 * v], o[4 * v + 1], o[4 * v + 2], o[4 * v + 3]);
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int c = it * 32 + lane;  // 16-byte chunk of the warp's 4 KB
      const int owner = c >> 3;
      if (base + owner < items) out[base * 8 + c] = stage[owner * 8 + ((c & 7) ^ (owner & 7))];
    }
    __syncwarp();  // the stage is read before the next step writes it
  }
}

// Any tile_rows in [1, 32], any W and alignment: item i is word group q
// = i % ceil(W / G) of tile i / ceil(W / G), G = 32 / tile_rows words
// (the last group of a row may be short); one item a thread.
template <typename T>
__global__ void __launch_bounds__(kPackThreads)
pack_tile_cols_any_kernel(const unsigned* __restrict__ words, int W, int64_t num_tiles,
                          int tile_rows, T* __restrict__ cols) {
  const int G = 32 / tile_rows;
  const int groups = (W + G - 1) / G;
  const int64_t items = num_tiles * groups;
  const unsigned field = tile_rows == 32 ? kAllOnes : (1u << tile_rows) - 1u;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < items;
       i += step) {
    const int64_t t = i / groups;
    const int w0 = static_cast<int>(i - t * groups) * G;
    const unsigned* tile = words + static_cast<size_t>(t) * tile_rows * W;
    unsigned a[32];
    int g = 0, s = 0;  // row r = g * tile_rows + s
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      a[r] = g < G && w0 + g < W ? __ldg(tile + static_cast<size_t>(s) * W + w0 + g) : 0u;
      if (++s == tile_rows) {
        s = 0;
        ++g;
      }
    }
    transpose32(a);
    T* out = cols + static_cast<size_t>(t) * W * 32;
    for (int gg = 0; gg < G && w0 + gg < W; ++gg) {
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        out[(w0 + gg) * 32 + c] = static_cast<T>((a[c] >> (gg * tile_rows)) & field);
      }
    }
  }
}

// -- kernel E's pieces: the bulk-copy ring and the packed field test

constexpr int kEThreads = 64;                   // threads per block, a 16-byte vector each
constexpr int kESliceBytes = kEThreads * 16;    // bytes of a cols row per block
constexpr int kEStages = 16;                    // slices in flight per block
constexpr size_t kEMaskBytes = 16 * 1024;       // staged masks of one chunk of entries

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// The bytes of one bulk copy into `dst`, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// Per-thread state of kernel E for cols elements of type T: a 16-byte
// vector holds kSamples samples, kPer to a 32-bit register.
template <typename T>
struct ColsAcc {
  static constexpr int kBits = 8 * sizeof(T);
  static constexpr int kPer = 4 / sizeof(T);
  static constexpr int kSamples = 4 * kPer;
  // a field's bits below its top one, and the most live slots a packed
  // field counter takes before it is flushed
  static constexpr unsigned kLow = kBits == 8 ? 0x7F7F7F7Fu : 0x7FFF7FFFu;
  static constexpr int kLimit = kBits == 8 ? 255 : 65535;
  unsigned packed[4];  // per-field hit counters (narrow types)
  unsigned all[4];     // per-field in-flags ANDed over the live slots
  int hits[kSamples];
  int since;           // live slots since the last flush

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      packed[k] = 0u;
      all[k] = kAllOnes;
    }
#pragma unroll
    for (int i = 0; i < kSamples; ++i) hits[i] = 0;
    since = 0;
  }

  __device__ __forceinline__ void flush() {
    if constexpr (kBits != 32) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int f = 0; f < kPer; ++f) {
          hits[k * kPer + f] += (packed[k] >> (f * kBits)) & ((1u << kBits) - 1u);
        }
        packed[k] = 0u;
      }
      since = 0;
    }
  }

  // One live slot with mask g (cut to T) against the vector x.
  __device__ __forceinline__ void test(const uint4& v, unsigned g) {
    const unsigned x[4] = {v.x, v.y, v.z, v.w};
    if constexpr (kBits == 32) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned in = (~x[k] & g) == 0u;
        hits[k] += in;
        all[k] &= in ? kAllOnes : 0u;
      }
    } else {
      const unsigned rep = kBits == 8 ? g * 0x01010101u : g * 0x00010001u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned d = ~x[k] & rep;
        const unsigned miss = ((d & kLow) + kLow) | d;  // a field's top bit: it misses
        packed[k] += (~miss & ~kLow) >> (kBits - 1);
        all[k] &= ~miss;
      }
      if (++since == kLimit) flush();
    }
  }

  // Bit i: sample i of the vector is in at every live slot.
  __device__ __forceinline__ unsigned exact_bits() const {
    unsigned out = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int f = 0; f < kPer; ++f) {
        out |= ((all[k] >> (f * kBits + kBits - 1)) & 1u) << (k * kPer + f);
      }
    }
    return out;
  }
};

// Exclusive prefix sum of v over the block; `total` gets the sum.
__device__ __forceinline__ unsigned block_exclusive_sum(unsigned v, unsigned* s_warp,
                                                        unsigned& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(kAllOnes, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  unsigned before = 0u, sum = 0u;
  for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) {
    if (i < warp) before += s_warp[i];
    sum += s_warp[i];
  }
  total = sum;
  return before + x - v;
}

// grid (B, ceil(row bytes / kESliceBytes)), kEThreads threads: block
// (b, y) takes query b and bytes [y * kESliceBytes, +kESliceBytes) of
// every cols row.  Dynamic shared memory: the ring [kEStages]
// [kESliceBytes], then per chunk of kc entries [kc * R] masks cut to T,
// [kc * R] live masks, [kc] tiles of the live entries and [kc + 1]
// offsets of their first live mask.  cols must be 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kEThreads)
cols_counts_kernel(const T* __restrict__ cols, int W, const int32_t* __restrict__ utile,
                   const int64_t* __restrict__ gmask, const int32_t* __restrict__ n_valid,
                   int U, int R, int kc, int32_t* __restrict__ counts,
                   int32_t* __restrict__ exact) {
  using Acc = ColsAcc<T>;
  extern __shared__ __align__(16) unsigned char e_smem[];
  __shared__ __align__(8) uint64_t s_full[kEStages];
  __shared__ unsigned s_warp[kEThreads / 32];
  unsigned char* ring = e_smem;
  unsigned* s_g = reinterpret_cast<unsigned*>(ring + kEStages * kESliceBytes);
  unsigned* s_live = s_g + static_cast<size_t>(kc) * R;
  int32_t* s_etile = reinterpret_cast<int32_t*>(s_live + static_cast<size_t>(kc) * R);
  int32_t* s_eoff = s_etile + kc;

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const size_t row_bytes = static_cast<size_t>(W) * 32 * sizeof(T);
  const size_t slice_off = static_cast<size_t>(blockIdx.y) * kESliceBytes;
  const unsigned slice_len =
      static_cast<unsigned>(min(static_cast<size_t>(kESliceBytes), row_bytes - slice_off));
  const bool active = static_cast<unsigned>(tid) * 16u < slice_len;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(cols) + slice_off;
  const int32_t* q_tile = utile + static_cast<size_t>(b) * U;
  const int64_t* q_mask = gmask + static_cast<size_t>(b) * U * R;

  if (tid == 0) {
    for (int s = 0; s < kEStages; ++s) mbar_init(&s_full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  Acc acc;
  acc.init();
  int live = 0;       // live slots of the query so far
  unsigned seq = 0;   // slices loaded so far: load q uses stage q % kEStages
  for (int u0 = 0; u0 < U; u0 += kc) {
    const int m = min(kc, U - u0);
    for (int i = tid; i < m * R; i += kEThreads) {
      s_g[i] = static_cast<T>(q_mask[static_cast<size_t>(u0) * R + i]);
    }
    __syncthreads();
    // compact: each thread takes a contiguous run of entries, and one
    // scan over (live slots << 16 | live entries) places them in order
    const int per = (m + kEThreads - 1) / kEThreads;
    const int e0 = min(m, tid * per);
    const int e1 = min(m, e0 + per);
    unsigned mine = 0u;
    for (int e = e0; e < e1; ++e) {
      unsigned c = 0u;
      for (int j = 0; j < R; ++j) c += s_g[e * R + j] != 0u;
      mine += (c << 16) | (c != 0u);
    }
    unsigned total;
    const unsigned at = block_exclusive_sum(mine, s_warp, total);
    unsigned slot = at >> 16, ent = at & 0xFFFFu;
    for (int e = e0; e < e1; ++e) {
      const unsigned first = slot;
      for (int j = 0; j < R; ++j) {
        const unsigned g = s_g[e * R + j];
        if (g != 0u) s_live[slot++] = g;
      }
      if (slot != first) {
        s_etile[ent] = q_tile[u0 + e];
        s_eoff[ent++] = static_cast<int32_t>(first);
      }
    }
    const int n_ent = static_cast<int>(total & 0xFFFFu);
    if (tid == 0) s_eoff[n_ent] = static_cast<int32_t>(total >> 16);
    live += static_cast<int>(total >> 16);
    __syncthreads();

    // the ring over the chunk's live entries
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      for (int i = 0; i < min(kEStages, n_ent); ++i) {
        const int s = (seq + i) % kEStages;
        bulk_load(ring + s * kESliceBytes, src + static_cast<size_t>(s_etile[i]) * row_bytes,
                  slice_len, &s_full[s]);
      }
    }
    for (int i = 0; i < n_ent; ++i) {
      const unsigned q = seq + i;
      const int s = q % kEStages;
      mbar_wait(&s_full[s], (q / kEStages) & 1u);
      if (active) {
        const uint4 v = *reinterpret_cast<const uint4*>(ring + s * kESliceBytes + tid * 16);
        const int j1 = s_eoff[i + 1];
        for (int j = s_eoff[i]; j < j1; ++j) acc.test(v, s_live[j]);
      }
      __syncthreads();  // stage s is consumed
      if (tid == 0 && i + kEStages < n_ent) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        bulk_load(ring + s * kESliceBytes,
                  src + static_cast<size_t>(s_etile[i + kEStages]) * row_bytes, slice_len,
                  &s_full[s]);
      }
    }
    seq += n_ent;
  }
  acc.flush();

  // counts: the live hits + n_valid - live; exact: Acc::kSamples bits a
  // thread, 32 / kSamples lanes to a word
  constexpr int kGroup = 32 / Acc::kSamples;
  const int lane = tid & 31;
  unsigned word = active ? acc.exact_bits() << ((lane % kGroup) * Acc::kSamples) : 0u;
#pragma unroll
  for (int d = 1; d < kGroup; d <<= 1) word |= __shfl_xor_sync(kAllOnes, word, d);
  if (!active) return;
  const size_t n0 = slice_off / sizeof(T) + static_cast<size_t>(tid) * Acc::kSamples;
  const int extra = n_valid[b] - live;
  int4* out = reinterpret_cast<int4*>(counts + static_cast<size_t>(b) * W * 32 + n0);
#pragma unroll
  for (int i = 0; i < Acc::kSamples / 4; ++i) {
    out[i] = make_int4(acc.hits[4 * i] + extra, acc.hits[4 * i + 1] + extra,
                       acc.hits[4 * i + 2] + extra, acc.hits[4 * i + 3] + extra);
  }
  if (lane % kGroup == 0) {
    exact[static_cast<size_t>(b) * W + n0 / 32] = static_cast<int32_t>(word);
  }
}

// The persistent grid of a pack kernel: as many blocks as fit the card at
// once, or fewer when the items run out first.
template <typename Kernel>
int pack_grid(Kernel kernel, int64_t items, int items_per_block, unsigned& grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPackThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t wanted = (items + items_per_block - 1) / items_per_block;
  grid = static_cast<unsigned>(std::max<int64_t>(
      1, std::min<int64_t>(wanted, static_cast<int64_t>(sms) * std::max(1, per_sm))));
  return static_cast<int>(cudaSuccess);
}

template <typename T, int kTr>
int launch_pack_fast(const void* words, int W, int64_t num_tiles, void* cols,
                     cudaStream_t stream) {
  unsigned grid = 0;
  const int err = pack_grid(pack_tile_cols_kernel<T, kTr>, num_tiles * (W / (32 / kTr)),
                            kPackThreads, grid);
  if (err != 0) return err;
  pack_tile_cols_kernel<T, kTr><<<grid, kPackThreads, 0, stream>>>(
      static_cast<const unsigned*>(words), W, num_tiles, static_cast<T*>(cols));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pack(const void* words, int W, int64_t num_tiles, int tile_rows, void* cols,
                cudaStream_t stream) {
  const int g = 32 / tile_rows;
  // tile_rows 8, 16 and 32 fill their cols type: an item is 128 bytes out
  const bool fast = tile_rows == 8 * static_cast<int>(sizeof(T)) && W % g == 0 &&
                    reinterpret_cast<uintptr_t>(words) % (4 * g) == 0 &&
                    reinterpret_cast<uintptr_t>(cols) % 16 == 0;
  if (fast) {
    if constexpr (sizeof(T) == 1) return launch_pack_fast<T, 8>(words, W, num_tiles, cols, stream);
    if constexpr (sizeof(T) == 2) return launch_pack_fast<T, 16>(words, W, num_tiles, cols, stream);
    if constexpr (sizeof(T) == 4) return launch_pack_fast<T, 32>(words, W, num_tiles, cols, stream);
  }
  unsigned grid = 0;
  const int err = pack_grid(pack_tile_cols_any_kernel<T>,
                            num_tiles * ((W + g - 1) / g), kPackThreads, grid);
  if (err != 0) return err;
  pack_tile_cols_any_kernel<T><<<grid, kPackThreads, 0, stream>>>(
      static_cast<const unsigned*>(words), W, num_tiles, tile_rows, static_cast<T*>(cols));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cols_counts(const void* cols, int W, const void* utile, const void* gmask,
                       const void* n_valid, int B, int U, int R, void* counts, void* exact,
                       cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(cols) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  // two copies of an entry's masks, its tile and its offset
  const size_t per_entry = 2 * static_cast<size_t>(R) * sizeof(unsigned) + 2 * sizeof(int32_t);
  const size_t budget = std::max(kEMaskBytes, per_entry);
  const int kc = static_cast<int>(std::max<size_t>(1, std::min<size_t>(U, budget / per_entry)));
  const size_t smem = static_cast<size_t>(kEStages) * kESliceBytes +
                      static_cast<size_t>(kc) * per_entry + sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cols_counts_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t row_bytes = static_cast<size_t>(W) * 32 * sizeof(T);
  const dim3 grid(B, static_cast<unsigned>((row_bytes + kESliceBytes - 1) / kESliceBytes));
  cols_counts_kernel<T><<<grid, kEThreads, smem, stream>>>(
      static_cast<const T*>(cols), W, static_cast<const int32_t*>(utile),
      static_cast<const int64_t*>(gmask), static_cast<const int32_t*>(n_valid), U, R, kc,
      static_cast<int32_t*>(counts), static_cast<int32_t*>(exact));
  return static_cast<int>(cudaGetLastError());
}

// -- the probes' kernels: F and G ----------------------------------------
//
// * gather_rows (kernel F) replaces the Pallas kernel of
//   scripts/probe_multidma.py:62 (S2): out[i] = mat[idx[i]], rows of Wr
//   words.  The TPU kernel's point was many row copies in flight; here a
//   group of lanes (the fewest, a power of two up to 32, that cover a
//   row's vectors) copies kRows rows, the reads of all kRows issued
//   before any is stored, so a warp keeps kRows * 32 / lanes rows in
//   flight (kRows at rows of 128 vectors and more: the --chunk of S2).
//   Rows are read as 16-byte vectors where Wr % 4 == 0 and the pointers
//   allow, else word by word.  Bound by random-row reads from HBM.
// * tile_xor (kernel G) replaces the XOR-consume floor of the probes of
//   P1's loop: scripts/bisect_kernel.py:49 (S3 case k1),
//   scripts/bisect_compile.py:107 (S4), scripts/bisect_size.py:73 (S5),
//   and the floor of scripts/microbench.py:233 (S1).  Per query, the XOR
//   of the whole tiles of its valid k-mers, out int32[B, tile_rows, W].
//   Like kernel B: one block per (query, 32-word chunk), the k-mers
//   staged in shared memory and split into one contiguous run per warp,
//   lane l owning word 32 * chunk + l.  Every row of a valid k-mer's
//   tile is read (the TPU loop fetched whole tiles), kXorBatch row reads
//   in flight per warp across k-mer boundaries; each warp XORs into its
//   own [tile_rows][32] shared-memory accumulator (lane l only touches
//   column l, so no sync), and the block XORs the warps' accumulators
//   at the end.  Shared rather than register accumulators keep any
//   tile_rows up to 64 in one build with no spills.  Bound by streaming
//   whole tiles from HBM: tile_rows * 128 bytes per k-mer and chunk.

constexpr int kGatherWarps = 8;
constexpr int kXorBatch = 16;  // row reads of one warp issued together

template <typename V, int kRows>
__global__ void __launch_bounds__(32 * kGatherWarps)
gather_rows_kernel(const V* __restrict__ mat, int wv, const int32_t* __restrict__ idx,
                   int64_t n, int lanes, V* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kGatherWarps + (threadIdx.x >> 5);
  const int64_t r0 = (warp * (32 / lanes) + lane / lanes) * kRows;
  if (r0 >= n) return;  // no block-wide sync below
  int32_t src[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) src[q] = r0 + q < n ? __ldg(idx + r0 + q) : 0;
  for (int c = sub; c < wv; c += lanes) {
    V v[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      if (r0 + q < n) v[q] = __ldg(mat + static_cast<size_t>(src[q]) * wv + c);
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      if (r0 + q < n) out[static_cast<size_t>(r0 + q) * wv + c] = v[q];
    }
  }
}

template <typename V, int kRows>
int launch_gather_rows(const void* mat, int wv, const void* idx, int64_t n, void* out,
                       cudaStream_t stream) {
  int lanes = 1;
  while (lanes < wv && lanes < 32) lanes *= 2;
  const int64_t per_block = static_cast<int64_t>(kGatherWarps) * (32 / lanes) * kRows;
  const int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  gather_rows_kernel<V, kRows><<<static_cast<unsigned>(blocks), 32 * kGatherWarps, 0, stream>>>(
      static_cast<const V*>(mat), wv, static_cast<const int32_t*>(idx), n, lanes,
      static_cast<V*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch_gather_rows(const void* mat, int wv, const void* idx, int64_t n, int rows,
                       void* out, cudaStream_t stream) {
  switch (rows) {
    case 1: return launch_gather_rows<V, 1>(mat, wv, idx, n, out, stream);
    case 2: return launch_gather_rows<V, 2>(mat, wv, idx, n, out, stream);
    case 4: return launch_gather_rows<V, 4>(mat, wv, idx, n, out, stream);
    case 8: return launch_gather_rows<V, 8>(mat, wv, idx, n, out, stream);
    case 16: return launch_gather_rows<V, 16>(mat, wv, idx, n, out, stream);
    case 32: return launch_gather_rows<V, 32>(mat, wv, idx, n, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory: per warp a [tile_rows][32] XOR accumulator,
// then [kc] tile ids and [kc] valid flags.
__global__ void __launch_bounds__(kThreads)
tile_xor_kernel(const unsigned* __restrict__ words, int W, const int32_t* __restrict__ tile,
                const uint8_t* __restrict__ valid, int K, int tile_rows, int kc,
                int32_t* __restrict__ out) {
  extern __shared__ unsigned s_acc[];  // [kWarps][tile_rows][32]
  int32_t* s_tile = reinterpret_cast<int32_t*>(s_acc + kWarps * tile_rows * 32);
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_tile + kc);
  const int b = blockIdx.x;
  const int chunk = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = chunk * 32 + lane;
  const bool live = w < W;
  unsigned* acc = s_acc + (threadIdx.x >> 5) * tile_rows * 32 + lane;  // column l of my warp's
  for (int s = 0; s < tile_rows; ++s) acc[s * 32] = 0u;
  const int32_t* q_tile = tile + static_cast<size_t>(b) * K;
  const uint8_t* q_valid = valid + static_cast<size_t>(b) * K;
  for (int k0 = 0; k0 < K; k0 += kc) {
    const int n = min(kc, K - k0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      s_tile[i] = q_tile[k0 + i];
      s_valid[i] = q_valid[k0 + i];
    }
    __syncthreads();
    int lo, hi;
    warp_run(n, lo, hi);
    // walk the (k-mer, row) pairs of the run's valid k-mers; e and s
    // are the same on every lane of the warp
    int e = lo, s = 0;
    while (e < hi && !s_valid[e]) ++e;
    while (e < hi) {
      int row[kXorBatch];
      unsigned v[kXorBatch];
#pragma unroll
      for (int q = 0; q < kXorBatch; ++q) {
        row[q] = -1;
        v[q] = 0u;
        if (e < hi) {
          row[q] = s;
          if (live) v[q] = __ldg(words + (static_cast<size_t>(s_tile[e]) * tile_rows + s) * W + w);
          if (++s == tile_rows) {
            s = 0;
            for (++e; e < hi && !s_valid[e]; ++e) {
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kXorBatch; ++q) {
        if (row[q] >= 0) acc[row[q] * 32] ^= v[q];
      }
    }
  }
  __syncthreads();
  const int nw = min(32, W - chunk * 32);
  int32_t* q_out = out + static_cast<size_t>(b) * tile_rows * W + static_cast<size_t>(chunk) * 32;
  for (int i = threadIdx.x; i < tile_rows * 32; i += blockDim.x) {
    const int r = i >> 5, l = i & 31;
    unsigned x = 0u;
    for (int wp = 0; wp < kWarps; ++wp) x ^= s_acc[(wp * tile_rows + r) * 32 + l];
    if (l < nw) q_out[static_cast<size_t>(r) * W + l] = static_cast<int32_t>(x);
  }
}

// -- the seq serving arm's prep: kernel H --------------------------------
//
// seq_streams (kernel H) replaces the XLA program
// bigsi_tpu/ops/prep_jax.py:prep_streams_device: padded ASCII query bytes
// (uint8[B, L], lens int32[B]) -> the grouped streams of slot scheme 3
// that kernel E counts (utile int32[B, U], gmask int64[B, U, R] holding
// 32-bit masks, n_valid int32[B]) and ok (one byte: every query needs at
// most U entries).  k-mer i of query b is valid when i < lens[b] - k + 1.
// Per valid k-mer: the forward and reverse-complement 2-bit codes (A and
// other bytes 0, C 1, G 2, T 3; only ACGT are complemented), the slot
// mask (bit (hv >> 6j) & (tile_rows - 1) for j < h, hv the splitmix64 of
// the unsigned minimum of the two codes) and the tile (the unsigned
// minimum of splitmix64(canonical s-mer ^ seed) over the w = k - s + 1
// s-mers the k-mer spans, modulo num_tiles).  A k-mer whose forward code
// occurred at an earlier valid position is a duplicate: it keeps its slot
// with mask 0 and n_valid does not count it.  Runs of one tile open an
// entry at their start and every R positions after (pos % R == 0); slot
// pos % R of the entry holds the k-mer.  Entries at or past U are not
// written; what is not written is 0.
//
// One block per query, five passes, each ending in a barrier.  The
// query's bytes, its k-mers' forward codes, masks and tiles, the s-mer
// hashes and the dedup table live in shared memory (about 150 KB at L =
// 4,096, the longest query the engine's guard admits; opted in past 48
// KB).  (1) The outputs' zero fill and the bytes in; (2) the s-mer hashes
// and (3) per k-mer codes and masks, each thread rolling the codes over a
// contiguous chunk of windows (a shift a byte where a byte loop per
// window cost k), then the sliding minimum (w reads) over positions
// strided across the threads; (4) the first-occurrence dedup through an
// open-addressing table of positions (the dedup pass below): one insert
// of 1.2-1.5 probes per k-mer, where a pairwise scan of the earlier codes
// cost NK^2 / 2 compares (130,816 a query at L = 576, 8.3 million at L =
// 4,096) and held 91 % of the kernel's 0.61 ms at B = 8, L = 4,096 on an
// H100 80GB HBM3 at 700 W; (5) run starts from a block max-scan, entry
// ids from a sum-scan, every k-mer scattered straight to its slot, and
// ok cleared by a query that needs more than U entries (the launch sets
// it first), in place of two PyTorch ops after the kernel.  On that card
// the kernel takes 0.021 ms at B = 256, L = 576 and 0.042 ms at B = 8,
// L = 4,096 (PERF.md, section 6).  The JAX program's uint32-pair
// arithmetic, nibble long division, one-hot compare-sums and NK chunking
// served the TPU and are not ported: u64 is native here.

constexpr int kSeqThreads = 512;
constexpr int kSeqPasses = 5;  // bytes, s-mer hashes, codes and minima, dedup, entries
constexpr unsigned long long kSmGamma = 0x9E3779B97F4A7C15ull;
constexpr unsigned long long kSmMul1 = 0xBF58476D1CE4E5B9ull;
constexpr unsigned long long kSmMul2 = 0x94D049BB133111EBull;

__device__ __forceinline__ unsigned long long splitmix64(unsigned long long z) {
  z += kSmGamma;
  z = (z ^ (z >> 30)) * kSmMul1;
  z = (z ^ (z >> 27)) * kSmMul2;
  return z ^ (z >> 31);
}

__device__ __forceinline__ unsigned long long base_code(uint8_t c) {
  return c == 'C' ? 1ull : c == 'G' ? 2ull : c == 'T' ? 3ull : 0ull;
}

__device__ __forceinline__ unsigned long long comp_code(uint8_t c) {
  return c == 'A' ? 3ull : c == 'C' ? 2ull : c == 'G' ? 1ull : 0ull;
}

// The forward and reverse-complement codes of the window of `len` bytes
// (len <= 32) at p, rolled one byte at a time: a thread codes its first
// window byte by byte and every later one with one shift each.
struct Window {
  unsigned long long fwd, rc, keep;
  int top;  // the reverse-complement code's shift for the newest byte

  __device__ __forceinline__ void start(const uint8_t* p, int len) {
    keep = len == 32 ? ~0ull : (1ull << (2 * len)) - 1ull;
    top = 2 * (len - 1);
    fwd = rc = 0ull;
    for (int j = 0; j < len; ++j) {
      fwd = (fwd << 2) | base_code(p[j]);
      rc |= comp_code(p[j]) << (2 * j);
    }
  }
  // Moves to the next window, whose last byte is c.
  __device__ __forceinline__ void next(uint8_t c) {
    fwd = ((fwd << 2) | base_code(c)) & keep;
    rc = (rc >> 2) | (comp_code(c) << top);
  }
  // The canonical code: the unsigned minimum of the two strands' codes.
  __device__ __forceinline__ unsigned long long canonical() const {
    return fwd < rc ? fwd : rc;
  }
};

// The contiguous chunk [c0, c1) of n positions that this thread takes.
__device__ __forceinline__ void thread_chunk(int n, int& c0, int& c1) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  c0 = min(n, static_cast<int>(threadIdx.x) * per);
  c1 = min(n, c0 + per);
}

struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct SumOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// Exclusive scan of one value per thread in thread order, with op and
// its identity; every thread of the block must call it.  s_warp holds 32
// ints of scratch.
template <typename Op>
__device__ int block_exclusive_scan(int v, int identity, Op op, int* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  int x = v;  // inclusive within the warp
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAllOnes, x, d);
    if (lane >= d) x = op(x, y);
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < nwarps ? s_warp[lane] : identity;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kAllOnes, t, d);
      if (lane >= d) t = op(t, y);
    }
    s_warp[lane] = t;  // inclusive over the warps
  }
  __syncthreads();
  int before = __shfl_up_sync(kAllOnes, x, 1);
  if (lane == 0) before = identity;
  if (warp > 0) before = op(s_warp[warp - 1], before);
  __syncthreads();  // s_warp is free for the next scan
  return before;
}

// The end of a cut build of kernel H (kPasses < kSeqPasses): one value
// of the last pass's shared state leaves, so no pass is compiled away.
__device__ __forceinline__ void seq_sink(int b, int tid, unsigned long long v,
                                         int32_t* __restrict__ n_valid) {
  if (tid == 0) n_valid[b] = static_cast<int32_t>(v);
}

// The dedup table's slots: a power of two, at least twice the k-mers.
__host__ __device__ __forceinline__ int table_bits(int nk) {
  int bits = 1;
  while ((1 << bits) < 2 * nk) ++bits;
  return bits;
}

// Dynamic shared memory: [NK] forward codes and [NS] s-mer hashes (u64),
// [NK] tiles, [NK] masks, [NK] table slots then positions in run, [2^t]
// the dedup table (32-bit), then the [L] query bytes.  *ok must hold 1
// before the launch; a query that needs more than U entries clears it.
template <int kPasses>
__global__ void __launch_bounds__(kSeqThreads)
seq_streams_kernel(const uint8_t* __restrict__ seqs, int L, const int32_t* __restrict__ lens,
                   int k, int s, unsigned long long seed, unsigned long long num_tiles, int h,
                   int tile_rows, int R, int U, int32_t* __restrict__ utile,
                   int64_t* __restrict__ gmask, int32_t* __restrict__ n_valid,
                   uint8_t* __restrict__ ok) {
  extern __shared__ unsigned long long s_code[];
  __shared__ int s_warp[32];
  __shared__ int s_appended;
  const int nk = L - k + 1;
  const int w = k - s + 1;
  const int bits = table_bits(nk);
  unsigned long long* s_hash = s_code + nk;
  int32_t* s_tile = reinterpret_cast<int32_t*>(s_hash + (L - s + 1));
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_tile + nk);
  int32_t* s_pos = reinterpret_cast<int32_t*>(s_mask + nk);
  int* s_table = s_pos + nk;
  uint8_t* s_seq = reinterpret_cast<uint8_t*>(s_table + (1 << bits));
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nv = max(0, min(nk, lens[b] - (k - 1)));  // valid k-mers: a prefix
  int32_t* q_utile = utile + static_cast<size_t>(b) * U;
  int64_t* q_gmask = gmask + static_cast<size_t>(b) * U * R;
  for (int i = tid; i < U; i += blockDim.x) q_utile[i] = 0;
  for (int i = tid; i < U * R; i += blockDim.x) q_gmask[i] = 0;
  const uint8_t* q_seq = seqs + static_cast<size_t>(b) * L;
  for (int i = tid; i < L; i += blockDim.x) s_seq[i] = q_seq[i];
  for (int i = tid; i < (1 << bits); i += blockDim.x) s_table[i] = -1;
  if (tid == 0) s_appended = 0;
  __syncthreads();
  if constexpr (kPasses == 1) return seq_sink(b, tid, s_seq[0], n_valid);

  // the seeded s-mer hashes of every window a valid k-mer spans, rolled
  // over each thread's chunk of windows
  int c0, c1;
  thread_chunk(nv > 0 ? nv + w - 1 : 0, c0, c1);
  Window win;
  if (c0 < c1) win.start(s_seq + c0, s);
  for (int p = c0; p < c1; ++p) {
    if (p > c0) win.next(s_seq[p + s - 1]);
    s_hash[p] = splitmix64(win.canonical() ^ seed);
  }
  __syncthreads();
  if constexpr (kPasses == 2) return seq_sink(b, tid, s_hash[0], n_valid);

  // per k-mer: forward code and slot mask, rolled over each thread's
  // chunk; then the minimizer tile, strided, so a warp's w reads of the
  // s-mer hashes fall on neighbouring words and not on two banks
  const unsigned long long slot_bits = static_cast<unsigned long long>(tile_rows - 1);
  thread_chunk(nv, c0, c1);
  if (c0 < c1) win.start(s_seq + c0, k);
  for (int i = c0; i < c1; ++i) {
    if (i > c0) win.next(s_seq[i + k - 1]);
    const unsigned long long hv = splitmix64(win.canonical());
    unsigned m = 0u;
    for (int j = 0; j < h; ++j) m |= 1u << static_cast<int>((hv >> (6 * j)) & slot_bits);
    s_code[i] = win.fwd;
    s_mask[i] = m;
  }
  for (int i = tid; i < nv; i += blockDim.x) {
    unsigned long long mn = s_hash[i];
    for (int j = 1; j < w; ++j) mn = min(mn, s_hash[i + j]);
    s_tile[i] = static_cast<int32_t>(mn % num_tiles);
  }
  __syncthreads();
  if constexpr (kPasses == 3) {
    return seq_sink(b, tid, s_code[0] ^ s_mask[0] ^ s_tile[0], n_valid);
  }

  // exact dedup, the first occurrence of a forward code winning: open
  // addressing over 2^bits slots of positions (-1 empty), probing from the
  // code's multiplicative hash.  A slot, once claimed, only ever holds
  // positions of its claimant's code, so an insert that meets its code
  // lowers the slot to its position; after the barrier k-mer i is a
  // duplicate exactly when its code's slot does not hold i.  Positions,
  // not codes, fill the table: every u64 is a forward code at k = 32.
  const unsigned last_slot = (1u << bits) - 1u;
  for (int i = tid; i < nv; i += blockDim.x) {
    const unsigned long long me = s_code[i];
    unsigned slot = static_cast<unsigned>((me * kSmGamma) >> (64 - bits));
    for (;;) {
      const int owner = atomicCAS(&s_table[slot], -1, i);
      if (owner < 0) break;
      if (s_code[owner] == me) {
        if (owner > i) atomicMin(&s_table[slot], i);
        break;
      }
      slot = (slot + 1u) & last_slot;
    }
    s_pos[i] = static_cast<int32_t>(slot);
  }
  __syncthreads();
  int appended = 0;
  for (int i = tid; i < nv; i += blockDim.x) {
    if (s_table[s_pos[i]] == i) {
      ++appended;
    } else {
      s_mask[i] = 0u;
    }
  }
  if (appended) atomicAdd(&s_appended, appended);
  __syncthreads();
  if constexpr (kPasses == 4) return seq_sink(b, tid, s_appended, n_valid);

  // run starts: a max-scan of (i where a run starts, else -1) over the
  // threads' contiguous chunks [c0, c1)
  thread_chunk(nv, c0, c1);
  int start = -1;
  for (int i = c0; i < c1; ++i) {
    if (i == 0 || s_tile[i] != s_tile[i - 1]) start = i;
    s_pos[i] = start;
  }
  const int carry = block_exclusive_scan(start, -1, MaxOp(), s_warp);
  // positions in run, and the entries each chunk opens
  int opened = 0;
  for (int i = c0; i < c1; ++i) {
    const int pos = i - max(s_pos[i], carry);
    s_pos[i] = pos;
    opened += pos % R == 0;
  }
  const int before = block_exclusive_scan(opened, 0, SumOp(), s_warp);

  // scatter: each k-mer to its slot, each entry's first k-mer its tile
  int entry = before - 1;
  for (int i = c0; i < c1; ++i) {
    const int slot = s_pos[i] % R;
    if (slot == 0) ++entry;
    if (entry < U) {
      if (slot == 0) q_utile[entry] = s_tile[i];
      q_gmask[static_cast<size_t>(entry) * R + slot] = static_cast<int64_t>(s_mask[i]);
    }
  }
  if (tid == blockDim.x - 1) {
    if (before + opened > U) *ok = 0;
    n_valid[b] = s_appended;
  }
}

template <int kPasses>
int launch_seq_streams(const void* seqs, int B, int L, const void* lens, int k, int s,
                       unsigned long long seed, int64_t num_tiles, int h, int tile_rows, int R,
                       int U, void* utile, void* gmask, void* n_valid, void* ok,
                       void* stream) {
  if (B <= 0 || k < 1 || k > 32 || s < 1 || s > k || L < k || h < 1 || h > 10 ||
      tile_rows < 1 || tile_rows > 32 || (tile_rows & (tile_rows - 1)) || num_tiles < 1 ||
      num_tiles >= (int64_t{1} << 31) || R < 1 || U < 0 ||
      static_cast<int64_t>(U) * R > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t nk = static_cast<size_t>(L - k + 1);
  const size_t smem = (nk + static_cast<size_t>(L - s + 1)) * sizeof(unsigned long long) +
                      (nk * 3 + (size_t{1} << table_bits(static_cast<int>(nk)))) *
                          sizeof(int32_t) +
                      static_cast<size_t>(L);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem + 256 > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(seq_streams_kernel<kPasses>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(ok, 1, 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  seq_streams_kernel<kPasses><<<B, kSeqThreads, smem, st>>>(
      static_cast<const uint8_t*>(seqs), L, static_cast<const int32_t*>(lens), k, s, seed,
      static_cast<unsigned long long>(num_tiles), h, tile_rows, R, U,
      static_cast<int32_t*>(utile), static_cast<int64_t*>(gmask),
      static_cast<int32_t*>(n_valid), static_cast<uint8_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}

// -- kernels I, J and K: k-mer hashing and the device build -----------------
//
// * kmer_rows (kernel I) replaces the XLA programs of
//   bigsi_tpu/ops/hash_jax.py: murmur3_32_jax (MurmurHash3_x86_32 of
//   each ASCII k-mer under each seed, the signed int32 of mmh3.hash),
//   canonicalize_jax (the byte-wise smaller of the k-mer and its reverse
//   complement; bytes other than ACGT complement to themselves) and
//   row_indices_jax (the hashes of seeds 0 .. h - 1, floor-mod m as
//   Python's % takes it: -5 mod 25 is 20), and the blocked rows of
//   bigsi_tpu/ops/build_jax.py:54-60 (seed 0 floor-mod max(1, m /
//   tile_rows) is the tile, seeds 1 .. h floor-mod tile_rows the slots,
//   the row tile * tile_rows + slot).  What bounds it: the k-mers'
//   bytes in (4.06 MB for 131,072 31-mers) and the rows out, about 0.002
//   ms at 3.35 TB/s.  The staged reader (below) is its design, and J's:
//   a block takes a run of up to 128 consecutive k-mers, one a thread,
//   whose bytes are one contiguous range, and copies the range into
//   shared memory with 16-byte cp.async, a warp instruction 512
//   contiguous bytes (a warp's byte load of one k-mer a thread spans 8
//   cache lines).  A thread reads its
//   k-mer as 32-bit words, two aligned shared loads and a funnel shift
//   each (the range starts anywhere: a run at i * k, a view such as
//   x[1:]); the reverse complement's words are the forward bytes' words
//   reversed and complemented through __byte_perm tables (A <-> T, C <->
//   G exactly, any other byte itself), and the strand is the one whose
//   lowest differing byte in the first differing word is the smaller.
//   murmur3 runs over the chosen strand's k / 4 words and tail, one lane
//   a seed, kSeedChunk seeds a pass; the floor-mods multiply (FastMod).
//   The run's raw hashes, classic rows, blocked rows or canonical bytes
//   are staged in shared memory and leave in 16-byte stores.  A run holds at most
//   kRunBytes of k-mers, so a long k-mer means fewer k-mers a run, down
//   to one.  The grid has a block a run, whose resident blocks overlap
//   one another's copies and hashing; past kMaxHashBlocks a block takes
//   further runs, the next one's copy in flight while it hashes (two
//   stages).  A persistent grid of two-stage blocks, 256-thread blocks,
//   and warps sorted by strand (so a warp of forward k-mers skips the
//   reverse complement) each measured slower on an H100 (PERF.md,
//   section 6).  The JAX program's select chain for the complement and
//   its static compare fold avoided gathers, which cost the TPU about 25x
//   the arithmetic.
// * bloom_scatter (kernel J) replaces the XLA program
//   bigsi_tpu/ops/build_jax.py:device_bloom: one sample's bloom from its
//   k-mers.  It reads and hashes each canonical k-mer as kernel I does
//   and sets its rows' bits with atomicOr into a zeroed uint32[ceil(m /
//   32)], bit p at bit p % 32 of word p / 32.  That is the Hopper form of
//   the JAX program's scatter-max on a byte per bit and its weighted-sum
//   repack (XLA has no scatter-OR); duplicate k-mers OR the same bits and
//   can never clear one, as an additive byte would after 256.  A blocked
//   k-mer's bits are ORed together by bloom word first (WordMerge), so
//   each word it touches takes one atomic: at tile_rows <= 32 dividing
//   32 its rows lie in one word (one atomic where there were h).  Classic
//   rows are random, an atomic each.  Rows past the bloom's last word
//   (blocked, m below tile_rows) are dropped, as the JAX scatter's
//   mode="drop" drops them.  Bound by bytes: the k-mers' bytes in (124 MB
//   for 4,000,000 31-mers) and the bloom out (3.1 MB at m = 2.5e7, which
//   stays in the 50 MB L2 while the atomics land).  What holds classic J
//   is the atomics: 12,000,000 scattered 32-bit atomics run at about 70
//   G/s on an H100, about 0.17 ms whatever the reader (PERF.md, section
//   6); fewer would take merging rows of different k-mers by bloom word.
// * bloom_transpose (kernel K) replaces the XLA program
//   bigsi_tpu/ops/build_jax.py:device_transpose: packed blooms uint32[N,
//   MW] (sample n's bit p at bit p % 32 of blooms[n, p / 32]) -> the
//   bitslice matrix uint32[m, W], W = ceil(N / 32) (bit n % 32 of
//   words[p, n / 32]).  It is kernel D at tile_rows 32 run backwards
//   (D's cols[t, n] is blooms[n, t]) and uses D's register transpose32.
//   A block of 8 warps owns kTrWords bloom words (32 * kTrWords bit
//   positions, so output rows) of 1,024 samples: it reads each sample's
//   kTrWords words as one run into shared memory, planes padded so
//   neither the stores nor the transposing reads conflict; then lane l of
//   a warp takes sample word w = 32 y + l of a bloom word, gathers its 32
//   samples' words, transposes them in registers and writes its 32 rows'
//   word w, so each warp store is 32 neighbouring words of one output row
//   (a whole 128-byte row at W = 32).  Samples past N read as 0, rows
//   past m are not written, and W need not be 32.  Bound: 3.2 GB in and
//   3.2 GB out at N = 1,024, m = 2.5e7, as kernel D's.

constexpr int kHashThreads = 128;    // a block; a run holds at most one k-mer a thread
constexpr int kSeedChunk = 4;        // seeds hashed per pass over a k-mer's words
constexpr int kRunBytes = 8192;      // k-mer bytes a run holds at most (past one k-mer)
constexpr int kOutRunBytes = 16384;  // output bytes a run of kernel I aims at
constexpr int kStages = 2;           // runs a block has in shared memory: hashed or in flight
constexpr int64_t kMaxHashBlocks = int64_t{1} << 20;  // past it a block takes further runs
constexpr int kStagePad = 16;        // stage bytes before the copy (reverse words read back)
constexpr int kMergeWords = 2;       // bloom words blocked J merges one k-mer's bits into
enum KmerOut { kOutHashes = 0, kOutClassic = 1, kOutBlocked = 2, kOutCanonical = 3 };

__device__ __forceinline__ unsigned lds32(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for all but the latest kPending committed groups of this thread's copies.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Each byte's top bit copied over the byte (prmt's sign mode: 0x80 -> 0xFF).
__device__ __forceinline__ unsigned byte_signs(unsigned x) {
  unsigned r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(0u), "r"(0xBA98u));
  return r;
}

__device__ __forceinline__ uintptr_t umax(uintptr_t a, uintptr_t b) { return a > b ? a : b; }
__device__ __forceinline__ uintptr_t umin(uintptr_t a, uintptr_t b) { return a < b ? a : b; }

// Copies bytes [b0, b1) of the k-mer tensor src (n bytes) into stage:
// the byte at address g lands at stage[kStagePad + g - a], a the address
// of b0 rounded down to 16.  A 16-byte chunk inside the tensor goes by
// cp.async (one warp instruction moves 512 contiguous bytes); a chunk
// that reaches past either end of the tensor (a view's unaligned start,
// the last run's end) is copied a byte at a time, its bytes in [b0, b1)
// only, so nothing outside the tensor is read.
__device__ __forceinline__ void stage_run(uint8_t* stage, const uint8_t* src, int64_t n,
                                          int64_t b0, int64_t b1) {
  const uintptr_t t0 = reinterpret_cast<uintptr_t>(src), t1 = t0 + n;
  const uintptr_t g0 = t0 + b0, g1 = t0 + b1, a = g0 & ~uintptr_t{15};
  const int chunks = static_cast<int>((g1 - a + 15) >> 4);
  for (int q = threadIdx.x; q < chunks; q += blockDim.x) {
    const uintptr_t c = a + 16 * static_cast<uintptr_t>(q);
    uint8_t* dst = stage + kStagePad + 16 * q;
    if (c >= t0 && c + 16 <= t1) {
      cp_async16(dst, reinterpret_cast<const void*>(c));
    } else {
      for (uintptr_t g = umax(c, g0); g < umin(c + 16, g1); ++g) {
        dst[g - c] = *reinterpret_cast<const uint8_t*>(g);
      }
    }
  }
}

// Stores n bytes of a run's output to dst, from ostage, where
// ostage[(dst % 16) + b] holds byte b: 16-byte stores, and byte stores in
// a chunk that the range covers only in part.
__device__ __forceinline__ void store_run(uint8_t* dst, const uint8_t* ostage, int64_t n) {
  const uintptr_t d0 = reinterpret_cast<uintptr_t>(dst), d1 = d0 + n, a = d0 & ~uintptr_t{15};
  const int chunks = static_cast<int>((d1 - a + 15) >> 4);
  for (int q = threadIdx.x; q < chunks; q += blockDim.x) {
    const uintptr_t c = a + 16 * static_cast<uintptr_t>(q);
    const uint8_t* src = ostage + 16 * q;
    if (c >= d0 && c + 16 <= d1) {
      *reinterpret_cast<uint4*>(c) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (uintptr_t g = umax(c, d0); g < umin(c + 16, d1); ++g) {
        *reinterpret_cast<uint8_t*>(g) = src[g - c];
      }
    }
  }
}

// 0x80 in each byte of y that is 0, else 0 (no carry crosses a byte).
__device__ __forceinline__ unsigned zero_bytes(unsigned y) {
  return ~(((y & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | y | 0x7F7F7F7Fu);
}

// The reverse complement of four bytes: byte order reversed, A <-> T and
// C <-> G, any other byte (N, lowercase) itself.  A byte's low 3 bits
// (A 1, C 3, T 4, G 7: distinct) index two 8-byte tables through
// __byte_perm: the letter of that code (an entry no byte of that code
// can equal where there is none) and what XOR complements it; the XOR
// applies where the byte is that letter.  The codes' nibbles come out in
// byte order 0, 2, 1, 3, and the last permute restores the order and
// reverses it.
__device__ __forceinline__ unsigned reverse_complement(unsigned x) {
  constexpr unsigned kLetterLo = 0x43034101u, kLetterHi = 0x47070454u;
  constexpr unsigned kXorLo = 0x04001500u, kXorHi = 0x04000015u;
  const unsigned t = x & 0x07070707u;
  const unsigned codes = t | (t >> 12);
  const unsigned xp = __byte_perm(x, 0, 0x3120);
  const unsigned letter = zero_bytes(__byte_perm(kLetterLo, kLetterHi, codes) ^ xp);
  const unsigned flip = __byte_perm(kXorLo, kXorHi, codes) & byte_signs(letter);
  return __byte_perm(xp ^ flip, 0, 0x0213);
}

// A staged k-mer read as murmur3's little-endian words on one strand.
// Word i is bytes 4i .. 4i + 3 of the k-mer from two aligned shared
// loads and a funnel shift: forward, the stage's bytes at s + 4i (s the
// k-mer's first byte); reverse complement, those at s + k - 4 - 4i,
// reverse-complemented.  The stage's pad and slack hold the bytes a word
// reads past the run; masked words drop them.
struct StagedKmer {
  unsigned addr;  // shared address of the aligned word holding word 0's first byte
  int step;       // bytes from word i's aligned word to word i + 1's: 4 or -4
  unsigned sh;    // bit offset of word 0 in its aligned word
  bool rc;        // the reverse complement
  int k;

  // stage: the stage's shared address; s: the k-mer's first byte in it
  __device__ __forceinline__ StagedKmer(unsigned stage, int s, int k_, bool rc_) : rc(rc_), k(k_) {
    const int p0 = rc ? s + k - 4 : s;
    addr = stage + 4 * (p0 >> 2);
    step = rc ? -4 : 4;
    sh = 8u * (p0 & 3);
  }

  __device__ __forceinline__ unsigned word(int i) const {
    const unsigned a = addr + step * i;
    const unsigned raw = __funnelshift_r(lds32(a), lds32(a + 4), sh);
    return rc ? reverse_complement(raw) : raw;
  }

  // word i with only the k-mer's bytes kept (the last word has k % 4)
  __device__ __forceinline__ unsigned masked(int i) const {
    const int left = k - 4 * i;
    const unsigned w = word(i);
    return left >= 4 ? w : w & ((1u << 8 * left) - 1u);
  }
};

// Whether the canonical form of the k-mer at stage byte s is its reverse
// complement: smaller in byte order than the k-mer.  The first word where
// the strands differ decides, by its lowest differing byte (the first in
// index order).
__device__ __forceinline__ bool reverse_is_smaller(unsigned stage, int s, int k) {
  const StagedKmer fwd(stage, s, k, false), rev(stage, s, k, true);
  const int words = (k + 3) >> 2;
  for (int i = 0; i < words; ++i) {
    const unsigned a = fwd.masked(i), b = rev.masked(i);
    if (a != b) {
      const int sh = (__ffs(a ^ b) - 1) & ~7;
      return (b >> sh & 0xFFu) < (a >> sh & 0xFFu);
    }
  }
  return false;
}

__device__ __forceinline__ unsigned murmur_block(unsigned kw) {
  return __funnelshift_l(kw * 0xCC9E2D51u, kw * 0xCC9E2D51u, 15) * 0x1B873593u;
}

// MurmurHash3_x86_32 of the k-mer under seeds[0 .. kLanes - 1].
template <int kLanes>
__device__ __forceinline__ void murmur3(const StagedKmer& km, const uint32_t* seeds,
                                        unsigned (&h)[kLanes]) {
#pragma unroll
  for (int j = 0; j < kLanes; ++j) h[j] = __ldg(seeds + j);
  const int nblocks = km.k >> 2;
#pragma unroll 4
  for (int i = 0; i < nblocks; ++i) {
    const unsigned kw = murmur_block(km.word(i));
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const unsigned x = h[j] ^ kw;
      h[j] = __funnelshift_l(x, x, 13) * 5u + 0xE6546B64u;
    }
  }
  if (km.k & 3) {
    const unsigned kw = murmur_block(km.masked(nblocks));
#pragma unroll
    for (int j = 0; j < kLanes; ++j) h[j] ^= kw;
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    unsigned x = h[j] ^ static_cast<unsigned>(km.k);
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    h[j] = x;
  }
}

// x mod d by multiplication (Lemire, Kaser and Kurz, "Faster remainder
// by direct computation", 2019): with M = ceil(2^64 / d), the top 64
// bits of (M x mod 2^64) d are x mod d for every u32 x and d (M wraps to
// 0 at d = 1, which gives 0).  mod() is the signed hash's floor-mod
// (Python's %): hash + 2^31 as a u32, less 2^31 mod d.
struct FastMod {
  unsigned long long M;
  unsigned d;
  int wrap;  // 2^31 mod d

  __device__ __forceinline__ int mod(unsigned hash) const {
    const unsigned long long low = M * (hash ^ 0x80000000u);
    const unsigned r = static_cast<unsigned>(
        (static_cast<unsigned long long>(static_cast<unsigned>(low >> 32)) * d +
         __umulhi(static_cast<unsigned>(low), d)) >> 32);
    const int v = static_cast<int>(r) - wrap;
    return v < 0 ? v + static_cast<int>(d) : v;
  }
};

FastMod fast_mod(unsigned d) {
  return FastMod{~0ull / d + 1, d, static_cast<int>((1u << 31) % d)};
}

// Calls emit(j, value) for outputs s0 .. s0 + kLanes - 1: kOutHashes the
// hash under seeds[j], kOutClassic that floor-mod m (rows), kOutBlocked
// slot j's row (output j - 1) in the tile of seed 0 (rows: the tiles,
// slots: tile_rows).
template <int kMode, int kLanes, typename Emit>
__device__ __forceinline__ void lane_values(const StagedKmer& km, const uint32_t* seeds, int s0,
                                            const FastMod& rows, const FastMod& slots,
                                            int& tile, Emit& emit) {
  unsigned h[kLanes];
  murmur3<kLanes>(km, seeds + s0, h);
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const int s = s0 + j;
    if constexpr (kMode == kOutHashes) {
      emit(s, static_cast<int>(h[j]));
    } else if constexpr (kMode == kOutClassic) {
      emit(s, rows.mod(h[j]));
    } else if (s == 0) {
      tile = rows.mod(h[j]);
    } else {
      emit(s - 1, tile * static_cast<int>(slots.d) + slots.mod(h[j]));
    }
  }
}

// Every output of the k-mer, kSeedChunk seeds a pass over its words.
template <int kMode, typename Emit>
__device__ __forceinline__ void kmer_values(const StagedKmer& km, const uint32_t* seeds,
                                            int nseeds, const FastMod& rows,
                                            const FastMod& slots, Emit emit) {
  int tile = 0;
  for (int s0 = 0; s0 < nseeds; s0 += kSeedChunk) {
    switch (nseeds - s0) {
      case 1: lane_values<kMode, 1>(km, seeds, s0, rows, slots, tile, emit); break;
      case 2: lane_values<kMode, 2>(km, seeds, s0, rows, slots, tile, emit); break;
      case 3: lane_values<kMode, 3>(km, seeds, s0, rows, slots, tile, emit); break;
      default: lane_values<kMode, kSeedChunk>(km, seeds, s0, rows, slots, tile, emit);
    }
  }
}

// One blocked k-mer's bloom bits, merged by 32-bit word before kernel J's
// atomics: the first kMergeWords words it touches take one atomicOr each,
// at the end (its rows lie in one word at tile_rows <= 32 dividing 32, in
// two at 64 or 24); a further word, if any, is ORed at once.  Rows past
// the bloom's last word are dropped.
struct WordMerge {
  int word[kMergeWords];
  unsigned bits[kMergeWords];

  __device__ __forceinline__ WordMerge() {
#pragma unroll
    for (int u = 0; u < kMergeWords; ++u) word[u] = -1, bits[u] = 0u;
  }

  // branch-free, so the words stay in registers
  __device__ __forceinline__ void add(int row, int64_t bloom_words, unsigned* bloom) {
    const int w = row >> 5;
    const unsigned bit = 1u << (row & 31);
    bool placed = w >= bloom_words;  // dropped
#pragma unroll
    for (int u = 0; u < kMergeWords; ++u) {
      const bool take = !placed && (word[u] == w || word[u] < 0);  // words fill in order
      word[u] = take ? w : word[u];
      bits[u] |= take ? bit : 0u;
      placed = placed || take;
    }
    if (!placed) atomicOr(bloom + w, bit);
  }

  __device__ __forceinline__ void flush(unsigned* bloom) const {
#pragma unroll
    for (int u = 0; u < kMergeWords; ++u) {
      if (word[u] >= 0) atomicOr(bloom + word[u], bits[u]);
    }
  }
};

// The run loop of kernels I and J.  Block b takes runs b, b + gridDim.x,
// ... of `run` consecutive k-mers in kStages stages of stage_bytes: while
// it hashes a run, the copies of its next kStages - 1 runs are in flight.
// body(stage's shared address, first k-mer i0, k-mers n, stage byte of
// k-mer i0) is called by every thread of the block, thread t owning k-mer
// i0 + t.
template <typename Body>
__device__ __forceinline__ void for_each_run(const uint8_t* kmers, int64_t K, int k, int run,
                                             int stage_bytes, uint8_t* smem, Body body) {
  const int64_t runs = (K + run - 1) / run;
  const auto stage = [&](int64_t r, uint8_t* dst) {
    const int64_t i1 = (r + 1) * run < K ? (r + 1) * run : K;
    stage_run(dst, kmers, K * k, r * run * k, i1 * k);
  };
  int64_t r = blockIdx.x;
  for (int j = 0; j < kStages - 1; ++j) {
    if (r + j * gridDim.x < runs) stage(r + j * gridDim.x, smem + j * stage_bytes);
    cp_async_commit();
  }
  for (int it = 0; r < runs; r += gridDim.x, ++it) {
    const int64_t ahead = r + (kStages - 1) * static_cast<int64_t>(gridDim.x);
    if (ahead < runs) stage(ahead, smem + (it + kStages - 1) % kStages * stage_bytes);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int64_t i0 = r * run;
    const int n = static_cast<int>(K - i0 < run ? K - i0 : run);
    const int s0 = kStagePad + static_cast<int>(reinterpret_cast<uintptr_t>(kmers + i0 * k) & 15);
    body(smem_addr(smem + it % kStages * stage_bytes), i0, n, s0);
    __syncthreads();  // the stage (and kernel I's output stage) is free again
  }
}

// kernel I: kmers uint8[K, k] -> out int32[K, per] (per = nseeds, or
// nseeds - 1 blocked) or, kOutCanonical, uint8[K, k].  A run's outputs
// are staged in shared memory after the input stages and leave in
// 16-byte stores.
template <int kMode>
__global__ void __launch_bounds__(kHashThreads)
kmer_rows_kernel(const uint8_t* __restrict__ kmers, int64_t K, int k, bool canonical,
                 const uint32_t* __restrict__ seeds, int nseeds, FastMod rows, FastMod slots,
                 int run, int stage_bytes, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ostage = smem + kStages * stage_bytes;
  const int per = kMode == kOutBlocked ? nseeds - 1 : nseeds;
  const int64_t row_bytes = kMode == kOutCanonical ? k : 4 * static_cast<int64_t>(per);
  for_each_run(kmers, K, k, run, stage_bytes, smem,
               [&](unsigned st, int64_t i0, int n, int s0) {
    uint8_t* dst = out + i0 * row_bytes;
    const int o = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
    const int j = threadIdx.x;
    if (j < n) {
      const bool rc = (canonical || kMode == kOutCanonical) && reverse_is_smaller(st, s0 + j * k, k);
      const StagedKmer km(st, s0 + j * k, k, rc);
      if constexpr (kMode == kOutCanonical) {
        uint8_t* bytes = ostage + o + j * k;
        for (int i = 0; 4 * i < k; ++i) {
          const unsigned w = km.word(i);
          for (int b = 0; b < 4 && 4 * i + b < k; ++b) bytes[4 * i + b] = static_cast<uint8_t>(w >> 8 * b);
        }
      } else {
        int32_t* values = reinterpret_cast<int32_t*>(ostage + o) + j * per;
        kmer_values<kMode>(km, seeds, nseeds, rows, slots, [&](int j, int v) { values[j] = v; });
      }
    }
    __syncthreads();
    store_run(dst, ostage, n * row_bytes);
  });
}

// kernel J: the canonical k-mers' rows (kOutClassic or kOutBlocked) set
// in bloom uint32[bloom_words], which the caller zeroed.
template <int kMode>
__global__ void __launch_bounds__(kHashThreads)
bloom_scatter_kernel(const uint8_t* __restrict__ kmers, int64_t K, int k,
                     const uint32_t* __restrict__ seeds, int nseeds, FastMod rows, FastMod slots,
                     int run, int stage_bytes, int64_t bloom_words, unsigned* __restrict__ bloom) {
  extern __shared__ __align__(16) uint8_t smem[];
  for_each_run(kmers, K, k, run, stage_bytes, smem,
               [&](unsigned st, int64_t, int n, int s0) {
    const int j = threadIdx.x;
    if (j < n) {
      const StagedKmer km(st, s0 + j * k, k, reverse_is_smaller(st, s0 + j * k, k));
      if constexpr (kMode == kOutClassic) {  // random rows: an atomic each
        kmer_values<kMode>(km, seeds, nseeds, rows, slots, [&](int, int row) {
          if ((row >> 5) < bloom_words) atomicOr(bloom + (row >> 5), 1u << (row & 31));
        });
      } else {
        WordMerge merged;
        kmer_values<kMode>(km, seeds, nseeds, rows, slots,
                           [&](int, int row) { merged.add(row, bloom_words, bloom); });
        merged.flush(bloom);
      }
    }
  });
}

// A launch of kernel I or J: `run` k-mers a run, kStages input stages of
// stage_bytes, then out_bytes for a run's outputs, and a block a run (up
// to kMaxHashBlocks).
struct HashLaunch {
  int run = 0;
  int stage_bytes = 0;
  int smem = 0;
  unsigned grid = 0;
  FastMod rows{}, slots{};
};

// out_per_kmer: kernel I's output bytes a k-mer, 0 for kernel J.  A run
// stays under kRunBytes of k-mers and kOutRunBytes of outputs, and holds
// at least one k-mer, so the stages grow with k only past kRunBytes;
// shared memory beyond the card's refuses the launch.  The moduli: m
// (classic), or the tiles and tile_rows (blocked).
template <typename Kernel>
int plan_hash(Kernel kernel, int64_t K, int k, int64_t out_per_kmer, int mode, int m,
              int tile_rows, HashLaunch& p) {
  int64_t run = kHashThreads;
  if (k > 0) run = std::min<int64_t>(run, std::max<int64_t>(1, kRunBytes / k));
  if (out_per_kmer > 0) {
    run = std::min<int64_t>(run, std::max<int64_t>(1, kOutRunBytes / out_per_kmer));
  }
  // the pad, up to 15 bytes of offset and of the last chunk, 8 bytes of reads past it
  const int64_t stage = (run * k + 64 + 15) / 16 * 16;
  const int64_t out_bytes = out_per_kmer > 0 ? (run * out_per_kmer + 16 + 15) / 16 * 16 : 0;
  const int64_t smem = kStages * stage + out_bytes;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  p.run = static_cast<int>(run);
  p.stage_bytes = static_cast<int>(stage);
  p.smem = static_cast<int>(smem);
  p.grid = static_cast<unsigned>(std::min<int64_t>((K + run - 1) / run, kMaxHashBlocks));
  const bool blocked = mode == kOutBlocked;
  p.rows = fast_mod(static_cast<unsigned>(blocked ? std::max(1, m / tile_rows) : m));
  p.slots = fast_mod(static_cast<unsigned>(tile_rows));
  return static_cast<int>(cudaSuccess);
}

template <int kMode>
int launch_kmer_rows(const void* kmers, int64_t K, int k, bool canonical, const void* seeds,
                     int nseeds, int m, int tile_rows, void* out, cudaStream_t stream) {
  const int64_t out_per_kmer =
      kMode == kOutCanonical ? k : 4 * static_cast<int64_t>(kMode == kOutBlocked ? nseeds - 1 : nseeds);
  HashLaunch p;
  const int err = plan_hash(kmer_rows_kernel<kMode>, K, k, out_per_kmer, kMode, m, tile_rows, p);
  if (err != 0) return err;
  kmer_rows_kernel<kMode><<<p.grid, kHashThreads, p.smem, stream>>>(
      static_cast<const uint8_t*>(kmers), K, k, canonical, static_cast<const uint32_t*>(seeds),
      nseeds, p.rows, p.slots, p.run, p.stage_bytes, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch_bloom_scatter(const void* kmers, int64_t K, int k, const void* seeds, int nseeds,
                         int m, int tile_rows, int64_t bloom_words, void* bloom,
                         cudaStream_t stream) {
  HashLaunch p;
  const int err = plan_hash(bloom_scatter_kernel<kMode>, K, k, 0, kMode, m, tile_rows, p);
  if (err != 0) return err;
  bloom_scatter_kernel<kMode><<<p.grid, kHashThreads, p.smem, stream>>>(
      static_cast<const uint8_t*>(kmers), K, k, static_cast<const uint32_t*>(seeds), nseeds,
      p.rows, p.slots, p.run, p.stage_bytes, bloom_words, static_cast<unsigned*>(bloom));
  return static_cast<int>(cudaGetLastError());
}

constexpr int kTrWords = 16;            // bloom words (32 bit positions each) of a block
constexpr int kTrThreads = 256;         // 8 warps
constexpr int kTrSamples = 1024;        // samples of a block: 32 sample words
constexpr int kTrPlane = kTrSamples + 1;  // one bloom word of the block's samples, padded
constexpr size_t kTrSmem = static_cast<size_t>(kTrWords) * kTrPlane * sizeof(unsigned);
constexpr int kTrBatch = 16;            // loads a thread keeps in flight

// kernel K: block (x, y) takes bloom words t0 = kTrWords x .. t0 +
// kTrWords - 1 of samples n0 = 1,024 y .. n0 + 1,023, i.e. rows 32 t0 ..
// 32 (t0 + kTrWords) - 1 of sample words 32 y .. 32 y + 31.
__global__ void __launch_bounds__(kTrThreads)
bloom_transpose_kernel(const unsigned* __restrict__ blooms, int N, int64_t MW, int64_t m, int W,
                       unsigned* __restrict__ words) {
  // word tt of block sample 32 l + j at s_in[tt * kTrPlane + 32 j + l]:
  // a warp's transposing read (fixed tt, j; l = lane) takes 32 banks, and
  // a load step's 16 threads of one sample (tt = 0 .. 15) 16 banks
  extern __shared__ unsigned s_in[];
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTrWords;
  const int n0 = blockIdx.y * kTrSamples;
  for (int base = threadIdx.x; base < kTrSamples * kTrWords; base += kTrThreads * kTrBatch) {
    unsigned v[kTrBatch];
#pragma unroll
    for (int u = 0; u < kTrBatch; ++u) {
      const int e = base + u * kTrThreads;  // sample e / kTrWords, its word e % kTrWords
      const int n = n0 + e / kTrWords;
      const int64_t t = t0 + e % kTrWords;
      v[u] = n < N && t < MW ? __ldg(blooms + static_cast<size_t>(n) * MW + t) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kTrBatch; ++u) {
      const int e = base + u * kTrThreads;
      const int ns = e / kTrWords;
      s_in[(e % kTrWords) * kTrPlane + (ns & 31) * 32 + (ns >> 5)] = v[u];
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.y * 32 + lane;
  for (int tt = threadIdx.x >> 5; tt < kTrWords; tt += kTrThreads / 32) {
    unsigned a[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) a[j] = s_in[tt * kTrPlane + 32 * j + lane];
    transpose32(a);  // a[c] is now row 32 (t0 + tt) + c of sample word w
    const int64_t r0 = (t0 + tt) * 32;
    if (w < W) {
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        if (r0 + c < m) words[(r0 + c) * W + w] = a[c];
      }
    }
  }
}

// -- kernel L: presence rows ------------------------------------------------
//
// presence_rows (kernel L) replaces the XLA programs of scoring's presence
// rows, one jitted program per scored query: bigsi_tpu/index/
// device_engine.py:_and_rows_fat (classic: the AND of a k-mer's h rows),
// :_blocked_and (ops/lookup.py:blocked_presence: the AND of the tile rows
// a slot mask selects) and :_cols_and (ops/lookup.py:cols_presence: the
// cols compare, packed to bits).  Per k-mer it writes the presence row
// out uint32[K, W], bit n % 32 of word n / 32 set iff sample n holds the
// k-mer: no counts, no AND over k-mers.  The row-major sources reuse
// kernels A's, B's and C's item fetch (ClassicRows; SlotRows at R = 1):
// block (kc k-mers, 32-word chunk) stages its k-mers' row ids or tiles
// and masks, then each warp takes whole k-mers, lane l owning word 32 *
// chunk + l, so a warp reads whole 128-byte row segments and writes one
// 128-byte segment of out per k-mer.  The cols source is kernel E's
// compare: a warp takes one k-mer, its 32 lanes the 32 samples of each
// word in turn, and a ballot of (cols[tile, n] & g) == g is the word.
// For the row slabs of a mesh or a fleet, the tiled sources take a tile
// window [t0, t1) of the matrix they are given (its first tile being
// tile t0): a k-mer whose tile lies outside gives 0, not the AND
// identity, so the slabs' rows add (or OR) into the whole.
//
// What bounds it: bytes, a few per k-mer.  At K = 512, h = 3, W = 32 it
// reads 1,536 rows of 128 bytes and writes 64 KB (about 0.27 MB, 0.08 us
// at 3.35 TB/s), so one call is a launch; scoring runs it once per scored
// query.  Nothing here is tuned: it is the simple form of the three
// programs in one launch.

constexpr int kLItems = 32;  // k-mers a presence block stages, at most

// Stages k-mer i of a presence block at `at` -> whether it lies in the
// tile window [t0, t1); a classic k-mer has no tile and always does.  A
// slot outside the window stages mask 0, which reads no row.
__device__ __forceinline__ bool stage_presence(const ClassicRows& rows, int at, int i, int, int) {
  rows.stage(at, i, 1ull);
  return true;
}
__device__ __forceinline__ bool stage_presence(const SlotRows& rows, int at, int i, int t0,
                                               int t1) {
  const int32_t t = rows.tile[i];
  const bool in = t >= t0 && t < t1;
  rows.s_mask[at] = in ? rows.key(i) : 0ull;
  rows.s_tile[at] = in ? t - t0 : 0;
  return in;
}

// grid (ceil(K / kc), ceil(W / 32)): block (x, chunk) writes out[k, 32 *
// chunk .. + 32) for its kc k-mers k.  Dynamic shared memory: [kc] staged
// k-mers (Rows::staged_bytes each).
template <typename Rows>
__global__ void __launch_bounds__(kBThreads)
presence_rows_kernel(const unsigned* __restrict__ words, int W, Rows rows, int kc, int t0,
                     int t1, int32_t* __restrict__ out) {
  extern __shared__ unsigned long long s_stage[];
  __shared__ bool s_in[kLItems];
  rows.bind(0, s_stage, kc);
  const int k0 = blockIdx.x * kc;
  const int n = min(kc, rows.items() - k0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_in[i] = stage_presence(rows, i, k0 + i, t0, t1);
  }
  __syncthreads();
  const int w = blockIdx.y * 32 + (threadIdx.x & 31);
  const bool live = w < W;
  const unsigned* col = words + w;
  for (int e = threadIdx.x >> 5; e < n; e += kBWarps) {
    unsigned v[kBRows];
    rows.first(v, e, n, col, W, live);
    unsigned c = v[0];
#pragma unroll
    for (int i = 1; i < kBRows; ++i) c &= v[i];
    rows.rest(c, e, col, W, live);
    if (live) out[static_cast<size_t>(k0 + e) * W + w] = s_in[e] ? static_cast<int32_t>(c) : 0;
  }
}

template <typename Rows>
int launch_presence(const void* words, int W, const Rows& rows, int K, int t0, int t1,
                    void* out, cudaStream_t stream) {
  const size_t per_item = rows.staged_bytes();
  const int kc = static_cast<int>(
      std::max<size_t>(1, std::min<size_t>(kLItems, kStageBytes / per_item)));
  const dim3 grid((K + kc - 1) / kc, (W + 31) / 32);
  presence_rows_kernel<Rows><<<grid, kBThreads, kc * per_item, stream>>>(
      static_cast<const unsigned*>(words), W, rows, kc, t0, t1, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The cols source: cols T[T_local, W * 32] (uint8, uint16 or uint32 bits);
// tile, mask as SlotRows's at R = 1.  grid (ceil(K / kBWarps), ceil(W /
// 32)): warp i of block (x, chunk) takes k-mer kBWarps * x + i and the
// chunk's words in turn, its lanes the 32 samples of a word, so a load
// reads 32 consecutive elements; kLInFlight words' loads are issued
// before their ballots.  Lane j keeps the ballot of word j, and the warp
// stores its row's chunk in one 128-byte write.
constexpr int kLInFlight = 8;

template <typename T>
__global__ void __launch_bounds__(kBThreads)
presence_cols_kernel(const T* __restrict__ cols, int W, const int32_t* __restrict__ tile,
                     const int64_t* __restrict__ mask, int K, int t0, int t1,
                     int32_t* __restrict__ out) {
  constexpr unsigned kField = sizeof(T) == 4 ? kAllOnes : (1u << (8 * (sizeof(T) & 3))) - 1u;
  const int k = blockIdx.x * kBWarps + (threadIdx.x >> 5);
  if (k >= K) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int w0 = blockIdx.y * 32;
  const int nw = min(32, W - w0);
  int32_t* row = out + static_cast<size_t>(k) * W + w0;
  const int32_t t = tile[k];
  if (t < t0 || t >= t1) {  // outside the window: 0
    if (lane < nw) row[lane] = 0;
    return;
  }
  const unsigned g = static_cast<unsigned>(mask[k]) & kField;  // the mask cut to the cols type
  const T* src = cols + static_cast<size_t>(t - t0) * W * 32 + static_cast<size_t>(w0) * 32 + lane;
  unsigned mine = 0u;
  for (int j0 = 0; j0 < nw; j0 += kLInFlight) {
    unsigned x[kLInFlight];
#pragma unroll
    for (int j = 0; j < kLInFlight; ++j) x[j] = j0 + j < nw ? src[(j0 + j) * 32] : 0u;
#pragma unroll
    for (int j = 0; j < kLInFlight; ++j) {
      const unsigned bits = __ballot_sync(kAllOnes, (x[j] & g) == g);
      if (lane == j0 + j) mine = bits;
    }
  }
  if (lane < nw) row[lane] = static_cast<int32_t>(mine);
}

template <typename T>
int launch_presence_cols(const void* cols, int W, const void* tile, const void* mask, int K,
                         int t0, int t1, void* out, cudaStream_t stream) {
  const dim3 grid((K + kBWarps - 1) / kBWarps, (W + 31) / 32);
  presence_cols_kernel<T><<<grid, kBThreads, 0, stream>>>(
      static_cast<const T*>(cols), W, static_cast<const int32_t*>(tile),
      static_cast<const int64_t*>(mask), K, t0, t1, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" {

// words uint32[m, W]; row_idx int32[B, K, h], every id in [0, m);
// mask uint8[B, K]; counts int32[B, W * 32]; exact int32[B, W].  Each
// query's k-mers are split into `splits` ranges, one block each; with
// splits > 1 counts and exact must hold 0 and all ones.  Launches on
// `stream` and returns cudaGetLastError().
int classic_counts(const void* words, int W, const void* row_idx, const void* mask, int B,
                   int K, int h, int splits, void* counts, void* exact, void* stream) {
  if (B <= 0 || W <= 0 || K < 0 || h <= 0 || splits < 1 || splits > 65535 ||
      static_cast<size_t>(h) * sizeof(int32_t) > kStageBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ClassicRows rows{static_cast<const int32_t*>(row_idx), static_cast<const uint8_t*>(mask),
                         K, h, nullptr};
  return launch_counts<true>(words, W, rows, B, splits, counts, exact,
                             static_cast<cudaStream_t>(stream));
}

// words uint32[m_pad, W] with m_pad a multiple of tile_rows; tile
// int32[B, K], every id in [0, m_pad / tile_rows); smask int64[B, K];
// counts int32[B, W * 32]; exact int32[B, W].  tile_rows in [1, 64].
int tile_counts(const void* words, int W, const void* tile, const void* smask,
                int B, int K, int tile_rows, void* counts, void* exact,
                void* stream) {
  return launch_slots<true>(words, W, tile, smask, B, K, 1, tile_rows, counts, exact,
                             static_cast<cudaStream_t>(stream));
}

// tile_counts without the exact AND: counts only.
int tile_counts_only(const void* words, int W, const void* tile, const void* smask,
                     int B, int K, int tile_rows, void* counts, void* stream) {
  return launch_slots<false>(words, W, tile, smask, B, K, 1, tile_rows, counts, nullptr,
                              static_cast<cudaStream_t>(stream));
}

// mat uint32[m, Wr], idx int32[n], every id in [0, m); out uint32[n, Wr].
// rows: rows each lane group keeps in flight, 1, 2, 4, 8, 16 or 32.
int gather_rows(const void* mat, int Wr, const void* idx, int64_t n, int rows, void* out,
                void* stream) {
  if (Wr <= 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = Wr % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(mat) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  return vec ? launch_gather_rows<uint4>(mat, Wr / 4, idx, n, rows, out, s)
             : launch_gather_rows<unsigned>(mat, Wr, idx, n, rows, out, s);
}

// words uint32[m_pad, W] with m_pad a multiple of tile_rows; tile
// int32[B, K], every id in [0, m_pad / tile_rows); valid uint8[B, K];
// out uint32[B, tile_rows, W].  tile_rows in [1, 64].
int tile_xor(const void* words, int W, const void* tile, const void* valid, int B, int K,
             int tile_rows, void* out, void* stream) {
  if (B <= 0 || W <= 0 || K < 0 || tile_rows < 1 || tile_rows > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t per_kmer = sizeof(int32_t) + sizeof(uint8_t);
  const int kc = static_cast<int>(std::max<size_t>(1, std::min<size_t>(K, kStageBytes / per_kmer)));
  const size_t smem = static_cast<size_t>(kWarps) * tile_rows * 32 * sizeof(unsigned) +
                      static_cast<size_t>(kc) * per_kmer;
  cudaError_t err = cudaFuncSetAttribute(
      tile_xor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, (W + 31) / 32);
  tile_xor_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(words), W, static_cast<const int32_t*>(tile),
      static_cast<const uint8_t*>(valid), K, tile_rows, kc, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// words uint32[m_pad, W] with m_pad a multiple of tile_rows; utile
// int32[B, U], every id in [0, m_pad / tile_rows); gmask int64[B, U, R];
// counts int32[B, W * 32]; exact int32[B, W].  tile_rows in [1, 64].
int grouped_tile_counts(const void* words, int W, const void* utile,
                        const void* gmask, int B, int U, int R, int tile_rows,
                        void* counts, void* exact, void* stream) {
  return launch_slots<true>(words, W, utile, gmask, B, U, R, tile_rows, counts, exact,
                             static_cast<cudaStream_t>(stream));
}

// words uint32[num_tiles * tile_rows, W]; cols [num_tiles, W * 32] of
// elem_bytes 1, 2 or 4 per element.  tile_rows in [1, 8 * elem_bytes].
// Any run of whole tiles: pass the pointers of a slice of both.
int pack_tile_cols(const void* words, int W, int64_t num_tiles, int tile_rows,
                   int elem_bytes, void* cols, void* stream) {
  if (W <= 0 || num_tiles <= 0 || tile_rows < 1 || tile_rows > 8 * elem_bytes ||
      num_tiles > (int64_t{1} << 62) / W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch_pack<uint8_t>(words, W, num_tiles, tile_rows, cols, s);
    case 2: return launch_pack<uint16_t>(words, W, num_tiles, tile_rows, cols, s);
    case 4: return launch_pack<uint32_t>(words, W, num_tiles, tile_rows, cols, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// cols [T, W * 32] of elem_bytes 1, 2 or 4, 16-byte aligned; utile
// int32[B, U], every id in [0, T); gmask int64[B, U, R]; n_valid
// int32[B]; counts int32[B, W * 32]; exact int32[B, W].
int cols_counts(const void* cols, int W, int elem_bytes, const void* utile,
                const void* gmask, const void* n_valid, int B, int U, int R,
                void* counts, void* exact, void* stream) {
  if (B <= 0 || W <= 0 || U < 0 || R < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1:
      return launch_cols_counts<uint8_t>(cols, W, utile, gmask, n_valid, B, U, R, counts,
                                         exact, s);
    case 2:
      return launch_cols_counts<uint16_t>(cols, W, utile, gmask, n_valid, B, U, R, counts,
                                          exact, s);
    case 4:
      return launch_cols_counts<uint32_t>(cols, W, utile, gmask, n_valid, B, U, R, counts,
                                          exact, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// seqs uint8[B, L]; lens int32[B]; utile int32[B, U]; gmask int64[B, U, R];
// n_valid int32[B]; ok uint8[1], 1 when every query needs at most U
// entries, else 0 (a bool).  1 <= s <= k <= 32, L >= k,
// 1 <= h <= 10, tile_rows a power of two up to 32, 1 <= num_tiles < 2^31;
// the shared memory of one query's state must fit the device.
int seq_streams(const void* seqs, int B, int L, const void* lens, int k, int s,
                unsigned long long seed, int64_t num_tiles, int h, int tile_rows, int R, int U,
                void* utile, void* gmask, void* n_valid, void* ok, void* stream) {
  return launch_seq_streams<kSeqPasses>(seqs, B, L, lens, k, s, seed, num_tiles, h, tile_rows,
                                        R, U, utile, gmask, n_valid, ok, stream);
}

// seq_streams cut after its first `passes` passes (1 to kSeqPasses), for
// the pass split of the probe bigsi_tpu_torch/scripts/probe_ah.py: the
// outputs of a cut build are not the contract's.
int seq_streams_cut(const void* seqs, int B, int L, const void* lens, int k, int s,
                    unsigned long long seed, int64_t num_tiles, int h, int tile_rows, int R,
                    int U, void* utile, void* gmask, void* n_valid, void* ok, int passes,
                    void* stream) {
  switch (passes) {
#define SEQ_CUT(P)                                                                         \
  case P:                                                                                  \
    return launch_seq_streams<P>(seqs, B, L, lens, k, s, seed, num_tiles, h, tile_rows, R, \
                                 U, utile, gmask, n_valid, ok, stream);
    SEQ_CUT(1) SEQ_CUT(2) SEQ_CUT(3) SEQ_CUT(4) SEQ_CUT(5)
#undef SEQ_CUT
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// kmers uint8[K, k]; seeds uint32[nseeds]; mode 0: out int32[K, nseeds],
// the signed hashes; 1: out int32[K, nseeds], the hashes floor-mod m; 2:
// out int32[K, nseeds - 1], the blocked rows (seed 0 the tile, the others
// the slots); 3: out uint8[K, k], the canonical k-mers (seeds unused).
// canonical: hash each k-mer's canonical form.  1 <= m, tile_rows < 2^31.
// kmers may start at any address.  The kStages stages of a run (at least
// one k-mer) and a run's outputs must fit a block's shared memory, or the
// launch returns cudaErrorInvalidValue: on an H100 at kStages = 2, k up
// to about 77,000 for mode 3 and 116,000 for J.
int kmer_rows(const void* kmers, int64_t K, int k, int canonical, const void* seeds, int nseeds,
              int mode, int m, int tile_rows, void* out, void* stream) {
  if (K < 0 || k < 0 || nseeds < 0 || m < 1 || tile_rows < 1 ||
      (mode == kOutBlocked && nseeds < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (K == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
#define KMER_ROWS(MODE)                                                                   \
  case MODE:                                                                              \
    return launch_kmer_rows<MODE>(kmers, K, k, canonical != 0, seeds, nseeds, m, tile_rows, \
                                  out, s);
    KMER_ROWS(kOutHashes) KMER_ROWS(kOutClassic) KMER_ROWS(kOutBlocked) KMER_ROWS(kOutCanonical)
#undef KMER_ROWS
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// kmers uint8[K, k]; seeds uint32[nseeds]; mode 1 (classic) or 2
// (blocked), as kmer_rows with canonical set; bloom uint32[bloom_words],
// zeroed by the caller, gets the rows' bits.
int bloom_scatter(const void* kmers, int64_t K, int k, const void* seeds, int nseeds, int mode,
                  int m, int tile_rows, int64_t bloom_words, void* bloom, void* stream) {
  if (K < 0 || k < 0 || nseeds < 0 || m < 1 || tile_rows < 1 || bloom_words < 0 ||
      (mode == kOutBlocked && nseeds < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (K == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kOutClassic:
      return launch_bloom_scatter<kOutClassic>(kmers, K, k, seeds, nseeds, m, tile_rows,
                                               bloom_words, bloom, s);
    case kOutBlocked:
      return launch_bloom_scatter<kOutBlocked>(kmers, K, k, seeds, nseeds, m, tile_rows,
                                               bloom_words, bloom, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// blooms uint32[N, MW]; words uint32[m, W], W = ceil(N / 32);
// 1 <= m <= 32 * MW.
int bloom_transpose(const void* blooms, int N, int64_t MW, int64_t m, int W, void* words,
                    void* stream) {
  if (N < 1 || MW < 1 || m < 1 || m > 32 * MW || W != (N + 31) / 32 ||
      (W + 31) / 32 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      bloom_transpose_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kTrSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((MW + kTrWords - 1) / kTrWords), (W + 31) / 32);
  bloom_transpose_kernel<<<grid, kTrThreads, kTrSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(blooms), N, MW, m, W, static_cast<unsigned*>(words));
  return static_cast<int>(cudaGetLastError());
}

// Kernel L, presence rows; out int32[K, W] (uint32 bits).  The row
// sources: words uint32[m, W] and row_idx int32[K, h], every id in [0, m)
// (classic); words uint32[(t1 - t0) * tile_rows or more, W], the tiles
// from t0 on, tile int32[K] and smask int64[K] (slot; tile_rows in [1,
// 64]).  A tile outside [t0, t1) gives a row of 0.  K >= 1.
int presence_rows_classic(const void* words, int W, const void* row_idx, int K, int h,
                          void* out, void* stream) {
  if (K <= 0 || W <= 0 || (W + 31) / 32 > 65535 || h <= 0 ||
      static_cast<size_t>(h) * sizeof(int32_t) > kStageBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ClassicRows rows{static_cast<const int32_t*>(row_idx), nullptr, K, h, nullptr};
  return launch_presence(words, W, rows, K, 0, 1, out, static_cast<cudaStream_t>(stream));
}

int presence_rows_slot(const void* words, int W, const void* tile, const void* smask, int K,
                       int tile_rows, int t0, int t1, void* out, void* stream) {
  if (K <= 0 || W <= 0 || (W + 31) / 32 > 65535 || tile_rows < 1 || tile_rows > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SlotRows rows{static_cast<const int32_t*>(tile), static_cast<const int64_t*>(smask), K, 1,
                      tile_rows, nullptr, nullptr, 0ull};
  return launch_presence(words, W, rows, K, t0, t1, out, static_cast<cudaStream_t>(stream));
}

// The cols source: cols [(t1 - t0) or more, W * 32] of elem_bytes 1, 2 or
// 4, the tiles from t0 on; tile int32[K]; smask int64[K].
int presence_rows_cols(const void* cols, int W, int elem_bytes, const void* tile,
                       const void* smask, int K, int t0, int t1, void* out, void* stream) {
  if (K <= 0 || W <= 0 || (W + 31) / 32 > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch_presence_cols<uint8_t>(cols, W, tile, smask, K, t0, t1, out, s);
    case 2: return launch_presence_cols<uint16_t>(cols, W, tile, smask, K, t0, t1, out, s);
    case 4: return launch_presence_cols<uint32_t>(cols, W, tile, smask, K, t0, t1, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
