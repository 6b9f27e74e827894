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
//   As in P2/P3, each entry's tile is read from device memory once for
//   all R slots: a warp loads the rows that any slot selects (the union
//   of the masks) into its own shared-memory buffer, lane l keeping
//   column l, and every slot ANDs its rows from there.  The TPU kernels'
//   W == 32 limit, U % 16 == 0, twisted lanes and carry-save planes
//   served the TPU's vector unit and do not carry over.
// * tile_counts_only is kernel B built without the exact AND and its
//   write (template kExact = false): the counts-only stage k2 of the
//   bisection probe scripts/bisect_kernel.py:49 (S3).
//
// Kernels F and G, gather_rows and tile_xor, are the probes' kernels, and
// kernel H, seq_streams, is the seq serving arm's prep: each is described
// at its code below.
//
// What bounds kernels A, B and C on an H100: gathered bytes, at random rows.  At
// m = 2.5e7 and W = 32 the matrix is 3.2 GB, far beyond the 50 MB L2, so
// each k-mer costs h HBM reads of one 128-byte row segment, and the work
// per row (an AND and 32 counter adds per lane) is small beside the
// latency of the read.  The design keeps many reads in flight: one
// block per (query, 32-word chunk), 16 warps that split the query's
// k-mers into contiguous runs, lane l owning word 32 * chunk + l with 32
// per-bit counters in registers, and the reads of kUnroll k-mers issued
// before any is consumed.  Row ids (or tiles and masks) are staged in
// shared memory first, so no read waits on an index load.  The warps'
// counters meet in shared memory at the end and leave in one coalesced
// write.  The TPU kernel's run-deduplicated DMA streams, twisted count
// order, bank-alternated slots and W == 32 limit served the TPU's DMA
// issue rate and scalar memory; here L1 and L2 serve a repeated tile.
//
// Offsets into the matrix are size_t: row * W * 4 reaches 3.2e9 bytes.

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;    // k-mers whose row reads are issued together
constexpr int kStride = 33;   // padded row of the shared counters
constexpr unsigned kAllOnes = 0xFFFFFFFFu;

struct Acc {
  int cnt[32];
  unsigned exact;
};

template <bool kExact = true>
__device__ __forceinline__ void add_kmer(Acc& acc, unsigned p) {
#pragma unroll
  for (int j = 0; j < 32; ++j) acc.cnt[j] += (p >> j) & 1u;
  if (kExact) acc.exact &= p;
}

// Sums the block's accumulators and writes query b's slice of counts
// (32 counters per word, sample order) and, with kExact, exact for this
// chunk.
template <bool kExact = true>
__device__ void write_out(const Acc& acc, int b, int chunk, int W,
                          int32_t* __restrict__ counts,
                          int32_t* __restrict__ exact) {
  __shared__ int s_cnt[32 * kStride];
  __shared__ unsigned s_exact[32];
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 32 * kStride; i += blockDim.x) s_cnt[i] = 0;
  if (kExact && threadIdx.x < 32) s_exact[threadIdx.x] = kAllOnes;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 32; ++j) atomicAdd(&s_cnt[lane * kStride + j], acc.cnt[j]);
  if (kExact) atomicAnd(&s_exact[lane], acc.exact);
  __syncthreads();
  const int nw = min(32, W - chunk * 32);
  const size_t word0 = static_cast<size_t>(b) * W + static_cast<size_t>(chunk) * 32;
  int32_t* out = counts + word0 * 32;
  for (int i = threadIdx.x; i < nw * 32; i += blockDim.x) {
    out[i] = s_cnt[(i >> 5) * kStride + (i & 31)];
  }
  if (kExact && threadIdx.x < nw) {
    exact[word0 + threadIdx.x] = static_cast<int32_t>(s_exact[threadIdx.x]);
  }
}

// The contiguous run [lo, hi) of a staged chunk of n k-mers that this
// warp consumes.
__device__ __forceinline__ void warp_run(int n, int& lo, int& hi) {
  const int per = (n + kWarps - 1) / kWarps;
  lo = min(n, (static_cast<int>(threadIdx.x) >> 5) * per);
  hi = min(n, lo + per);
}

__global__ void __launch_bounds__(kThreads)
classic_counts_kernel(const unsigned* __restrict__ words, int W,
                      const int32_t* __restrict__ row_idx,
                      const uint8_t* __restrict__ mask, int K, int h, int kc,
                      int32_t* __restrict__ counts, int32_t* __restrict__ exact) {
  extern __shared__ int32_t s_rows[];  // [kc * h] row ids, then kc flags
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_rows + kc * h);
  const int b = blockIdx.x;
  const int chunk = blockIdx.y;
  const int w = chunk * 32 + (threadIdx.x & 31);
  const bool live = w < W;
  const int32_t* q_rows = row_idx + static_cast<size_t>(b) * K * h;
  const uint8_t* q_valid = mask + static_cast<size_t>(b) * K;
  Acc acc = {};
  acc.exact = kAllOnes;
  for (int k0 = 0; k0 < K; k0 += kc) {
    const int n = min(kc, K - k0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < n * h; i += blockDim.x) {
      s_rows[i] = q_rows[static_cast<size_t>(k0) * h + i];
    }
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_valid[i] = q_valid[k0 + i];
    __syncthreads();
    int lo, hi;
    warp_run(n, lo, hi);
    for (int i = lo; i < hi; i += kUnroll) {
      unsigned p[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = i + u;
        ok[u] = e < hi && s_valid[e] != 0;
        p[u] = kAllOnes;
        if (ok[u] && live) {
          const int32_t* r = s_rows + e * h;
          for (int j = 0; j < h; ++j) {
            p[u] &= __ldg(words + static_cast<size_t>(r[j]) * W + w);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (ok[u]) add_kmer(acc, p[u]);
      }
    }
  }
  write_out(acc, b, chunk, W, counts, exact);
}

// kExact = false is the counts-only build: exact is not written (and
// may be null).
template <bool kExact>
__global__ void __launch_bounds__(kThreads)
tile_counts_kernel(const unsigned* __restrict__ words, int W,
                   const int32_t* __restrict__ tile,
                   const int64_t* __restrict__ smask, int K, int tile_rows,
                   int kc, int32_t* __restrict__ counts,
                   int32_t* __restrict__ exact) {
  extern __shared__ unsigned long long s_mask[];  // [kc] masks, then [kc] tiles
  int32_t* s_tile = reinterpret_cast<int32_t*>(s_mask + kc);
  const unsigned long long rows_mask =
      tile_rows >= 64 ? ~0ull : (1ull << tile_rows) - 1ull;
  const int b = blockIdx.x;
  const int chunk = blockIdx.y;
  const int w = chunk * 32 + (threadIdx.x & 31);
  const bool live = w < W;
  const int32_t* q_tile = tile + static_cast<size_t>(b) * K;
  const int64_t* q_mask = smask + static_cast<size_t>(b) * K;
  Acc acc = {};
  acc.exact = kAllOnes;
  for (int k0 = 0; k0 < K; k0 += kc) {
    const int n = min(kc, K - k0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      s_mask[i] = static_cast<unsigned long long>(q_mask[k0 + i]);
      s_tile[i] = q_tile[k0 + i];
    }
    __syncthreads();
    int lo, hi;
    warp_run(n, lo, hi);
    for (int i = lo; i < hi; i += kUnroll) {
      unsigned p[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = i + u;
        const unsigned long long sm = e < hi ? s_mask[e] : 0ull;
        ok[u] = sm != 0ull;
        p[u] = kAllOnes;
        if (ok[u] && live) {
          const size_t base = static_cast<size_t>(s_tile[e]) * tile_rows;
          for (unsigned long long sel = sm & rows_mask; sel != 0ull; sel &= sel - 1ull) {
            const int s = __ffsll(static_cast<long long>(sel)) - 1;
            p[u] &= __ldg(words + (base + s) * W + w);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (ok[u]) add_kmer<kExact>(acc, p[u]);
      }
    }
  }
  write_out<kExact>(acc, b, chunk, W, counts, exact);
}

constexpr int kRowBatch = 8;  // row reads of one entry issued together

// Dynamic shared memory: [kc] tile ids, [kc * R] slot masks, then per
// warp a [tile_rows][32] buffer of the current entry's selected rows.
__global__ void __launch_bounds__(kThreads)
grouped_tile_counts_kernel(const unsigned* __restrict__ words, int W,
                           const int32_t* __restrict__ utile,
                           const int64_t* __restrict__ gmask, int U, int R,
                           int tile_rows, int kc, int32_t* __restrict__ counts,
                           int32_t* __restrict__ exact) {
  extern __shared__ unsigned long long s_gmask[];  // [kc * R]
  int32_t* s_tile = reinterpret_cast<int32_t*>(s_gmask + static_cast<size_t>(kc) * R);
  unsigned* s_rows = reinterpret_cast<unsigned*>(s_tile + kc) +
                     (threadIdx.x >> 5) * tile_rows * 32;
  const unsigned long long rows_mask =
      tile_rows >= 64 ? ~0ull : (1ull << tile_rows) - 1ull;
  const int b = blockIdx.x;
  const int chunk = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = chunk * 32 + lane;
  const bool live = w < W;
  const int32_t* q_tile = utile + static_cast<size_t>(b) * U;
  const int64_t* q_mask = gmask + static_cast<size_t>(b) * U * R;
  Acc acc = {};
  acc.exact = kAllOnes;
  for (int u0 = 0; u0 < U; u0 += kc) {
    const int n = min(kc, U - u0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < n * R; i += blockDim.x) {
      s_gmask[i] = static_cast<unsigned long long>(q_mask[static_cast<size_t>(u0) * R + i]);
    }
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_tile[i] = q_tile[u0 + i];
    __syncthreads();
    int lo, hi;
    warp_run(n, lo, hi);
    for (int e = lo; e < hi; ++e) {
      const unsigned long long* g = s_gmask + static_cast<size_t>(e) * R;
      unsigned long long need = 0ull;
      for (int j = 0; j < R; ++j) need |= g[j];
      need &= rows_mask;
      // each selected row once, kRowBatch reads in flight; a lane
      // writes and later reads only its own column, so no sync
      const size_t base = static_cast<size_t>(s_tile[e]) * tile_rows;
      while (need != 0ull) {
        int s[kRowBatch];
        unsigned v[kRowBatch];
#pragma unroll
        for (int q = 0; q < kRowBatch; ++q) {
          s[q] = -1;
          v[q] = 0u;
          if (need != 0ull) {
            s[q] = __ffsll(static_cast<long long>(need)) - 1;
            need &= need - 1ull;
            if (live) v[q] = __ldg(words + (base + s[q]) * W + w);
          }
        }
#pragma unroll
        for (int q = 0; q < kRowBatch; ++q) {
          if (s[q] >= 0) s_rows[s[q] * 32 + lane] = v[q];
        }
      }
      for (int j = 0; j < R; ++j) {
        const unsigned long long sm = g[j];
        if (sm == 0ull) continue;  // padding slot
        unsigned p = kAllOnes;
        for (unsigned long long sel = sm & rows_mask; sel != 0ull; sel &= sel - 1ull) {
          p &= s_rows[(__ffsll(static_cast<long long>(sel)) - 1) * 32 + lane];
        }
        add_kmer(acc, p);
      }
    }
  }
  write_out(acc, b, chunk, W, counts, exact);
}

constexpr size_t kStageBytes = 32 * 1024;  // shared memory for staged k-mers

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
//   transpose: a warp takes (tile, 32-word chunk), stages the tile's
//   rows of that chunk in shared memory with coalesced reads, then for
//   each word lets lane s hold row s and builds sample j's column with
//   one warp ballot over bit j.  Lane j keeps ballot j, so the warp's
//   32 outputs of a word leave in one coalesced store.  It reads the
//   matrix once and writes it once (3.2 GB each at m = 2.5e7, 1,024
//   samples).
// * cols_counts (kernel E) replaces the XLA program
//   bigsi_tpu/ops/lookup.py:grouped_counts_cols.  Grouped streams in
//   (entry u of query b: tile utile[b, u] and R slot masks, mask 0 =
//   padding slot), counts[b, n] = sum over (u, j) of
//   [(cols[utile[b, u], n] & g) == g] - (U * R - n_valid[b]) out, as the
//   JAX program writes it (padding slots compare true and are
//   subtracted), plus exact[b, w]: the AND over the slots with g != 0,
//   bit n % 32 of word n / 32 (all ones when no slot is valid).  One
//   thread per sample reads each gathered cols row coalesced; the
//   query's tiles and masks are staged in shared memory first, and the
//   cols reads of kUnroll entries are issued before any is consumed.
//   The JAX program's two half-U chains and int16 accumulator served
//   the TPU's vector unit and are not ported.
//
// Offsets into cols are size_t: t * N reaches 1.6e9 elements.

constexpr int kColsWarps = 8;
constexpr int kColsThreads = 32 * kColsWarps;

// grid (ceil(T / kColsWarps), ceil(W / 32)); warp i of block x takes
// tile x * kColsWarps + i and 32-word chunk blockIdx.y.
template <typename T>
__global__ void __launch_bounds__(kColsThreads)
pack_tile_cols_kernel(const unsigned* __restrict__ words, int W, int64_t num_tiles,
                      int tile_rows, T* __restrict__ cols) {
  __shared__ unsigned s_rows[kColsWarps][32][33];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kColsWarps + warp;
  if (t >= num_tiles) return;  // whole warps only: no block-wide sync below
  const int c = blockIdx.y;
  const int nw = min(32, W - c * 32);
  unsigned (*rows)[33] = s_rows[warp];
  const unsigned* tile = words + static_cast<size_t>(t) * tile_rows * W + c * 32;
  for (int s = 0; s < tile_rows; ++s) {
    rows[s][lane] = lane < nw ? tile[static_cast<size_t>(s) * W + lane] : 0u;
  }
  __syncwarp();
  const size_t n_cols = static_cast<size_t>(W) * 32;
  T* out = cols + static_cast<size_t>(t) * n_cols + static_cast<size_t>(c) * 1024;
  for (int w = 0; w < nw; ++w) {
    const unsigned x = lane < tile_rows ? rows[lane][w] : 0u;  // lane s: row s
    unsigned mine = 0u;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const unsigned col = __ballot_sync(kAllOnes, (x >> j) & 1u);  // bit s = row s
      if (lane == j) mine = col;
    }
    out[w * 32 + lane] = static_cast<T>(mine);
  }
}

// grid (B, ceil(N / kColsThreads)); thread n of the block's slice owns
// sample n.  N = W * 32, so a warp is one word of exact.
template <typename T>
__global__ void __launch_bounds__(kColsThreads)
cols_counts_kernel(const T* __restrict__ cols, int W, const int32_t* __restrict__ utile,
                   const int64_t* __restrict__ gmask, const int32_t* __restrict__ n_valid,
                   int U, int R, int kc, int32_t* __restrict__ counts,
                   int32_t* __restrict__ exact) {
  extern __shared__ unsigned s_g[];  // [kc * R] masks cut to T's width, then [kc] tiles
  int32_t* s_tile = reinterpret_cast<int32_t*>(s_g + static_cast<size_t>(kc) * R);
  const int b = blockIdx.x;
  const int N = W * 32;
  const int n = blockIdx.y * kColsThreads + threadIdx.x;
  const bool live = n < N;
  const int32_t* q_tile = utile + static_cast<size_t>(b) * U;
  const int64_t* q_mask = gmask + static_cast<size_t>(b) * U * R;
  int hits = 0;
  bool all = true;
  for (int u0 = 0; u0 < U; u0 += kc) {
    const int m = min(kc, U - u0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < m * R; i += blockDim.x) {
      s_g[i] = static_cast<T>(q_mask[static_cast<size_t>(u0) * R + i]);
    }
    for (int i = threadIdx.x; i < m; i += blockDim.x) s_tile[i] = q_tile[u0 + i];
    __syncthreads();
    if (!live) continue;
    for (int e = 0; e < m; e += kUnroll) {
      unsigned c[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        c[q] = e + q < m ? static_cast<unsigned>(
                               __ldg(cols + static_cast<size_t>(s_tile[e + q]) * N + n))
                         : 0u;
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        if (e + q >= m) break;
        const unsigned* g = s_g + static_cast<size_t>(e + q) * R;
        for (int j = 0; j < R; ++j) {
          const bool in = (c[q] & g[j]) == g[j];
          hits += in;
          all = all && (in || g[j] == 0u);
        }
      }
    }
  }
  const unsigned word = __ballot_sync(kAllOnes, all);
  if (!live) return;
  const int64_t pad = static_cast<int64_t>(U) * R - n_valid[b];
  counts[static_cast<size_t>(b) * N + n] = static_cast<int32_t>(hits - pad);
  if ((threadIdx.x & 31) == 0) {
    exact[static_cast<size_t>(b) * W + n / 32] = static_cast<int32_t>(word);
  }
}

template <typename T>
int launch_pack(const void* words, int W, int64_t num_tiles, int tile_rows, void* cols,
                cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((num_tiles + kColsWarps - 1) / kColsWarps),
                  (W + 31) / 32);
  pack_tile_cols_kernel<T><<<grid, kColsThreads, 0, stream>>>(
      static_cast<const unsigned*>(words), W, num_tiles, tile_rows, static_cast<T*>(cols));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cols_counts(const void* cols, int W, const void* utile, const void* gmask,
                       const void* n_valid, int B, int U, int R, void* counts, void* exact,
                       cudaStream_t stream) {
  const size_t per_entry = sizeof(int32_t) + static_cast<size_t>(R) * sizeof(unsigned);
  if (per_entry > kStageBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int kc = static_cast<int>(std::max<size_t>(1, std::min<size_t>(U, kStageBytes / per_entry)));
  const size_t smem = static_cast<size_t>(kc) * per_entry;
  const dim3 grid(B, (W * 32 + kColsThreads - 1) / kColsThreads);
  cols_counts_kernel<T><<<grid, kColsThreads, smem, stream>>>(
      static_cast<const T*>(cols), W, static_cast<const int32_t*>(utile),
      static_cast<const int64_t*>(gmask), static_cast<const int32_t*>(n_valid), U, R, kc,
      static_cast<int32_t*>(counts), static_cast<int32_t*>(exact));
  return static_cast<int>(cudaGetLastError());
}

template <bool kExact>
int launch_tile_counts(const void* words, int W, const void* tile, const void* smask, int B,
                       int K, int tile_rows, void* counts, void* exact, cudaStream_t stream) {
  if (B <= 0 || W <= 0 || K < 0 || tile_rows < 1 || tile_rows > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t per_kmer = sizeof(unsigned long long) + sizeof(int32_t);
  const int kc = static_cast<int>(std::max<size_t>(1, std::min<size_t>(K, kStageBytes / per_kmer)));
  const size_t smem = static_cast<size_t>(kc) * per_kmer;
  const dim3 grid(B, (W + 31) / 32);
  tile_counts_kernel<kExact><<<grid, kThreads, smem, stream>>>(
      static_cast<const unsigned*>(words), W, static_cast<const int32_t*>(tile),
      static_cast<const int64_t*>(smask), K, tile_rows, kc,
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
// 32-bit masks, n_valid int32[B]) and per query the number of entries it
// needs (u_count int32[B]; the caller's ok is u_count <= U everywhere).
// k-mer i of query b is valid when i < lens[b] - k + 1.  Per valid k-mer:
// the forward and reverse-complement 2-bit codes (A and other bytes 0,
// C 1, G 2, T 3; only ACGT are complemented), the slot mask (bit
// (hv >> 6j) & (tile_rows - 1) for j < h, hv the splitmix64 of the
// unsigned minimum of the two codes) and the tile (the unsigned minimum
// of splitmix64(canonical s-mer ^ seed) over the w = k - s + 1 s-mers the
// k-mer spans, modulo num_tiles).  A k-mer whose forward code occurred at
// an earlier valid position is a duplicate: it keeps its slot with mask 0
// and n_valid does not count it.  Runs of one tile open an entry at their
// start and every R positions after (pos % R == 0); slot pos % R of the
// entry holds the k-mer.  Entries at or past U are not written; what is
// not written is 0.
//
// One block per query.  The query's bytes, its k-mers' forward codes,
// masks and tiles, and the s-mer hashes live in shared memory (about 120
// KB at L = 4,096, the longest query the engine's guard admits; opted in
// past 48 KB).  Every pass is over positions, strided across the
// threads: the s-mer hashes, then codes, masks and the sliding minimum
// (w reads per k-mer), then the exact first-occurrence dedup, a pairwise
// scan of the earlier codes (lanes read one code at a time, so a warp's
// reads are broadcasts).  Run starts come from a block max-scan and entry
// ids from a sum-scan, each thread owning a contiguous chunk of
// positions, and every k-mer is then scattered straight to its slot.
// What bounds it is the dedup: NK^2 / 2 compares per query, about 150,000
// at L = 576 (the engine's guard bounds B * NK^2 for long queries).  On
// an H100 80GB HBM3 at 700 W it takes 0.04 ms at B = 256, L = 576 (its
// plain version 3.5-5.3 ms) and 0.61 ms at B = 8, L = 4,096, where 8
// blocks leave most SMs idle.  The
// JAX program's uint32-pair arithmetic, nibble long division, one-hot
// compare-sums and NK chunking served the TPU and are not ported: u64 is
// native here.

constexpr int kSeqThreads = 512;
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

// The forward code of bytes p[0, len) (len <= 32) into *fwd; returns the
// canonical code, the unsigned minimum of the forward and
// reverse-complement codes.
__device__ __forceinline__ unsigned long long canonical_code(const uint8_t* p, int len,
                                                             unsigned long long* fwd) {
  unsigned long long f = 0ull, rc = 0ull;
  for (int j = 0; j < len; ++j) {
    f = (f << 2) | base_code(p[j]);
    rc |= comp_code(p[j]) << (2 * j);
  }
  *fwd = f;
  return f < rc ? f : rc;
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

// Dynamic shared memory: [NK] forward codes and [NS] s-mer hashes (u64),
// [NK] tiles, [NK] masks, [NK] run starts then positions in run (32-bit),
// then the [L] query bytes.
__global__ void __launch_bounds__(kSeqThreads)
seq_streams_kernel(const uint8_t* __restrict__ seqs, int L, const int32_t* __restrict__ lens,
                   int k, int s, unsigned long long seed, unsigned long long num_tiles, int h,
                   int tile_rows, int R, int U, int32_t* __restrict__ utile,
                   int64_t* __restrict__ gmask, int32_t* __restrict__ n_valid,
                   int32_t* __restrict__ u_count) {
  extern __shared__ unsigned long long s_code[];
  __shared__ int s_warp[32];
  __shared__ int s_appended;
  const int nk = L - k + 1;
  const int w = k - s + 1;
  unsigned long long* s_hash = s_code + nk;
  int32_t* s_tile = reinterpret_cast<int32_t*>(s_hash + (L - s + 1));
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_tile + nk);
  int32_t* s_pos = reinterpret_cast<int32_t*>(s_mask + nk);
  uint8_t* s_seq = reinterpret_cast<uint8_t*>(s_pos + nk);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nv = max(0, min(nk, lens[b] - (k - 1)));  // valid k-mers: a prefix
  int32_t* q_utile = utile + static_cast<size_t>(b) * U;
  int64_t* q_gmask = gmask + static_cast<size_t>(b) * U * R;
  for (int i = tid; i < U; i += blockDim.x) q_utile[i] = 0;
  for (int i = tid; i < U * R; i += blockDim.x) q_gmask[i] = 0;
  const uint8_t* q_seq = seqs + static_cast<size_t>(b) * L;
  for (int i = tid; i < L; i += blockDim.x) s_seq[i] = q_seq[i];
  if (tid == 0) s_appended = 0;
  __syncthreads();

  // the seeded s-mer hashes of every window a valid k-mer spans
  const int nh = nv > 0 ? nv + w - 1 : 0;
  unsigned long long fwd;
  for (int p = tid; p < nh; p += blockDim.x) {
    s_hash[p] = splitmix64(canonical_code(s_seq + p, s, &fwd) ^ seed);
  }
  __syncthreads();

  // per k-mer: forward code, slot mask, minimizer tile
  const unsigned long long slot_bits = static_cast<unsigned long long>(tile_rows - 1);
  for (int i = tid; i < nv; i += blockDim.x) {
    const unsigned long long hv = splitmix64(canonical_code(s_seq + i, k, &fwd));
    unsigned m = 0u;
    for (int j = 0; j < h; ++j) m |= 1u << static_cast<int>((hv >> (6 * j)) & slot_bits);
    unsigned long long mn = s_hash[i];
    for (int j = 1; j < w; ++j) mn = min(mn, s_hash[i + j]);
    s_code[i] = fwd;
    s_mask[i] = m;
    s_tile[i] = static_cast<int32_t>(mn % num_tiles);
  }
  __syncthreads();

  // exact dedup: the first occurrence of a forward code wins
  int appended = 0;
  for (int i = tid; i < nv; i += blockDim.x) {
    const unsigned long long me = s_code[i];
    bool dup = false;
    for (int j = 0; j < i && !dup; ++j) dup = s_code[j] == me;
    if (dup) {
      s_mask[i] = 0u;
    } else {
      ++appended;
    }
  }
  if (appended) atomicAdd(&s_appended, appended);
  __syncthreads();

  // run starts: a max-scan of (i where a run starts, else -1) over the
  // threads' contiguous chunks [c0, c1)
  const int per = (nv + blockDim.x - 1) / blockDim.x;
  const int c0 = min(nv, tid * per);
  const int c1 = min(nv, c0 + per);
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
    u_count[b] = before + opened;
    n_valid[b] = s_appended;
  }
}

}  // namespace

extern "C" {

// words uint32[m, W]; row_idx int32[B, K, h], every id in [0, m);
// mask uint8[B, K]; counts int32[B, W * 32]; exact int32[B, W].
// Launches on `stream` and returns cudaGetLastError().
int classic_counts(const void* words, int W, const void* row_idx,
                   const void* mask, int B, int K, int h, void* counts,
                   void* exact, void* stream) {
  if (B <= 0 || W <= 0 || K < 0 || h <= 0 ||
      static_cast<size_t>(h) * sizeof(int32_t) > kStageBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int kc = static_cast<int>(
      std::max<size_t>(1, std::min<size_t>(K, kStageBytes / (static_cast<size_t>(h) * sizeof(int32_t)))));
  const size_t smem = static_cast<size_t>(kc) * (h * sizeof(int32_t) + 1);
  const dim3 grid(B, (W + 31) / 32);
  classic_counts_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(words), W, static_cast<const int32_t*>(row_idx),
      static_cast<const uint8_t*>(mask), K, h, kc, static_cast<int32_t*>(counts),
      static_cast<int32_t*>(exact));
  return static_cast<int>(cudaGetLastError());
}

// words uint32[m_pad, W] with m_pad a multiple of tile_rows; tile
// int32[B, K], every id in [0, m_pad / tile_rows); smask int64[B, K];
// counts int32[B, W * 32]; exact int32[B, W].  tile_rows in [1, 64].
int tile_counts(const void* words, int W, const void* tile, const void* smask,
                int B, int K, int tile_rows, void* counts, void* exact,
                void* stream) {
  return launch_tile_counts<true>(words, W, tile, smask, B, K, tile_rows, counts, exact,
                                  static_cast<cudaStream_t>(stream));
}

// tile_counts without the exact AND: counts only.
int tile_counts_only(const void* words, int W, const void* tile, const void* smask,
                     int B, int K, int tile_rows, void* counts, void* stream) {
  return launch_tile_counts<false>(words, W, tile, smask, B, K, tile_rows, counts, nullptr,
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
  if (B <= 0 || W <= 0 || U < 0 || R < 0 || tile_rows < 1 || tile_rows > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t per_entry = sizeof(int32_t) + static_cast<size_t>(R) * sizeof(unsigned long long);
  if (per_entry > kStageBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int kc = static_cast<int>(std::max<size_t>(1, std::min<size_t>(U, kStageBytes / per_entry)));
  const size_t smem = static_cast<size_t>(kc) * per_entry +
                      static_cast<size_t>(kWarps) * tile_rows * 32 * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      grouped_tile_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, (W + 31) / 32);
  grouped_tile_counts_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(words), W, static_cast<const int32_t*>(utile),
      static_cast<const int64_t*>(gmask), U, R, tile_rows, kc,
      static_cast<int32_t*>(counts), static_cast<int32_t*>(exact));
  return static_cast<int>(cudaGetLastError());
}

// words uint32[num_tiles * tile_rows, W]; cols [num_tiles, W * 32] of
// elem_bytes 1, 2 or 4 per element.  tile_rows in [1, 8 * elem_bytes].
int pack_tile_cols(const void* words, int W, int64_t num_tiles, int tile_rows,
                   int elem_bytes, void* cols, void* stream) {
  if (W <= 0 || num_tiles <= 0 || tile_rows < 1 || tile_rows > 8 * elem_bytes ||
      (num_tiles + kColsWarps - 1) / kColsWarps > 0x7FFFFFFF) {
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

// cols [T, W * 32] of elem_bytes 1, 2 or 4; utile int32[B, U], every id
// in [0, T); gmask int64[B, U, R]; n_valid int32[B]; counts
// int32[B, W * 32]; exact int32[B, W].
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
// n_valid int32[B]; u_count int32[B].  1 <= s <= k <= 32, L >= k,
// 1 <= h <= 10, tile_rows a power of two up to 32, 1 <= num_tiles < 2^31;
// the shared memory of one query's state must fit the device.
int seq_streams(const void* seqs, int B, int L, const void* lens, int k, int s,
                unsigned long long seed, int64_t num_tiles, int h, int tile_rows, int R, int U,
                void* utile, void* gmask, void* n_valid, void* u_count, void* stream) {
  if (B <= 0 || k < 1 || k > 32 || s < 1 || s > k || L < k || h < 1 || h > 10 ||
      tile_rows < 1 || tile_rows > 32 || (tile_rows & (tile_rows - 1)) || num_tiles < 1 ||
      num_tiles >= (int64_t{1} << 31) || R < 1 || U < 0 ||
      static_cast<int64_t>(U) * R > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t nk = static_cast<size_t>(L - k + 1);
  const size_t smem = (nk + static_cast<size_t>(L - s + 1)) * sizeof(unsigned long long) +
                      nk * 3 * sizeof(int32_t) + static_cast<size_t>(L);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem + 256 > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(seq_streams_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  seq_streams_kernel<<<B, kSeqThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seqs), L, static_cast<const int32_t*>(lens), k, s, seed,
      static_cast<unsigned long long>(num_tiles), h, tile_rows, R, U,
      static_cast<int32_t*>(utile), static_cast<int64_t*>(gmask),
      static_cast<int32_t*>(n_valid), static_cast<int32_t*>(u_count));
  return static_cast<int>(cudaGetLastError());
}

const char* lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
