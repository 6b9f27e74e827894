// Lookup kernels of bigsi_tpu_torch for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (bigsi_tpu_torch/ops/_build.py,
// wrappers in bigsi_tpu_torch/ops/fused_lookup.py).
//
// Both kernels read the bitslice matrix as uint32[m, W], row-major: bit
// n % 32 of words[r * W + n / 32] says whether bloom row r is set in
// sample n.  Per query they AND the rows of each valid k-mer, count per
// sample how many k-mers survived (counts int32[B, W * 32], sample order)
// and AND the survivors (exact uint32[B, W]; all ones when no k-mer is
// valid).  Padding k-mers add nothing to either.
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
//
// What bounds them on an H100: gathered bytes, at random rows.  At
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

__device__ __forceinline__ void add_kmer(Acc& acc, unsigned p) {
#pragma unroll
  for (int j = 0; j < 32; ++j) acc.cnt[j] += (p >> j) & 1u;
  acc.exact &= p;
}

// Sums the block's accumulators and writes query b's slice of counts
// (32 counters per word, sample order) and exact for this chunk.
__device__ void write_out(const Acc& acc, int b, int chunk, int W,
                          int32_t* __restrict__ counts,
                          int32_t* __restrict__ exact) {
  __shared__ int s_cnt[32 * kStride];
  __shared__ unsigned s_exact[32];
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 32 * kStride; i += blockDim.x) s_cnt[i] = 0;
  if (threadIdx.x < 32) s_exact[threadIdx.x] = kAllOnes;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 32; ++j) atomicAdd(&s_cnt[lane * kStride + j], acc.cnt[j]);
  atomicAnd(&s_exact[lane], acc.exact);
  __syncthreads();
  const int nw = min(32, W - chunk * 32);
  const size_t word0 = static_cast<size_t>(b) * W + static_cast<size_t>(chunk) * 32;
  int32_t* out = counts + word0 * 32;
  for (int i = threadIdx.x; i < nw * 32; i += blockDim.x) {
    out[i] = s_cnt[(i >> 5) * kStride + (i & 31)];
  }
  if (threadIdx.x < nw) exact[word0 + threadIdx.x] = static_cast<int32_t>(s_exact[threadIdx.x]);
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
        if (ok[u]) add_kmer(acc, p[u]);
      }
    }
  }
  write_out(acc, b, chunk, W, counts, exact);
}

constexpr size_t kStageBytes = 32 * 1024;  // shared memory for staged k-mers

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
  if (B <= 0 || W <= 0 || K < 0 || tile_rows < 1 || tile_rows > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t per_kmer = sizeof(unsigned long long) + sizeof(int32_t);
  const int kc = static_cast<int>(std::max<size_t>(1, std::min<size_t>(K, kStageBytes / per_kmer)));
  const size_t smem = static_cast<size_t>(kc) * per_kmer;
  const dim3 grid(B, (W + 31) / 32);
  tile_counts_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(words), W, static_cast<const int32_t*>(tile),
      static_cast<const int64_t*>(smask), K, tile_rows, kc,
      static_cast<int32_t*>(counts), static_cast<int32_t*>(exact));
  return static_cast<int>(cudaGetLastError());
}

const char* lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
