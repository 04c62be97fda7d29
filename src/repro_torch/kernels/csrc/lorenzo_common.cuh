// Device functions shared by the Lorenzo codec kernels (lorenzo.cu) and
// the entropy-coded wire kernels (entropy.cu): the quantizer front, the
// reconstruction, the one-CTA word-offset scan of the dense kernels and the
// single-pass decoupled look-back of the entropy kernels.
//
// Layout: f32 data is (nb, 256).  In the dense kernels one CUDA block of
// 256 threads handles one 256-element Lorenzo block, thread j owning
// element j; the entropy kernels take tiles of 8 blocks, one per warp.
// Wire words are uint32, LSB-first, and every block's payload starts on a
// word boundary.
//
// Exactness: q = __float2int_rn(__fmul_rn(x, recip)) (saturating, NaN -> 0);
// zigzag on int32; widths are 32 - clz(max code); reconstruction is an int32
// wrapping prefix sum plus the anchor.  Compile without --use_fast_math.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;                 // elements per Lorenzo block
constexpr int kWarps = kBlock / 32;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ uint32_t width_mask(int bw) {
  return bw == 0 ? 0u : (0xFFFFFFFFu >> (32 - bw));
}

// Lorenzo delta + zigzag for thread j's quantized value q.
__device__ __forceinline__ uint32_t lorenzo_zig(int32_t q, int32_t* q_s) {
  const int j = threadIdx.x;
  q_s[j] = q;
  __syncthreads();
  const int32_t prev = j ? q_s[j - 1] : q;
  const int32_t d = (int32_t)((uint32_t)q - (uint32_t)prev);
  return ((uint32_t)d << 1) ^ (uint32_t)(d >> 31);
}

// Maximum over the 256 threads.
__device__ __forceinline__ uint32_t block_max(uint32_t v, uint32_t* red) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = max(r, red[w]);
  return r;
}

// Inclusive prefix sum over the 256 threads, wrapping like int32.
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) red[warp] = v;
  __syncthreads();
  uint32_t off = 0;
  for (int w = 0; w < warp; ++w) off += red[w];
  return v + off;
}

// Word w of a stream of cap words; every word at or past cap reads as 0.
__device__ __forceinline__ uint32_t load_word(const uint32_t* __restrict__ p,
                                              long long cap, long long w) {
  return w < cap ? p[w] : 0u;
}

// Zigzag code u of thread j -> its int32 quantized value: unzigzag,
// int32-wrapping prefix sum over the block, plus the anchor.
__device__ __forceinline__ int32_t reconstruct_qi(uint32_t u, int32_t anchor,
                                                  uint32_t* red) {
  const int32_t d = (int32_t)(u >> 1) ^ -(int32_t)(u & 1u);
  const uint32_t qs = block_scan((uint32_t)d, red);
  return (int32_t)((uint32_t)anchor + qs);
}

// The same as f32 (before the multiply by 2*eb), rounded to nearest.
__device__ __forceinline__ float reconstruct_q(uint32_t u, int32_t anchor,
                                               uint32_t* red) {
  return __int2float_rn(reconstruct_qi(u, anchor, red));
}

// Exclusive prefix sum of the per-block word counts words(i) over nb
// blocks; offsets[nb] = total words.  One CTA: thread t sums a contiguous
// segment, the CTA scans the partials, then each thread writes its
// segment's offsets.  ``Words`` maps a block index to its word count.
template <class Words>
__global__ void __launch_bounds__(kScanThreads)
word_offsets_kernel(Words words, int nb, int32_t* __restrict__ offsets) {
  __shared__ int32_t part[kScanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (nb + kScanThreads - 1) / kScanThreads;
  const int lo = min(t * per, nb), hi = min(lo + per, nb);
  int32_t s = 0;
  for (int i = lo; i < hi; ++i) s += words(i);
  int32_t incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int32_t v = part[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t n = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += n;
    }
    part[lane] = v;  // inclusive over warps
  }
  __syncthreads();
  incl += warp ? part[warp - 1] : 0;
  int32_t run = incl - s;
  for (int i = lo; i < hi; ++i) {
    offsets[i] = run;
    run += words(i);
  }
  if (t == kScanThreads - 1) offsets[nb] = incl;
}

// Single-pass decoupled look-back (Merrill & Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", 2016): the exclusive prefix of a
// per-tile count across the CTAs of one launch, without a second pass.
//
// Each tile publishes one 64-bit state word: this call's epoch (bits 34..63),
// a flag (bits 32..33: 0 invalid, aggregate, inclusive prefix) and a 32-bit
// value, written with st.release and polled with ld.relaxed at GPU scope,
// one fence.acq_rel making each resolved window's reads an acquire.  A
// word carrying another call's epoch reads as invalid, so the state array is
// never cleared between calls: the host hands every call a fresh epoch
// (1 .. 2^30 - 1) and clears the array only when the epoch wraps.  Tile
// indices come from an atomic counter in the order the CTAs start, so every
// predecessor a tile waits on is already running; the CTA that draws the
// last index resets the counter to 0 for the next launch on the stream.
// State and counter belong to the caller's scratch, never to a __device__
// global.
constexpr uint32_t kFlagAggregate = 1u, kFlagInclusive = 2u;

struct Lookback {
  unsigned long long* state;  // one word per tile
  unsigned int* counter;      // tile counter, 0 between launches
  uint32_t epoch;
};

__device__ __forceinline__ unsigned long long lookback_word(uint32_t epoch, uint32_t flag,
                                                            uint32_t value) {
  return ((unsigned long long)epoch << 34) | ((unsigned long long)flag << 32) | value;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// This CTA's tile, drawn in start order.  Every thread calls it (one
// __syncthreads inside); ``tile_s`` is a shared int.
__device__ __forceinline__ int lookback_tile(const Lookback& lb, int tiles, int* tile_s) {
  if (threadIdx.x == 0) {
    const int t = (int)atomicAdd(lb.counter, 1u);
    if (t == tiles - 1) atomicExch(lb.counter, 0u);  // the launch's last draw
    *tile_s = t;
  }
  __syncthreads();
  return *tile_s;
}

// Exclusive prefix of ``agg`` over tiles [0, tile).  One whole warp calls it
// with the same tile and agg: it publishes the aggregate, reads 32
// predecessors at a time (lane i the (i+1)-th nearest) until every one of
// them is valid, sums back to the nearest inclusive prefix (or all 32 and
// steps back), then publishes the tile's inclusive prefix.  A spin that
// never ends (a predecessor that cannot publish) traps instead of hanging.
__device__ __forceinline__ uint32_t lookback_exclusive(const Lookback& lb, int tile,
                                                       uint32_t agg) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) store_release(lb.state, lookback_word(lb.epoch, kFlagInclusive, agg));
    return 0u;
  }
  if (lane == 0) store_release(lb.state + tile, lookback_word(lb.epoch, kFlagAggregate, agg));
  uint32_t excl = 0u;
  unsigned int spins = 0u;
  for (int pred = tile - 1;; pred -= 32) {
    const int i = pred - lane;
    uint32_t flag, value;
    do {
      flag = kFlagInclusive;  // before tile 0: an empty inclusive prefix
      value = 0u;
      if (i >= 0) {
        const unsigned long long w = load_relaxed(lb.state + i);
        flag = (uint32_t)(w >> 34) == lb.epoch ? (uint32_t)(w >> 32) & 3u : 0u;
        value = (uint32_t)w;
      }
      if (++spins == (1u << 22)) __trap();
    } while (__any_sync(0xffffffffu, flag == 0u));
    asm volatile("fence.acq_rel.gpu;" ::: "memory");  // the window's acquire
    const unsigned incl = __ballot_sync(0xffffffffu, flag == kFlagInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    uint32_t s = lane <= stop ? value : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    excl += s;
    if (incl) break;
  }
  if (lane == 0)
    store_release(lb.state + tile, lookback_word(lb.epoch, kFlagInclusive, excl + agg));
  return excl;
}

}  // namespace

#define LZ_CHECK()                                   \
  do {                                               \
    const cudaError_t e_ = cudaGetLastError();       \
    if (e_ != cudaSuccess) return (int)e_;           \
  } while (0)
