// Device functions shared by the Lorenzo codec kernels (lorenzo.cu) and
// the entropy-coded wire kernels (entropy.cu): kernel 5's block-wide
// delta and maximum, the single-pass decoupled look-back of the entropy
// kernels and Lorenzo kernels 1-4, the staging of a tile's stream words,
// the 16-byte loads, the pack's exact division and tail zeroing, and the
// reduces that pass a NaN in acc through.
//
// Layout: f32 data is (nb, 256).  In the unfused quantize (kernel 5) one
// CUDA block of 256 threads handles one 256-element Lorenzo block, thread
// j owning element j (lorenzo_zig, block_max); every other kernel takes
// tiles of 32 blocks, four per warp (kernels 6 and 7 on small calls: 8
// blocks, one per warp), lane l of a warp owning elements 4l..4l+3 and
// 128+4l..128+4l+3 of its block.  Wire words are uint32, LSB-first, and
// every block's payload starts on a word boundary.
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

// Word w of a stream of cap words; every word at or past cap reads as 0.
__device__ __forceinline__ uint32_t load_word(const uint32_t* __restrict__ p,
                                              long long cap, long long w) {
  return w < cap ? p[w] : 0u;
}

// ceil(2^21 / bw) for bw in 1..32: (n * kRecip[bw]) >> 21 == n / bw, in 32
// bits, for every n < 256 * bw + 32.  The error n * (kRecip[bw] * bw - 2^21)
// / 2^21 stays below 1 / bw while n * 31 < 2^21, and the product below 2^32.
// A pack kernel divides the first (and last) bit of an output word by the
// width of the codes that fill it; a segment holds at most 256 codes.
constexpr int kRecipShift = 21;
#define LZ_RECIP(d) (((1u << kRecipShift) + (d) - 1) / (d))
__constant__ uint32_t kRecip[33] = {
    0u,          LZ_RECIP(1),  LZ_RECIP(2),  LZ_RECIP(3),  LZ_RECIP(4),  LZ_RECIP(5),
    LZ_RECIP(6), LZ_RECIP(7),  LZ_RECIP(8),  LZ_RECIP(9),  LZ_RECIP(10), LZ_RECIP(11),
    LZ_RECIP(12), LZ_RECIP(13), LZ_RECIP(14), LZ_RECIP(15), LZ_RECIP(16), LZ_RECIP(17),
    LZ_RECIP(18), LZ_RECIP(19), LZ_RECIP(20), LZ_RECIP(21), LZ_RECIP(22), LZ_RECIP(23),
    LZ_RECIP(24), LZ_RECIP(25), LZ_RECIP(26), LZ_RECIP(27), LZ_RECIP(28), LZ_RECIP(29),
    LZ_RECIP(30), LZ_RECIP(31), LZ_RECIP(32)};
#undef LZ_RECIP

// Zero the unused tail [start, cap) of a capacity buffer, 16 bytes a store
// between the 4-word boundaries (the wrappers allocate the buffer, so it
// starts on a 16-byte boundary).  Every thread of a 1-D grid of 256-thread
// blocks calls it.
__device__ __forceinline__ void zero_tail(uint32_t* __restrict__ packed, long long cap,
                                          long long start) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long mid = start < cap ? min((start + 3) & ~3LL, cap) : cap;
  const long long end4 = max(mid, cap & ~3LL);
  if (start + gid < mid) packed[start + gid] = 0u;
  if (end4 + gid < cap) packed[end4 + gid] = 0u;
  for (long long i = mid / 4 + gid; i < end4 / 4; i += stride)
    reinterpret_cast<uint4*>(packed)[i] = make_uint4(0u, 0u, 0u, 0u);
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

// Tiles of the look-back kernels (entropy.cu; kernels 1-4 in lorenzo.cu) and
// of the unfused decode (kernels 6 and 7).
constexpr int kTileThreads = 256;                  // 8 warps
constexpr int kWarpBlocks = 4;                     // Lorenzo blocks per warp and tile
constexpr int kTileBlocks = kWarps * kWarpBlocks;  // 32 blocks per tile
constexpr int kTailBlocks = 1024;                  // grid cap of a tail-zeroing launch

// Four consecutive floats: one 16-byte load, or four 4-byte loads where the
// caller's tensor starts off a 16-byte boundary (a view into a larger one).
__device__ __forceinline__ float4 load4(const float* p) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

// The same for four consecutive uint32 words.
__device__ __forceinline__ uint4 load4(const uint32_t* p) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) return *reinterpret_cast<const uint4*>(p);
  return make_uint4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ uint32_t warp_inclusive_sum(uint32_t v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// Lane i of warp 0 holds block i's word count; writes each block's
// in-tile offset to blkoff_s and returns the tile's total.
__device__ __forceinline__ uint32_t tile_offsets(const int32_t* words_s, int32_t* blkoff_s,
                                                 int lane) {
  const uint32_t w = (uint32_t)words_s[lane];
  const uint32_t incl = warp_inclusive_sum(w, lane);
  blkoff_s[lane] = (int32_t)(incl - w);
  return __shfl_sync(0xffffffffu, incl, 31);
}

// Stage words [lo, end) of a stream into seg_s, where lo is the 16-byte
// boundary at or below the segment's first word ``off``; words outside
// [0, cap) read as 0.  Every thread of the CTA calls it, then syncs.
// Returns lo (seg_s[w - lo] is word w); seg_s needs end - off + 7 words.
__device__ __forceinline__ long long stage_segment(const uint32_t* __restrict__ packed,
                                                   long long cap, long long off,
                                                   long long end, uint32_t* seg_s) {
  const long long mis = (long long)((reinterpret_cast<uintptr_t>(packed) >> 2) & 3);
  const long long lo = ((off + mis) & ~3LL) - mis;
  const int n4 = (int)((end - lo + 3) >> 2);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    const long long w0 = lo + 4LL * i;
    uint4 v;
    if (w0 >= 0 && w0 + 4 <= cap) {
      v = *reinterpret_cast<const uint4*>(packed + w0);
    } else {
      uint32_t t[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) t[k] = w0 + k >= 0 ? load_word(packed, cap, w0 + k) : 0u;
      v = make_uint4(t[0], t[1], t[2], t[3]);
    }
    reinterpret_cast<uint4*>(seg_s)[i] = v;
  }
  return lo;
}

__device__ __forceinline__ uint32_t zigzag(int32_t q, int32_t prev) {
  const int32_t d = (int32_t)((uint32_t)q - (uint32_t)prev);
  return ((uint32_t)d << 1) ^ (uint32_t)(d >> 31);
}

// Zigzag code u -> its int32 delta, as uint32 bits.
__device__ __forceinline__ uint32_t unzigzag(uint32_t u) {
  return (uint32_t)((int32_t)(u >> 1) ^ -(int32_t)(u & 1u));
}

// The reduces.  On a NaN the card's arithmetic returns its canonical NaN;
// the reference kernels on the CPU, and the plain versions, return the NaN
// operand quieted (the decoded value's where both are NaN), and x86's
// default NaN 0xFFC00000 for inf - inf.
constexpr uint32_t kQuietBit = 0x00400000u;

// acc + q * 2eb, rounded once; q * 2eb is finite, so a NaN comes only from acc.
__device__ __forceinline__ float fma_acc(float qf, float twoeb, float a) {
  const float r = __fmaf_rn(qf, twoeb, a);
  return a != a ? __uint_as_float(__float_as_uint(a) | kQuietBit) : r;
}

// acc + v (the lossless reduce, v any bit pattern), rounded once.
__device__ __forceinline__ float add_acc(float a, float v) {
  const float r = __fadd_rn(a, v);
  if (r == r) return r;
  const uint32_t nan = v != v ? __float_as_uint(v) : a != a ? __float_as_uint(a) : 0xFFC00000u;
  return __uint_as_float(nan | kQuietBit);
}

}  // namespace

#define LZ_CHECK()                                   \
  do {                                               \
    const cudaError_t e_ = cudaGetLastError();       \
    if (e_ != cudaSuccess) return (int)e_;           \
  } while (0)
