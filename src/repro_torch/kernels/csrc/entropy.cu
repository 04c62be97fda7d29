// Entropy-coded wire kernels for Hopper (sm_90a), bound through a plain C ABI.
//
// Two entry points for the three entropy TPU kernels
// (src/repro/kernels/entropy.py):
//
//   ent_quantize_pack       <- quantize_pack            (entropy.py:230)
//   ent_unpack_dequantize   <- unpack_dequantize        (entropy.py:263)
//                              and, with acc,
//                              unpack_dequantize_reduce (entropy.py:289)
//
// Wire format: each 256-element Lorenzo block splits into four 64-element
// sub-blocks, and sub k is packed at its own width bw_k into 2 * bw_k
// words (64 elements * bw_k bits), LSB-first, in sub order inside the
// block's segment.  The four 6-bit widths travel as one int32 descriptor
// desc = bw0 | bw1 << 6 | bw2 << 12 | bw3 << 18.  A block's payload is
// 2 * sum_k bw_k <= 256 words, and every sub starts on a word boundary.
//
// With ``lossless`` the quantizer is the bit pattern itself,
// q = __float_as_int(x): the wrapping int32 delta chain reconstructs it
// exactly, decode returns __int_as_float(q) with no float arithmetic (NaN
// payloads survive), and its reduce is one __fadd_rn.  Lossy decode is
// __fmul_rn(q, 2eb), and the reduce __fmaf_rn(q, 2eb, acc), rounded once
// like the reference kernel (acc + q * 2eb contracts to one FMA there).
// Both reduces pass a NaN through as the reference on the CPU does
// (add_acc, fma_acc in lorenzo_common.cuh).
//
// What changed against the TPU design: the Pallas kernels walk a sequential
// grid and carry the running word offset in SMEM.  A GPU grid has no order,
// so each call is one pass over tiles of 32 blocks (256 threads, warp w
// taking blocks w, w + 8, w + 16 and w + 24, so each step of the 8 warps
// covers 8 consecutive blocks; tile indices drawn in start order), and a
// tile finds its word offset with the decoupled look-back of
// lorenzo_common.cuh.  The tile is large because the look-back resolves at
// most 32 predecessors per round trip to L2: with 8-block tiles that rate,
// not the bytes, bounded both kernels on the H100.
//
//   pack (one launch, plus a small one that zeroes [total, cap)): each warp
//     loads a block once (two coalesced 16-byte loads per lane: elements
//     4l..4l+3 and 128+4l..128+4l+3), quantizes, takes the Lorenzo deltas
//     with warp shuffles and the four sub maxima with half-warp shuffles,
//     writes desc and anchor and keeps the zigzag codes in shared memory
//     (32 KB a tile).  Warp 0 scans the blocks' word counts, publishes the
//     tile's and looks back; then lane l of each warp builds words l, l+32,
//     .. of its blocks from shared memory (it finds the word's sub from the
//     in-block sub offsets and ORs in the codes that overlap it, so no
//     atomics) and stores them coalesced at the tile's offset.  The tile
//     that learns the total writes it to ``total``.
//   unpack (one launch): each warp reads its blocks' desc and (reduce)
//     prefetches their acc rows into L2 before the look-back resolves; the
//     tile's contiguous segment is then staged in shared memory with
//     16-byte loads (words at or past cap read as 0), each lane decodes
//     eight elements of a block at their sub's width, a two-part warp scan
//     rebuilds the prefix sum, and f32 goes out in 16-byte stores.
//
// Bound on this card: bytes.  Each element is read and written once as a
// 4-byte word (x or acc in, the stream and f32 out) and does a few dozen
// integer operations, far below the ~300 operations per byte at which an
// H100 stops being memory-bound.  The x and acc loads and the f32 stores
// are 16 bytes a lane; the stream is written 4 bytes a lane, coalesced.
//
// Capacity: words at index >= cap are never stored, even when cap falls
// inside a tile; the tail launch zeroes [total, cap).  On the receive side
// every word at index >= cap reads as 0, as the Pallas kernel's zero-padded
// window does.

#include "lorenzo_common.cuh"

namespace {

constexpr int kSubs = 4;
constexpr int kSub = kBlock / kSubs;        // 64 elements per sub-block
constexpr int kSubWordsPerBit = kSub / 32;  // 2 words per bit of sub width
constexpr int kDescBits = 6;

__device__ __forceinline__ int sub_width(int32_t desc, int k) {
  return (desc >> (kDescBits * k)) & ((1 << kDescBits) - 1);
}

// Words of a block's payload: 2 * sum_k bw_k.
__device__ __forceinline__ int block_words(int32_t desc) {
  return kSubWordsPerBit *
         (sub_width(desc, 0) + sub_width(desc, 1) + sub_width(desc, 2) + sub_width(desc, 3));
}

template <bool kLossless>
__device__ __forceinline__ int32_t quantize_one(float x, float recip) {
  if constexpr (kLossless) return __float_as_int(x);
  else return __float2int_rn(__fmul_rn(x, recip));
}

__device__ __forceinline__ uint32_t half_warp_max(uint32_t v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// First word of sub k inside a block's payload.
__device__ __forceinline__ int sub_start(int32_t desc, int k) {
  int s = 0;
#pragma unroll
  for (int i = 0; i < kSubs - 1; ++i) s += i < k ? kSubWordsPerBit * sub_width(desc, i) : 0;
  return s;
}

// Pack: one tile of 32 blocks per CTA (see the header comment).
template <bool kLossless>
__global__ void __launch_bounds__(kTileThreads)
ent_pack_lookback_kernel(const float* __restrict__ x, const float* __restrict__ recip_p,
                         int nb, uint32_t* __restrict__ packed, long long cap,
                         int32_t* __restrict__ desc_out, int32_t* __restrict__ anchor_out,
                         int32_t* __restrict__ total_out, Lookback lb) {
  __shared__ __align__(16) uint32_t z_s[kTileBlocks * kBlock];
  __shared__ int32_t words_s[kTileBlocks], blkoff_s[kTileBlocks];
  __shared__ uint32_t off_s;
  __shared__ int tile_s;
  const int tiles = (nb + kTileBlocks - 1) / kTileBlocks;
  const int tile = lookback_tile(lb, tiles, &tile_s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float recip = kLossless ? 0.f : *recip_p;
  int32_t desc[kWarpBlocks];
#pragma unroll
  for (int i = 0; i < kWarpBlocks; ++i) {
    const int blk = warp + kWarps * i;  // step i reads 8 consecutive blocks
    const int b = tile * kTileBlocks + blk;
    desc[i] = 0;
    if (b < nb) {  // warp-uniform
      const float* xb = x + (size_t)b * kBlock;
      const float4 lo = load4(xb + 4 * lane), hi = load4(xb + 128 + 4 * lane);
      const int32_t q[8] = {
          quantize_one<kLossless>(lo.x, recip), quantize_one<kLossless>(lo.y, recip),
          quantize_one<kLossless>(lo.z, recip), quantize_one<kLossless>(lo.w, recip),
          quantize_one<kLossless>(hi.x, recip), quantize_one<kLossless>(hi.y, recip),
          quantize_one<kLossless>(hi.z, recip), quantize_one<kLossless>(hi.w, recip)};
      const int32_t up_lo = __shfl_up_sync(0xffffffffu, q[3], 1);
      const int32_t up_hi = __shfl_up_sync(0xffffffffu, q[7], 1);
      const int32_t last_lo = __shfl_sync(0xffffffffu, q[3], 31);  // element 127
      uint32_t zz[8];
      zz[0] = zigzag(q[0], lane ? up_lo : q[0]);  // element 0 has no predecessor
      zz[4] = zigzag(q[4], lane ? up_hi : last_lo);
#pragma unroll
      for (int e = 1; e < 4; ++e) {
        zz[e] = zigzag(q[e], q[e - 1]);
        zz[4 + e] = zigzag(q[4 + e], q[3 + e]);
      }
      // Lanes 0-15 hold sub 0 (low part) and sub 2 (high part), 16-31 subs 1, 3.
      const uint32_t m_lo = half_warp_max(max(max(zz[0], zz[1]), max(zz[2], zz[3])));
      const uint32_t m_hi = half_warp_max(max(max(zz[4], zz[5]), max(zz[6], zz[7])));
      const uint32_t m[kSubs] = {__shfl_sync(0xffffffffu, m_lo, 0),
                                 __shfl_sync(0xffffffffu, m_lo, 16),
                                 __shfl_sync(0xffffffffu, m_hi, 0),
                                 __shfl_sync(0xffffffffu, m_hi, 16)};
#pragma unroll
      for (int k = 0; k < kSubs; ++k) desc[i] |= (32 - __clz((int)m[k])) << (kDescBits * k);
      uint4* z = reinterpret_cast<uint4*>(z_s + blk * kBlock);
      z[lane] = make_uint4(zz[0], zz[1], zz[2], zz[3]);
      z[32 + lane] = make_uint4(zz[4], zz[5], zz[6], zz[7]);
      if (lane == 0) {
        desc_out[b] = desc[i];
        anchor_out[b] = q[0];
      }
    }
    if (lane == 0) words_s[blk] = block_words(desc[i]);
  }
  __syncthreads();
  if (warp == 0) {
    const uint32_t agg = tile_offsets(words_s, blkoff_s, lane);
    const uint32_t excl = lookback_exclusive(lb, tile, agg);
    if (lane == 0) {
      off_s = excl;
      if (tile == tiles - 1) *total_out = (int32_t)(excl + agg);
    }
  }
  __syncthreads();
  // Lane l builds words l, l + 32, .. of each of the warp's blocks from the
  // codes of the sub that holds the word, and stores them at the offset.
#pragma unroll
  for (int i = 0; i < kWarpBlocks; ++i) {
    const int blk = warp + kWarps * i;
    const int32_t d = desc[i];
    const int so1 = kSubWordsPerBit * sub_width(d, 0);
    const int so2 = so1 + kSubWordsPerBit * sub_width(d, 1);
    const int so3 = so2 + kSubWordsPerBit * sub_width(d, 2);
    const int nw = so3 + kSubWordsPerBit * sub_width(d, 3);
    const long long base = (long long)off_s + blkoff_s[blk];
    const uint32_t* zb = z_s + blk * kBlock;
    for (int j = lane; j < nw; j += 32) {
      const int k = (j >= so1) + (j >= so2) + (j >= so3);  // skips empty subs
      const int bw = sub_width(d, k);                         // >= 1: word j lies in sub k
      const int bit0 = 32 * (j - (k == 0 ? 0 : k == 1 ? so1 : k == 2 ? so2 : so3));
      const uint32_t rc = kRecip[bw];                        // bit0 / bw, exactly
      const int e0 = (int)(((uint32_t)bit0 * rc) >> kRecipShift);
      const int e1 = min((int)(((uint32_t)(bit0 + 31) * rc) >> kRecipShift), kSub - 1);
      const uint32_t* zk = zb + k * kSub;
      uint32_t w = 0u;
      for (int e = e0; e <= e1; ++e) {
        const int sh = e * bw - bit0;
        w |= sh >= 0 ? (zk[e] << sh) : (zk[e] >> -sh);
      }
      if (base + j < cap) packed[base + j] = w;
    }
  }
}

// Zero the unused tail [total, cap) of the capacity buffer.
__global__ void __launch_bounds__(kBlock)
ent_zero_tail_kernel(uint32_t* __restrict__ packed, long long cap,
                     const int32_t* __restrict__ total) {
  zero_tail(packed, cap, *total);
}

// Unpack (and reduce): one tile of 32 blocks per CTA (see the header comment).
template <bool kLossless, bool kReduce>
__global__ void __launch_bounds__(kTileThreads)
ent_unpack_lookback_kernel(const uint32_t* __restrict__ packed, long long cap,
                           const int32_t* __restrict__ desc_in,
                           const int32_t* __restrict__ anchor_in, int nb,
                           const float* __restrict__ twoeb_p, const float* __restrict__ acc,
                           float* __restrict__ out, Lookback lb) {
  // the segment, from the 16-byte boundary at or below its first word
  __shared__ __align__(16) uint32_t seg_s[kTileBlocks * kBlock + 8];
  __shared__ int32_t words_s[kTileBlocks], blkoff_s[kTileBlocks];
  __shared__ uint32_t off_s;
  __shared__ int tile_s;
  const int tiles = (nb + kTileBlocks - 1) / kTileBlocks;
  const int tile = lookback_tile(lb, tiles, &tile_s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int32_t desc[kWarpBlocks];
#pragma unroll
  for (int i = 0; i < kWarpBlocks; ++i) {
    const int blk = warp + kWarps * i;
    const int b = tile * kTileBlocks + blk;
    desc[i] = b < nb ? desc_in[b] : 0;
    if (kReduce && b < nb) {  // acc into L2 while the look-back resolves
      const float* ab = acc + (size_t)b * kBlock;
      asm volatile("prefetch.global.L2 [%0];" ::"l"(ab + 4 * lane));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(ab + 128 + 4 * lane));
    }
    if (lane == 0) words_s[blk] = block_words(desc[i]);
  }
  __syncthreads();
  if (warp == 0) {
    const uint32_t agg = tile_offsets(words_s, blkoff_s, lane);
    const uint32_t excl = lookback_exclusive(lb, tile, agg);
    if (lane == 0) off_s = excl;
  }
  __syncthreads();
  const long long off = off_s;
  const long long end = off + blkoff_s[kTileBlocks - 1] + words_s[kTileBlocks - 1];
  const long long lo = stage_segment(packed, cap, off, end, seg_s);
  __syncthreads();
  const float twoeb = kLossless ? 0.f : *twoeb_p;
#pragma unroll
  for (int i = 0; i < kWarpBlocks; ++i) {
    const int blk = warp + kWarps * i;
    const int b = tile * kTileBlocks + blk;
    if (b >= nb) break;  // warp-uniform; later steps are further on
    const int32_t d = desc[i];
    const int first = (int)(off - lo) + blkoff_s[blk];  // the block's first word in seg_s
    // Lane l decodes elements 4l+e (sub l / 16) and 128+4l+e (sub 2 + l / 16).
    uint32_t dd[8];
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const int k = 2 * part + (lane >> 4);
      const int bw = sub_width(d, k);
      const uint32_t mask = width_mask(bw);
      const int bit_base = (first + sub_start(d, k)) * 32 + 4 * (lane & 15) * bw;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int bitpos = bit_base + e * bw;
        const int wi = bitpos >> 5, sh = bitpos & 31;
        uint32_t u = seg_s[wi] >> sh;
        if (sh && sh + bw > 32) u |= seg_s[wi + 1] << (32 - sh);
        u &= mask;
        dd[4 * part + e] = (uint32_t)((int32_t)(u >> 1) ^ -(int32_t)(u & 1u));
      }
    }
    // Int32-wrapping prefix sum over the block: elements 0..127 are the
    // lanes' low parts in lane order, 128..255 their high parts.
    const uint32_t s_lo = dd[0] + dd[1] + dd[2] + dd[3];
    const uint32_t s_hi = dd[4] + dd[5] + dd[6] + dd[7];
    const uint32_t i_lo = warp_inclusive_sum(s_lo, lane);
    const uint32_t i_hi = warp_inclusive_sum(s_hi, lane);
    const uint32_t anchor = (uint32_t)anchor_in[b];
    uint32_t run[2] = {anchor + (i_lo - s_lo),
                       anchor + __shfl_sync(0xffffffffu, i_lo, 31) + (i_hi - s_hi)};
    float* ob = out + (size_t)b * kBlock;
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      float av[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (kReduce) {
        const float4 a = load4(acc + (size_t)b * kBlock + 128 * part + 4 * lane);
        av[0] = a.x, av[1] = a.y, av[2] = a.z, av[3] = a.w;
      }
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        run[part] += dd[4 * part + e];
        const int32_t q = (int32_t)run[part];
        if constexpr (kLossless) {
          v[e] = kReduce ? add_acc(av[e], __int_as_float(q)) : __int_as_float(q);
        } else {
          const float qf = __int2float_rn(q);
          v[e] = kReduce ? fma_acc(qf, twoeb, av[e]) : __fmul_rn(qf, twoeb);
        }
      }
      *reinterpret_cast<float4*>(ob + 128 * part + 4 * lane) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <bool kLossless>
int quantize_pack_impl(const float* x, int nb, const float* recip, uint32_t* packed,
                       long long cap, int32_t* desc, int32_t* anchor, int32_t* total,
                       Lookback lb, cudaStream_t stream) {
  const int tiles = (nb + kTileBlocks - 1) / kTileBlocks;
  ent_pack_lookback_kernel<kLossless><<<tiles, kTileThreads, 0, stream>>>(
      x, recip, nb, packed, cap, desc, anchor, total, lb);
  LZ_CHECK();
  if (cap > 0) {
    const long long want = (cap + kBlock - 1) / kBlock;
    ent_zero_tail_kernel<<<(int)(want < kTailBlocks ? want : kTailBlocks), kBlock, 0,
                           stream>>>(packed, cap, total);
    LZ_CHECK();
  }
  return 0;
}

template <bool kLossless, bool kReduce>
int unpack_impl(const uint32_t* packed, long long cap, const int32_t* desc,
                const int32_t* anchor, int nb, const float* twoeb, const float* acc,
                float* out, Lookback lb, cudaStream_t stream) {
  const int tiles = (nb + kTileBlocks - 1) / kTileBlocks;
  ent_unpack_lookback_kernel<kLossless, kReduce><<<tiles, kTileThreads, 0, stream>>>(
      packed, cap, desc, anchor, nb, twoeb, acc, out, lb);
  LZ_CHECK();
  return 0;
}

}  // namespace

extern "C" {

// ``lb_state`` holds one 64-bit look-back word per tile (ceil(nb / 32)) and
// ``lb_counter`` the tile counter (0 between launches on the stream);
// ``epoch`` tags this call's state words (see lorenzo_common.cuh).
int ent_quantize_pack(const float* x, int nb, const float* recip, int lossless,
                      uint32_t* packed, long long cap, int32_t* desc, int32_t* anchor,
                      int32_t* total, unsigned long long* lb_state, unsigned int* lb_counter,
                      unsigned int epoch, cudaStream_t stream) {
  const Lookback lb{lb_state, lb_counter, epoch};
  return lossless
      ? quantize_pack_impl<true>(x, nb, recip, packed, cap, desc, anchor, total, lb, stream)
      : quantize_pack_impl<false>(x, nb, recip, packed, cap, desc, anchor, total, lb, stream);
}

int ent_unpack_dequantize(const uint32_t* packed, long long cap, const int32_t* desc,
                          const int32_t* anchor, int nb, const float* twoeb, int lossless,
                          const float* acc, float* out, unsigned long long* lb_state,
                          unsigned int* lb_counter, unsigned int epoch,
                          cudaStream_t stream) {
  const Lookback lb{lb_state, lb_counter, epoch};
  if (lossless)
    return acc ? unpack_impl<true, true>(packed, cap, desc, anchor, nb, twoeb, acc, out, lb,
                                         stream)
               : unpack_impl<true, false>(packed, cap, desc, anchor, nb, twoeb, nullptr,
                                          out, lb, stream);
  return acc ? unpack_impl<false, true>(packed, cap, desc, anchor, nb, twoeb, acc, out, lb,
                                        stream)
             : unpack_impl<false, false>(packed, cap, desc, anchor, nb, twoeb, nullptr, out,
                                         lb, stream);
}

}  // extern "C"
