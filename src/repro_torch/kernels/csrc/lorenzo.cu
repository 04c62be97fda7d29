// Lorenzo codec kernels for Hopper (sm_90a), bound through a plain C ABI.
//
// Six entry points for the seven Lorenzo TPU kernels
// (src/repro/kernels/lorenzo.py):
//
//   lz_quantize_pack          <- quantize_pack            (lorenzo.py:392)
//   lz_unpack_dequantize      <- unpack_dequantize        (lorenzo.py:426)
//                                and, with acc,
//                                unpack_dequantize_reduce (lorenzo.py:456)
//   lz_unpack_reduce_repack   <- unpack_reduce_repack     (lorenzo.py:324)
//   lz_quantize               <- quantize                 (lorenzo.py:110)
//   lz_dequantize             <- dequantize               (lorenzo.py:134)
//                                and, with acc,
//                                dequantize_reduce        (lorenzo.py:491)
//
// The last two are the unfused codec: zigzag codes travel through device
// memory as uint32 (nb, 256) and the bit packing is separate torch code
// (core/bitpack.py).  Each is a single launch: the work is block-local,
// so no scan across blocks is needed.
//
// Layout: f32 data is (nb, 256); one CUDA block of 256 threads handles one
// 256-element Lorenzo block, thread j owning element j.  Wire words are
// uint32, LSB-first, block i's codes at word offset off_i = sum_{k<i} 8*bw_k
// (BLOCK % 32 == 0, so every block starts on a word boundary).
//
// What changed against the TPU design: the Pallas kernels walk a sequential
// grid and carry the running word offset in SMEM.  A GPU grid has no order,
// so each entry point is a short sequence of launches instead:
//   front (quantize -> per-block bw, anchor) -> scan (exclusive prefix sum of
//   8*bw over the blocks, hand-written, one CTA) -> pack (every thread owns
//   one output word and ORs in the codes that overlap it, so no atomics).
// Receive side: scan of the incoming widths -> unpack.  The hop kernel fuses
// unpack + reduce + the quantize front, writes the reduced f32 chunk to
// device memory, and the pack launch reads it back.  Keeping that
// intermediate on chip is later work.
//
// Bound on this card: bytes.  Each element is read and written a few times
// as 4-byte words and does ~20 integer operations, far below the ~300
// operations per byte at which an H100 stops being memory-bound.  The design
// keeps every global access coalesced over the block (thread j touches
// element j; pack threads write consecutive words) and does the in-block
// work (Lorenzo delta, max, prefix sum, bit placement) in registers and
// shared memory.
//
// Exactness (bitwise equal to the JAX kernel path and to the plain torch
// versions): q = __float2int_rn(__fmul_rn(x, recip)) (saturating, NaN -> 0);
// zigzag on int32; bw = 32 - clz(max code); reconstruction is an int32
// wrapping prefix sum plus the anchor, qf = __int2float_rn(q); the reduce is
// __fmaf_rn(qf, twoeb, acc), rounded once.  recip and twoeb arrive as device
// scalars computed by the wrapper, like the reference's (1, 1) operands.
// Compile without --use_fast_math.  The quantizer front, the
// reconstruction and the word-offset scan live in lorenzo_common.cuh,
// shared with the entropy-coded wire kernels (entropy.cu).
//
// Capacity: words at index >= cap are never stored; the pack launch zeroes
// [nwords, cap).  On the receive side every word at index >= cap reads as 0.

#include "lorenzo_common.cuh"

namespace {

constexpr int kWordsPerBit = kBlock / 32;   // words per unit of bitwidth

// Dense layout: block i's payload is 8 * bw_i words.
struct DenseWords {
  const int32_t* bw;
  __device__ __forceinline__ int32_t operator()(int i) const { return bw[i] * kWordsPerBit; }
};

// Thread j's value of Lorenzo block b, decoded from the stream and
// reconstructed to f32 (before the multiply by 2*eb).
__device__ __forceinline__ float decode_q(const uint32_t* __restrict__ packed,
                                          long long cap, int bw, int32_t anchor,
                                          int off, uint32_t* red) {
  const long long bitpos = (long long)off * 32 + (long long)threadIdx.x * bw;
  const long long w = bitpos >> 5;
  const int sh = (int)(bitpos & 31);
  const uint32_t lo = load_word(packed, cap, w) >> sh;
  const uint32_t hi = sh ? (load_word(packed, cap, w + 1) << (32 - sh)) : 0u;
  return reconstruct_q((lo | hi) & width_mask(bw), anchor, red);
}

// Quantize front: per-block bitwidth and anchor of f32 blocks; with
// kCodes also the zigzag codes themselves (the unfused quantize).
template <bool kCodes>
__global__ void __launch_bounds__(kBlock)
quantize_front_kernel(const float* __restrict__ x, const float* __restrict__ recip_p,
                      uint32_t* __restrict__ codes, int32_t* __restrict__ bw_out,
                      int32_t* __restrict__ anchor_out) {
  __shared__ int32_t q_s[kBlock];
  __shared__ uint32_t red[kWarps];
  const size_t i = (size_t)blockIdx.x * kBlock + threadIdx.x;
  const int32_t q = __float2int_rn(__fmul_rn(x[i], *recip_p));
  const uint32_t zig = lorenzo_zig(q, q_s);
  if constexpr (kCodes) codes[i] = zig;
  const uint32_t umax = block_max(zig, red);
  if (threadIdx.x == 0) {
    bw_out[blockIdx.x] = 32 - __clz((int)umax);
    anchor_out[blockIdx.x] = q;
  }
}

// Pack: re-quantize block b from f32, then thread t builds output word t of
// the block's segment from the codes overlapping it.  Also zeroes the
// unused tail [total, cap) of the capacity buffer.
__global__ void __launch_bounds__(kBlock)
pack_kernel(const float* __restrict__ x, const float* __restrict__ recip_p,
            const int32_t* __restrict__ bw_in, const int32_t* __restrict__ offsets,
            int nb, uint32_t* __restrict__ packed, long long cap) {
  __shared__ int32_t q_s[kBlock];
  __shared__ uint32_t z_s[kBlock];
  const int b = blockIdx.x, j = threadIdx.x;
  const int32_t q = __float2int_rn(__fmul_rn(x[(size_t)b * kBlock + j], *recip_p));
  const uint32_t zig = lorenzo_zig(q, q_s);
  const int bw = bw_in[b];
  z_s[j] = zig & width_mask(bw);
  __syncthreads();
  if (j < bw * kWordsPerBit) {
    const int bit0 = 32 * j;
    const int e0 = bit0 / bw;
    const int e1 = min((bit0 + 31) / bw, kBlock - 1);
    uint32_t w = 0;
    for (int e = e0; e <= e1; ++e) {
      const int sh = e * bw - bit0;
      w |= sh >= 0 ? (z_s[e] << sh) : (z_s[e] >> -sh);
    }
    const long long gw = (long long)offsets[b] + j;
    if (gw < cap) packed[gw] = w;
  }
  const long long stride = (long long)nb * kBlock;
  for (long long i = (long long)offsets[nb] + (long long)b * kBlock + j; i < cap; i += stride)
    packed[i] = 0u;
}

template <bool kReduce>
__global__ void __launch_bounds__(kBlock)
unpack_kernel(const uint32_t* __restrict__ packed, long long cap,
              const int32_t* __restrict__ bw_in, const int32_t* __restrict__ anchor_in,
              const int32_t* __restrict__ offsets, const float* __restrict__ twoeb_p,
              const float* __restrict__ acc, float* __restrict__ out) {
  __shared__ uint32_t red[kWarps];
  const int b = blockIdx.x;
  const float qf = decode_q(packed, cap, bw_in[b], anchor_in[b], offsets[b], red);
  const size_t i = (size_t)b * kBlock + threadIdx.x;
  out[i] = kReduce ? __fmaf_rn(qf, *twoeb_p, acc[i]) : __fmul_rn(qf, *twoeb_p);
}

// Unfused decode: codes (nb, 256) + anchor -> f32, optionally + acc with
// one rounding.
template <bool kReduce>
__global__ void __launch_bounds__(kBlock)
dequantize_kernel(const uint32_t* __restrict__ codes, const int32_t* __restrict__ anchor_in,
                  const float* __restrict__ twoeb_p, const float* __restrict__ acc,
                  float* __restrict__ out) {
  __shared__ uint32_t red[kWarps];
  const size_t i = (size_t)blockIdx.x * kBlock + threadIdx.x;
  const float qf = reconstruct_q(codes[i], anchor_in[blockIdx.x], red);
  out[i] = kReduce ? __fmaf_rn(qf, *twoeb_p, acc[i]) : __fmul_rn(qf, *twoeb_p);
}

// Hop front: decode + reduce (written out as f32), then the quantize front
// of the sum at the outgoing bound.
__global__ void __launch_bounds__(kBlock)
hop_front_kernel(const uint32_t* __restrict__ packed, long long cap,
                 const int32_t* __restrict__ bw_in, const int32_t* __restrict__ anchor_in,
                 const int32_t* __restrict__ offsets, const float* __restrict__ twoeb_p,
                 const float* __restrict__ acc, const float* __restrict__ recip_p,
                 float* __restrict__ x_out, int32_t* __restrict__ bw_out,
                 int32_t* __restrict__ anchor_out) {
  __shared__ uint32_t red[kWarps];
  __shared__ int32_t q_s[kBlock];
  const int b = blockIdx.x;
  const float qf = decode_q(packed, cap, bw_in[b], anchor_in[b], offsets[b], red);
  const size_t i = (size_t)b * kBlock + threadIdx.x;
  const float xv = __fmaf_rn(qf, *twoeb_p, acc[i]);
  x_out[i] = xv;
  const int32_t q = __float2int_rn(__fmul_rn(xv, *recip_p));
  __syncthreads();  // red is reused by block_max
  const uint32_t umax = block_max(lorenzo_zig(q, q_s), red);
  if (threadIdx.x == 0) {
    bw_out[b] = 32 - __clz((int)umax);
    anchor_out[b] = q;
  }
}

}  // namespace

extern "C" {

int lz_quantize_pack(const float* x, int nb, const float* recip, uint32_t* packed,
                     long long cap, int32_t* bw, int32_t* anchor, int32_t* offsets,
                     cudaStream_t stream) {
  quantize_front_kernel<false><<<nb, kBlock, 0, stream>>>(x, recip, nullptr, bw, anchor);
  LZ_CHECK();
  word_offsets_kernel<<<1, kScanThreads, 0, stream>>>(DenseWords{bw}, nb, offsets);
  LZ_CHECK();
  pack_kernel<<<nb, kBlock, 0, stream>>>(x, recip, bw, offsets, nb, packed, cap);
  LZ_CHECK();
  return 0;
}

int lz_unpack_dequantize(const uint32_t* packed, long long cap, const int32_t* bw,
                         const int32_t* anchor, int nb, const float* twoeb,
                         const float* acc, float* out, int32_t* offsets,
                         cudaStream_t stream) {
  word_offsets_kernel<<<1, kScanThreads, 0, stream>>>(DenseWords{bw}, nb, offsets);
  LZ_CHECK();
  if (acc)
    unpack_kernel<true><<<nb, kBlock, 0, stream>>>(packed, cap, bw, anchor, offsets,
                                                   twoeb, acc, out);
  else
    unpack_kernel<false><<<nb, kBlock, 0, stream>>>(packed, cap, bw, anchor, offsets,
                                                    twoeb, nullptr, out);
  LZ_CHECK();
  return 0;
}

int lz_unpack_reduce_repack(const uint32_t* packed_in, long long cap_in,
                            const int32_t* bw_in, const int32_t* anchor_in, int nb,
                            const float* twoeb, const float* acc, const float* recip,
                            float* x_out, uint32_t* packed_out, long long cap_out,
                            int32_t* bw_out, int32_t* anchor_out, int32_t* offsets_in,
                            int32_t* offsets_out, cudaStream_t stream) {
  word_offsets_kernel<<<1, kScanThreads, 0, stream>>>(DenseWords{bw_in}, nb, offsets_in);
  LZ_CHECK();
  hop_front_kernel<<<nb, kBlock, 0, stream>>>(packed_in, cap_in, bw_in, anchor_in,
                                              offsets_in, twoeb, acc, recip, x_out,
                                              bw_out, anchor_out);
  LZ_CHECK();
  word_offsets_kernel<<<1, kScanThreads, 0, stream>>>(DenseWords{bw_out}, nb, offsets_out);
  LZ_CHECK();
  pack_kernel<<<nb, kBlock, 0, stream>>>(x_out, recip, bw_out, offsets_out, nb,
                                         packed_out, cap_out);
  LZ_CHECK();
  return 0;
}

int lz_quantize(const float* x, int nb, const float* recip, uint32_t* codes,
                int32_t* bw, int32_t* anchor, cudaStream_t stream) {
  quantize_front_kernel<true><<<nb, kBlock, 0, stream>>>(x, recip, codes, bw, anchor);
  LZ_CHECK();
  return 0;
}

int lz_dequantize(const uint32_t* codes, const int32_t* anchor, int nb,
                  const float* twoeb, const float* acc, float* out,
                  cudaStream_t stream) {
  if (acc)
    dequantize_kernel<true><<<nb, kBlock, 0, stream>>>(codes, anchor, twoeb, acc, out);
  else
    dequantize_kernel<false><<<nb, kBlock, 0, stream>>>(codes, anchor, twoeb, nullptr, out);
  LZ_CHECK();
  return 0;
}

}  // extern "C"
