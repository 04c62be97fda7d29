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
//
// What changed against the TPU design: the Pallas kernels walk a sequential
// grid and carry the running word offset in SMEM.  A GPU grid has no order,
// so each entry point is the same short sequence of launches as the dense
// kernels in lorenzo.cu:
//   front (quantize -> four sub maxima -> desc, anchor) -> scan (exclusive
//   prefix sum of the per-block word counts 2 * sum_k bw_k, one CTA) ->
//   pack (thread t owns output word t of its block's segment: it finds its
//   sub from the in-block sub offsets and ORs in the codes that overlap the
//   word, so no atomics).
// Receive side: scan of the word counts from desc -> decode (thread j reads
// sub j / 64 at its width, then the block prefix-sum reconstruction).
// The quantizer, the reconstruction and the scan are lorenzo_common.cuh's,
// shared with the dense kernels.
//
// Bound on this card: bytes.  Each element is read and written a few times
// as 4-byte words and does a few dozen integer operations, far below the
// ~300 operations per byte at which an H100 stops being memory-bound.
// Accesses are coalesced over the block (thread j touches element j; pack
// threads write consecutive words); the in-block work stays in registers
// and shared memory.
//
// Capacity: words at index >= cap are never stored; the pack launch zeroes
// [nwords, cap).  On the receive side every word at index >= cap reads as 0,
// as the Pallas kernel's zero-padded window does.

#include "lorenzo_common.cuh"

namespace {

constexpr int kSubs = 4;
constexpr int kSub = kBlock / kSubs;        // 64 elements per sub-block
constexpr int kSubWordsPerBit = kSub / 32;  // 2 words per bit of sub width
constexpr int kDescBits = 6;

__device__ __forceinline__ int sub_width(int32_t desc, int k) {
  return (desc >> (kDescBits * k)) & ((1 << kDescBits) - 1);
}

// Entropy layout: block i's payload is 2 * sum_k bw_k words.
struct EntropyWords {
  const int32_t* desc;
  __device__ __forceinline__ int32_t operator()(int i) const {
    const int32_t d = desc[i];
    return kSubWordsPerBit *
           (sub_width(d, 0) + sub_width(d, 1) + sub_width(d, 2) + sub_width(d, 3));
  }
};

template <bool kLossless>
__device__ __forceinline__ int32_t quantize_one(float x, const float* __restrict__ recip_p) {
  if constexpr (kLossless) return __float_as_int(x);
  else return __float2int_rn(__fmul_rn(x, *recip_p));
}

// Front: per-block descriptor (four sub widths) and anchor.
template <bool kLossless>
__global__ void __launch_bounds__(kBlock)
ent_front_kernel(const float* __restrict__ x, const float* __restrict__ recip_p,
                 int32_t* __restrict__ desc_out, int32_t* __restrict__ anchor_out) {
  __shared__ int32_t q_s[kBlock];
  __shared__ uint32_t red[kWarps];
  const size_t i = (size_t)blockIdx.x * kBlock + threadIdx.x;
  const int32_t q = quantize_one<kLossless>(x[i], recip_p);
  uint32_t v = lorenzo_zig(q, q_s);
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t desc = 0;
#pragma unroll
    for (int k = 0; k < kSubs; ++k) {  // sub k is warps 2k and 2k + 1
      const uint32_t m = max(red[2 * k], red[2 * k + 1]);
      desc |= (32 - __clz((int)m)) << (kDescBits * k);
    }
    desc_out[blockIdx.x] = desc;
    anchor_out[blockIdx.x] = q;
  }
}

// Pack: re-quantize block b from f32, then thread t builds output word t of
// the block's segment from the codes of its sub that overlap it.  Also
// zeroes the unused tail [total, cap) of the capacity buffer.
template <bool kLossless>
__global__ void __launch_bounds__(kBlock)
ent_pack_kernel(const float* __restrict__ x, const float* __restrict__ recip_p,
                const int32_t* __restrict__ desc_in, const int32_t* __restrict__ offsets,
                int nb, uint32_t* __restrict__ packed, long long cap) {
  __shared__ int32_t q_s[kBlock];
  __shared__ uint32_t z_s[kBlock];
  const int b = blockIdx.x, j = threadIdx.x;
  const int32_t q = quantize_one<kLossless>(x[(size_t)b * kBlock + j], recip_p);
  const uint32_t zig = lorenzo_zig(q, q_s);
  const int32_t desc = desc_in[b];
  z_s[j] = zig & width_mask(sub_width(desc, j / kSub));
  __syncthreads();
  int so[kSubs + 1];  // in-block word offset of each sub
  so[0] = 0;
#pragma unroll
  for (int k = 0; k < kSubs; ++k) so[k + 1] = so[k] + kSubWordsPerBit * sub_width(desc, k);
  if (j < so[kSubs]) {
    int k = 0;
    while (k < kSubs - 1 && j >= so[k + 1]) ++k;  // skips empty subs
    const int bw = sub_width(desc, k);           // >= 1: word j lies in sub k
    const int bit0 = 32 * (j - so[k]);
    const int e0 = bit0 / bw;
    const int e1 = min((bit0 + 31) / bw, kSub - 1);
    const uint32_t* z = z_s + k * kSub;
    uint32_t w = 0;
    for (int e = e0; e <= e1; ++e) {
      const int sh = e * bw - bit0;
      w |= sh >= 0 ? (z[e] << sh) : (z[e] >> -sh);
    }
    const long long gw = (long long)offsets[b] + j;
    if (gw < cap) packed[gw] = w;
  }
  const long long stride = (long long)nb * kBlock;
  for (long long i = (long long)offsets[nb] + (long long)b * kBlock + j; i < cap; i += stride)
    packed[i] = 0u;
}

// Decode block b (thread j reads element j % 64 of sub j / 64 at that sub's
// width), reconstruct, and write f32 (optionally + acc).
template <bool kLossless, bool kReduce>
__global__ void __launch_bounds__(kBlock)
ent_unpack_kernel(const uint32_t* __restrict__ packed, long long cap,
                  const int32_t* __restrict__ desc_in, const int32_t* __restrict__ anchor_in,
                  const int32_t* __restrict__ offsets, const float* __restrict__ twoeb_p,
                  const float* __restrict__ acc, float* __restrict__ out) {
  __shared__ uint32_t red[kWarps];
  const int b = blockIdx.x, j = threadIdx.x;
  const int32_t desc = desc_in[b];
  const int k = j / kSub;
  int sub_off = 0;
  for (int s = 0; s < k; ++s) sub_off += kSubWordsPerBit * sub_width(desc, s);
  const int bw = sub_width(desc, k);
  const long long bitpos = ((long long)offsets[b] + sub_off) * 32 + (long long)(j % kSub) * bw;
  const long long w = bitpos >> 5;
  const int sh = (int)(bitpos & 31);
  const uint32_t lo = load_word(packed, cap, w) >> sh;
  const uint32_t hi = sh ? (load_word(packed, cap, w + 1) << (32 - sh)) : 0u;
  const int32_t q = reconstruct_qi((lo | hi) & width_mask(bw), anchor_in[b], red);
  const size_t i = (size_t)b * kBlock + j;
  if constexpr (kLossless) {
    const float v = __int_as_float(q);
    out[i] = kReduce ? __fadd_rn(acc[i], v) : v;
  } else {
    const float qf = __int2float_rn(q);
    out[i] = kReduce ? __fmaf_rn(qf, *twoeb_p, acc[i]) : __fmul_rn(qf, *twoeb_p);
  }
}

template <bool kLossless>
int quantize_pack_impl(const float* x, int nb, const float* recip, uint32_t* packed,
                       long long cap, int32_t* desc, int32_t* anchor, int32_t* offsets,
                       cudaStream_t stream) {
  ent_front_kernel<kLossless><<<nb, kBlock, 0, stream>>>(x, recip, desc, anchor);
  LZ_CHECK();
  word_offsets_kernel<<<1, kScanThreads, 0, stream>>>(EntropyWords{desc}, nb, offsets);
  LZ_CHECK();
  ent_pack_kernel<kLossless><<<nb, kBlock, 0, stream>>>(x, recip, desc, offsets, nb,
                                                        packed, cap);
  LZ_CHECK();
  return 0;
}

template <bool kLossless, bool kReduce>
int unpack_impl(const uint32_t* packed, long long cap, const int32_t* desc,
                const int32_t* anchor, int nb, const float* twoeb, const float* acc,
                float* out, int32_t* offsets, cudaStream_t stream) {
  word_offsets_kernel<<<1, kScanThreads, 0, stream>>>(EntropyWords{desc}, nb, offsets);
  LZ_CHECK();
  ent_unpack_kernel<kLossless, kReduce><<<nb, kBlock, 0, stream>>>(
      packed, cap, desc, anchor, offsets, twoeb, acc, out);
  LZ_CHECK();
  return 0;
}

}  // namespace

extern "C" {

int ent_quantize_pack(const float* x, int nb, const float* recip, int lossless,
                      uint32_t* packed, long long cap, int32_t* desc, int32_t* anchor,
                      int32_t* offsets, cudaStream_t stream) {
  return lossless
      ? quantize_pack_impl<true>(x, nb, recip, packed, cap, desc, anchor, offsets, stream)
      : quantize_pack_impl<false>(x, nb, recip, packed, cap, desc, anchor, offsets, stream);
}

int ent_unpack_dequantize(const uint32_t* packed, long long cap, const int32_t* desc,
                          const int32_t* anchor, int nb, const float* twoeb, int lossless,
                          const float* acc, float* out, int32_t* offsets,
                          cudaStream_t stream) {
  if (lossless)
    return acc ? unpack_impl<true, true>(packed, cap, desc, anchor, nb, twoeb, acc, out,
                                         offsets, stream)
               : unpack_impl<true, false>(packed, cap, desc, anchor, nb, twoeb, nullptr,
                                          out, offsets, stream);
  return acc ? unpack_impl<false, true>(packed, cap, desc, anchor, nb, twoeb, acc, out,
                                        offsets, stream)
             : unpack_impl<false, false>(packed, cap, desc, anchor, nb, twoeb, nullptr,
                                         out, offsets, stream);
}

}  // extern "C"
