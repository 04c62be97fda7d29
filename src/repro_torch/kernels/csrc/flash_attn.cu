// Flash-attention forward in f32 on the CUDA cores (sm_90a), bound through a
// plain C ABI.
//
// Replaces the Pallas TPU kernel flash_attention_bhsd
// (src/repro/kernels/flash_attn.py:82) for f32 inputs: online-softmax
// attention, causal, causal with a sliding window, or non-causal, f32 math,
// the output in f32.  bf16 inputs go to the tensor-core kernel of
// flash_attn_sm90.cu (wgmma fed by a TMA K/V ring).  f32 stays here: the
// tensor cores take f32 only as TF32, with a 10-bit mantissa, which would
// break the f32 tolerance of 2e-5 against the f32 reference.
//
//   fa_forward_cuda_core_f32  <- flash_attention_bhsd  (flash_attn.py:82, pallas_call :102)
//
// Layout: q (B, Sq, H, D), k and v (B, Sk, H, D), o (B, Sq, H, D), all
// contiguous f32, D in {32, 64, 128} (a template parameter).  The
// reference's (BH, S, D) call is the same with H = 1, so no transposed
// copies are made.
//
// What changed against the TPU design: the Pallas grid is (bh, q tile, kv
// tile) with the kv axis innermost and sequential, the running (max, sum,
// acc) carried across kv grid steps in VMEM scratch.  A GPU grid has no
// order, so here one thread block owns one (bh, 32-row q tile) and walks
// the kv tiles itself in a loop, keeping the running state in registers:
//   * 8 warps x 4 q rows.  For the scores lane l owns keys l and l + 32 of
//     the 64-key tile and reads whole q and k rows from shared memory as
//     float4 (q broadcast, k rows padded to D + 4 floats so the 16-byte
//     reads of a quarter warp hit distinct banks); the row max and sum are
//     warp shuffles.
//   * For P.V the warp's probabilities go through shared memory and lane l
//     owns output columns l, l + 32, ...: the accumulator is spread over the
//     warp's lanes (D / 32 floats per row and lane), not held by one thread.
//   * K and V tiles (64 rows) are staged in shared memory: at D = 128 that
//     is 2 x 33 KB, plus the scaled q tile (16 KB) and the probabilities
//     (8 KB), 90 KB in all: dynamic shared memory, above the 48 KB default
//     (cudaFuncSetAttribute), two blocks per SM.
//
// Bound on this card: operations.  At the model's shape in f32 the work is
// 4*B*H*D*S(S+1)/2 = 68.8 GFLOP against 268 MB of q, k, v and o; the f32
// CUDA cores (67 TFLOP/s) bound it at about 1 ms.  The products are f32
// FMAs; what the kernel does about the bound is to skip every kv tile that
// the causal and window masks hide from all rows of its q tile, which
// halves the causal work.
//
// Semantics kept from the reference, for exactness against it and against
// the plain version (kernels/flash_attn.py::flash_attention_bhsd_plain):
//   * q is scaled by the f32 value of 1/sqrt(D) before the product;
//   * masked logits are -1e30, not -inf, from absolute positions:
//     k < Sk, q < Sq, causal k <= q, window k > q - window;
//   * expf (no --use_fast_math) and the true division acc / max(l, 1e-30).
// Skipping fully masked kv tiles is exact.  A skipped tile after a row's
// first real key would add p = exp(-1e30 - m) = 0 and multiply the state by
// corr = exp(m - m) = 1; a skipped tile before it would add garbage (p = 1
// per masked key while the max is still -1e30) that the first real key's
// corr = exp(-1e30 - m) = 0 wipes out.  A row that sees no real key at all
// (causal with a window and q >= Sk - 1 + window: possible only when
// Sq >= Sk + window) keeps that garbage in the reference: the sum of v over
// the keys divided by the 128-padded key count.  A q tile holding such a
// row therefore walks every tile of the padded key range, masked keys and
// zero v included, and returns the same.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;               // q rows per warp
constexpr int kBQ = kWarps * kRows;    // q rows per block
constexpr int kBK = 64;                // keys per staged tile
constexpr int kThreads = kWarps * 32;
constexpr int kRefBK = 128;            // the reference's kv tile (padding)
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBK * (D + 4) + kBQ * D + kBQ * kBK);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int heads, int sq,
                 int sk, int causal, int window, float scale) {
  constexpr int LD = D + 4;      // padded k/v row, in floats
  constexpr int DPL = D / 32;    // output columns per lane
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // kBK x LD
  float* vs = ks + kBK * LD;                    // kBK x LD
  float* qs = vs + kBK * LD;                    // kBQ x D, scaled
  float* ps = qs + kBQ * D;                     // kBQ x kBK probabilities

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kBQ;
  const long long row = (long long)heads * D;  // elements between positions
  const float* qb = q + ((long long)b * sq * heads + h) * D;
  const float* kb = k + ((long long)b * sk * heads + h) * D;
  const float* vb = v + ((long long)b * sk * heads + h) * D;
  float* ob = o + ((long long)b * sq * heads + h) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, qp = q0 + r;
    qs[i] = qp < sq ? qb[qp * row + d] * scale : 0.f;
  }

  // The kv range this q tile can see (see the note on skipping above).
  const int q_last = min(q0 + kBQ, sq) - 1;
  int k_begin = 0, k_end = sk;
  if (causal) {
    k_end = min(sk, q_last + 1);
    if (window > 0) {
      k_begin = max(0, q0 - window + 1);
      if (q_last >= sk - 1 + window) {  // a row with no real key
        k_begin = 0;
        k_end = (sk + kRefBK - 1) / kRefBK * kRefBK;
      }
    }
  }

  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  const int r0 = warp * kRows;

  for (int k0 = k_begin / kBK * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the q tile is staged; the last tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D, kp = k0 + r;
      ks[r * LD + d] = kp < sk ? kb[kp * row + d] : 0.f;
      vs[r * LD + d] = kp < sk ? vb[kp * row + d] : 0.f;
    }
    __syncthreads();

    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(&ks[lane * LD + d]);
      const float4 kc = *reinterpret_cast<const float4*>(&ks[(lane + 32) * LD + d]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qa = *reinterpret_cast<const float4*>(&qs[(r0 + r) * D + d]);
        s[r][0] = fmaf(qa.x, ka.x, s[r][0]);
        s[r][0] = fmaf(qa.y, ka.y, s[r][0]);
        s[r][0] = fmaf(qa.z, ka.z, s[r][0]);
        s[r][0] = fmaf(qa.w, ka.w, s[r][0]);
        s[r][1] = fmaf(qa.x, kc.x, s[r][1]);
        s[r][1] = fmaf(qa.y, kc.y, s[r][1]);
        s[r][1] = fmaf(qa.z, kc.z, s[r][1]);
        s[r][1] = fmaf(qa.w, kc.w, s[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + r0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + lane + 32 * j;
        bool ok = kp < sk && qp < sq;
        if (causal) {
          ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
        }
        if (!ok) s[r][j] = kNeg;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new), p1 = expf(s[r][1] - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
      ps[(r0 + r) * kBK + lane] = p0;
      ps[(r0 + r) * kBK + lane + 32] = p1;
    }
    __syncwarp();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 p[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        p[r] = *reinterpret_cast<const float4*>(&ps[(r0 + r) * kBK + j]);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int c = lane + 32 * i;
        const float v0 = vs[j * LD + c], v1 = vs[(j + 1) * LD + c];
        const float v2 = vs[(j + 2) * LD + c], v3 = vs[(j + 3) * LD + c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r][i] = fmaf(p[r].x, v0, acc[r][i]);
          acc[r][i] = fmaf(p[r].y, v1, acc[r][i]);
          acc[r][i] = fmaf(p[r].z, v2, acc[r][i]);
          acc[r][i] = fmaf(p[r].w, v3, acc[r][i]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      ob[qp * row + lane + 32 * i] = acc[r][i] / den;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int batch, int heads,
           int sq, int sk, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * heads);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(q, k, v, o, heads, sq, sk, causal,
                                                        window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: device pointers to f32 (batch, sq|sk, heads, d), contiguous;
// scale = f32(1 / sqrt(d)).  Returns the launch's cudaError_t.
int fa_forward_cuda_core_f32(const void* q, const void* k, const void* v, void* o,
                             int batch, int heads, int sq, int sk, int d, int causal,
                             int window, float scale, cudaStream_t stream) {
  if (batch * heads > 65535 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  float* fo = static_cast<float*>(o);
  switch (d) {
    case 32: return launch<32>(fq, fk, fv, fo, batch, heads, sq, sk, causal, window, scale, stream);
    case 64: return launch<64>(fq, fk, fv, fo, batch, heads, sq, sk, causal, window, scale, stream);
    case 128: return launch<128>(fq, fk, fv, fo, batch, heads, sq, sk, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
