// Flash-attention forward for Hopper (sm_90a), bound through a plain C ABI.
//
// Replaces the Pallas TPU kernel flash_attention_bhsd
// (src/repro/kernels/flash_attn.py:82): online-softmax attention, causal,
// causal with a sliding window, or non-causal, f32 math, the output in the
// input's dtype.
//
//   fa_forward  <- flash_attention_bhsd  (flash_attn.py:82, pallas_call :102)
//
// Layout: q (B, Sq, H, D), k and v (B, Sk, H, D), o (B, Sq, H, D), all
// contiguous, f32 or bf16 (one type for all four), D in {32, 64, 128} (a
// template parameter).  The reference's (BH, S, D) call is the same with
// H = 1, so no transposed copies are made.
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
//   * K and V tiles (64 rows) are staged in shared memory as f32: at D = 128
//     that is 2 x 33 KB, plus the scaled q tile (16 KB) and the
//     probabilities (8 KB), 90 KB in all: dynamic shared memory, above the
//     48 KB default (cudaFuncSetAttribute), two blocks per SM.
//
// Bound on this card: operations.  At the model's shape (B = 2, S = 2048,
// H = 32, D = 128, causal) the work is 4*B*H*D*S(S+1)/2 = 68.8 GFLOP
// against 134 MB of q, k, v and o, some 500 operations per byte.  This
// first kernel runs its products on the f32 CUDA cores (FMA, no tensor
// cores) and so cannot reach the bf16 tensor-core bound; mma/wgmma, TMA and
// a pipelined K/V ring are the later redesign.  What it does about the
// bound now: it skips every kv tile that the causal and window masks hide
// from all rows of its q tile, which halves the causal work.
//
// Semantics kept from the reference, for exactness against it and against
// the plain version (kernels/flash_attn.py::flash_attention_bhsd_plain):
//   * q is scaled by the f32 value of 1/sqrt(D) before the product;
//   * masked logits are -1e30, not -inf, from absolute positions:
//     k < Sk, q < Sq, causal k <= q, window k > q - window;
//   * expf (no --use_fast_math), the true division acc / max(l, 1e-30),
//     and the cast to bf16 rounds to nearest even (__float2bfloat16_rn).
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

#include <cuda_bf16.h>
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int heads, int sq,
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
  const T* qb = q + ((long long)b * sq * heads + h) * D;
  const T* kb = k + ((long long)b * sk * heads + h) * D;
  const T* vb = v + ((long long)b * sk * heads + h) * D;
  T* ob = o + ((long long)b * sq * heads + h) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, qp = q0 + r;
    qs[i] = qp < sq ? to_f32(qb[qp * row + d]) * scale : 0.f;
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
      ks[r * LD + d] = kp < sk ? to_f32(kb[kp * row + d]) : 0.f;
      vs[r * LD + d] = kp < sk ? to_f32(vb[kp * row + d]) : 0.f;
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
      ob[qp * row + lane + 32 * i] = from_f32<T>(acc[r][i] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int heads,
           int sq, int sk, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * heads);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), heads, sq, sk, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int batch,
               int heads, int sq, int sk, int d, int causal, int window, float scale,
               cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, batch, heads, sq, sk, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, batch, heads, sq, sk, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, batch, heads, sq, sk, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, o: device pointers, (batch, sq|sk, heads, d) contiguous; is_bf16
// selects bf16 (else f32); scale = f32(1 / sqrt(d)).  Returns the launch's
// cudaError_t.
int fa_forward(const void* q, const void* k, const void* v, void* o, int batch,
               int heads, int sq, int sk, int d, int is_bf16, int causal, int window,
               float scale, cudaStream_t stream) {
  if (batch * heads > 65535 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, batch, heads, sq, sk, d, causal, window,
                                     scale, stream);
  return dispatch_d<float>(q, k, v, o, batch, heads, sq, sk, d, causal, window, scale,
                           stream);
}

}  // extern "C"
