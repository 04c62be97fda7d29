// Flash-attention forward in bf16 on Hopper's tensor cores (sm_90a), bound
// through a plain C ABI.
//
// Replaces the Pallas TPU kernel flash_attention_bhsd
// (src/repro/kernels/flash_attn.py:82, pallas_call :102) for bf16 inputs:
// online-softmax attention, causal, causal with a sliding window, or
// non-causal, the output in bf16.  f32 inputs stay on the CUDA-core kernel
// of flash_attn.cu: the tensor cores take f32 only as TF32, whose 10-bit
// mantissa would break the f32 tolerance (2e-5) against the f32 reference.
//
//   fa_forward_tensor_core_bf16  <- flash_attention_bhsd  (flash_attn.py:82)
//
// Layout: q (B, Sq, H, D), k and v (B, Sk, H, D), o (B, Sq, H, D), bf16,
// contiguous, D in {32, 64, 128} (a template parameter).  The reference's
// (BH, S, D) call is the same with H = 1.
//
// Bound on this card: operations.  At the model's shape (B = 2, S = 2048,
// H = 32, D = 128, causal) the work is 68.75 GFLOP against 134 MB of q, k,
// v and o: 0.0695 ms at the bf16 tensor-core peak, 0.040 ms at 3.35 TB/s.
// What the design does about it:
//   * Both products run on wgmma (m64nNk16, bf16 in, f32 accumulate):
//     S = Q.K^T with Q and K read from shared memory (K-major), O += P.V
//     with P from registers and V from shared memory (MN-major).
//   * Warp specialisation: a producer warpgroup (registers lowered with
//     setmaxnreg) whose one thread issues TMA loads, and two consumer
//     warpgroups (registers raised) that own 64 q rows each of a 128-row
//     q tile.  Q is loaded once per tile; 128-key K and V tiles go through
//     a ring of kStages stages with full and empty mbarriers, K and V with
//     separate full barriers, so that Q.K^T starts before V lands.  Tensor
//     maps are 4-D (D, H, S, B) with the 128-byte swizzle (64-byte at
//     D = 32); at D = 128 a 256-byte row is two 64-column swizzle atoms,
//     each its own TMA box.  TMA fills rows past Sk (or Sq) with zeros,
//     which is the reference's padding.
//   * Inside a consumer, tile t's Q.K^T is issued before tile t - 1's P.V,
//     and tile t's softmax runs while that P.V is on the tensor cores.
//   * Persistent CTAs, one per SM, walk the (bh, q tile) items in rounds,
//     every other round backwards; items go head by head, q tiles longest
//     first under causal masking.  The ring runs on across items, so the
//     next item's Q, K and V load under this item's last P.V and epilogue
//     (the Q buffer is freed by its own barrier once the last Q.K^T is
//     done).  On the card this ran faster than one CTA per item left to
//     the hardware's dispatch, in any head order.
//   * The kv tiles that the masks hide from every row of the q tile are
//     skipped (the range rule of flash_attn.cu, at 128 x 128 tiles), and
//     the element masks run only on tiles that cross a mask edge.
//   * The epilogue stores O from registers, two bf16 per store; rows at or
//     beyond Sq are not written.
// Arithmetic, against the reference (q*scale, then f32 dot products):
//   * The products of bf16 values are exact in f32, so the scale is applied
//     to S in f32 after the product; only f32 roundings differ.
//   * exp2 with log2(e) folded into the scale: t = s * (f32(1/sqrt(D)) *
//     log2(e)) in f32, p = ex2.approx.ftz(t - max t).  ex2.approx has a
//     relative error of about 2^-22, and the folded constant and product
//     round once more each (2^-24 relative, times |t| <~ 20 here): about
//     1e-6 relative on p, far inside the bf16 tolerance.  Subnormal p
//     flush to 0.  The mask value is -1e30 * log2(e), the reference's
//     -1e30 in these units, so masked keys and rows that see no key give
//     the reference's values (p = 1 where the running max is still the
//     mask value, corr = 0 at the first real key).
//   * m and l stay in f32, l summed from the f32 p.  P is rounded to bf16
//     (round to nearest even) for P.V: the one new rounding against the
//     plain version, about 2^-9 relative per term, averaging out far
//     inside the bf16 tolerance of 2e-2.
//   * O / max(l, 1e-30) in f32 (a true division), then
//     __float2bfloat16_rn.
// Skipping, the -1e30 garbage of fully masked leading tiles and the
// reference's value for rows that see no key (the sum of v over the
// 128-padded key count, from walking the whole padded range) are argued
// in flash_attn.cu; at 128 x 128 tiles the walk is the reference's own.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;       // q rows per CTA: two consumer warpgroups x 64
constexpr int kBK = 128;       // keys per ring tile: the reference's kv tile
constexpr int kThreads = 384;  // one producer and two consumer warpgroups
constexpr int kConsumers = 256;  // arrivals that free a buffer: every consumer thread
constexpr int kStages = 3;  // 32 KB Q + 3 x 64 KB K/V at D = 128: 224 KB
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegLog2 = -1e30f * kLog2e;  // the reference's -1e30, in log2 units

// Shared-memory geometry per head dim.  A tile of 128 rows is stored as
// D / kAtomCols swizzle atoms, each 128 rows x kRowBytes, as TMA writes
// them; Q, each K stage and each V stage are one such tile.
template <int D>
struct Geo {
  static constexpr int kAtomCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = kAtomCols * 2;  // 128: 128B swizzle; 64: 64B
  static constexpr int kAtoms = D / kAtomCols;
  static constexpr int kAtomBytes = kBK * kRowBytes;
  static constexpr int kTileBytes = kBK * D * 2;
  static constexpr uint64_t kDescLayout = kRowBytes == 128 ? 1 : 2;  // B128 / B64
  static constexpr int kBarOffset = kTileBytes * (1 + 2 * kStages);
  static constexpr size_t kSmem = kBarOffset + 8 * (2 + 3 * kStages) + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Spins until the phase of parity `parity` has completed.  A fresh barrier
// is in phase 0, so a wait on parity 1 passes at once.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode, base offset 0 (every tile
// and atom is 1024-byte aligned).
template <int D>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (Geo<D>::kDescLayout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(64 x 128) (+)= A(64 x 16, smem, K-major) * B(16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D(64 x 32) += A(64 x 16, registers) * B(16 x 32, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D(64 x 64) += A(64 x 16, registers) * B(16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D(64 x 128) += A(64 x 16, registers) * B(16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The kv range [k_first, k_first + n_tiles * kBK) that the q tile at q0 walks:
// the tiles that some row of it can see, or the whole 128-padded range when
// a row of it sees no key (flash_attn.cu's rule, at 128 x 128 tiles).
__device__ __forceinline__ void kv_range(int q0, int sq, int sk, int causal, int window,
                                         int& k_first, int& n_tiles) {
  const int q_last = min(q0 + kBQ, sq) - 1;
  int k_begin = 0, k_end = sk;
  if (causal) {
    k_end = min(sk, q_last + 1);
    if (window > 0) {
      k_begin = max(0, q0 - window + 1);
      if (q_last >= sk - 1 + window) {  // a row with no real key
        k_begin = 0;
        k_end = (sk + kBK - 1) / kBK * kBK;
      }
    }
  }
  k_first = k_begin / kBK * kBK;
  n_tiles = (k_end - k_first + kBK - 1) / kBK;
}

// The work item w: (bh, q tile), head by head, the q tiles of a head
// longest first under causal masking (a head's K and V stay in L2 while
// its q tiles run).
__device__ __forceinline__ void work_item(int w, int n_q, int causal, int& bh, int& q_tile) {
  bh = w / n_q;
  q_tile = causal ? n_q - 1 - w % n_q : w % n_q;
}

// The r-th item of this CTA: rounds of gridDim.x items, every other round
// walked backwards (a snake), so that the long items spread evenly.
__device__ __forceinline__ int item_of(int r) {
  return r * gridDim.x + ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                       int n_items, int heads, int n_q, int sq, int sk, int causal, int window,
                       float scale_log2) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = base + G::kTileBytes;
  const uint32_t sV = sK + kStages * G::kTileBytes;
  const uint32_t bar = base + G::kBarOffset;
  const uint32_t q_full = bar, q_empty = bar + 8;
  auto k_full = [&](int s) { return bar + 8 * (2 + s); };
  auto v_full = [&](int s) { return bar + 8 * (2 + kStages + s); };
  auto kv_empty = [&](int s) { return bar + 8 * (2 + 2 * kStages + s); };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(kv_empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == 0) {
    // Producer: one thread keeps the ring full, running ahead into the
    // CTA's next item; the ring's tile count `it` runs on across items.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int r = 0, w = item_of(0); w < n_items; w = item_of(++r)) {
        int bh, q_tile, k_first, n_tiles;
        work_item(w, n_q, causal, bh, q_tile);
        const int b = bh / heads, h = bh % heads, q0 = q_tile * kBQ;
        kv_range(q0, sq, sk, causal, window, k_first, n_tiles);
        mbar_wait(q_empty, (r & 1) ^ 1);  // the last item's Q.K^T are done
        mbar_expect_tx(q_full, G::kTileBytes);
#pragma unroll
        for (int a = 0; a < G::kAtoms; ++a)
          tma_load(sQ + a * G::kAtomBytes, &tq, q_full, a * G::kAtomCols, h, q0, b);
        for (int t = 0; t < n_tiles; ++t, ++it) {
          const int s = it % kStages, k0 = k_first + t * kBK;
          mbar_wait(kv_empty(s), ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(k_full(s), G::kTileBytes);
#pragma unroll
          for (int a = 0; a < G::kAtoms; ++a)
            tma_load(sK + s * G::kTileBytes + a * G::kAtomBytes, &tk, k_full(s),
                     a * G::kAtomCols, h, k0, b);
          mbar_expect_tx(v_full(s), G::kTileBytes);
#pragma unroll
          for (int a = 0; a < G::kAtoms; ++a)
            tma_load(sV + s * G::kTileBytes + a * G::kAtomBytes, &tv, v_full(s),
                     a * G::kAtomCols, h, k0, b);
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63.  In a wgmma
    // accumulator, thread (warp w, lane l) holds rows 16 w + l / 4 and
    // + 8, and in every 8-column block j the columns 8 j + 2 (l % 4) and
    // + 1: registers 4 j + {0, 1} (row) and 4 j + {2, 3} (row + 8).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int wg = warpgroup - 1;
    const int t128 = threadIdx.x % 128, warp = t128 / 32, lane = t128 % 32;
    const int lrow = 16 * warp + lane / 4;  // local row in the warpgroup's 64
    const int col = 2 * (lane % 4);
    const uint32_t sQ_wg = sQ + 64 * wg * G::kRowBytes;
    int it = 0;
    for (int r = 0, w = item_of(0); w < n_items; w = item_of(++r)) {
      int bh, q_tile, k_first, n_tiles;
      work_item(w, n_q, causal, bh, q_tile);
      const int b = bh / heads, h = bh % heads, q0 = q_tile * kBQ;
      kv_range(q0, sq, sk, causal, window, k_first, n_tiles);
      const int row0 = q0 + 64 * wg + lrow;  // absolute rows row0 and row0 + 8
      const int r_lo = q0 + 64 * wg, r_hi = r_lo + 63;

      // S = Q K^T of ring stage s: D / 16 steps of k16 along the head dim.
      auto issue_s = [&](float (&sc)[64], int s) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int a = kk * 16 / G::kAtomCols, off = (kk * 16 % G::kAtomCols) * 2;
          const uint64_t dq =
              make_desc<D>(sQ_wg + a * G::kAtomBytes + off, 16, 8 * G::kRowBytes);
          const uint64_t dk = make_desc<D>(sK + s * G::kTileBytes + a * G::kAtomBytes + off,
                                           16, 8 * G::kRowBytes);
          wgmma_ss_n128(sc, dq, dk, kk > 0);
        }
        wgmma_commit();
      };
      // O += P V of ring stage s: 8 steps of k16 along the keys.
      auto issue_pv = [&](float (&acc)[D / 2], const uint32_t (&pa)[32], int s) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
          const uint64_t dv = make_desc<D>(sV + s * G::kTileBytes + kk * 16 * G::kRowBytes,
                                           G::kAtomBytes, 8 * G::kRowBytes);
          wgmma_rs(acc, a, dv);
        }
        wgmma_commit();
      };
      // Online softmax of the tile at k0: S into log2 units, the masks (only
      // on tiles that cross an edge), the running max m over the row's 128
      // scores on the 4 lanes of a quad, corr = exp2(m_old - m), P = exp2(t
      // - m) in place of S, l = l corr + sum P.
      float m[2] = {kNegLog2, kNegLog2}, l[2] = {0.f, 0.f}, corr[2] = {1.f, 1.f};
      auto softmax = [&](float (&sc)[64], int k0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
        const bool edge = k0 + kBK > sk ||
                          (causal && (k0 + kBK - 1 > r_lo || (window > 0 && k0 <= r_hi - window)));
        if (edge) {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int qp = row0 + 8 * ((i >> 1) & 1);
            const int kp = k0 + 8 * (i >> 2) + col + (i & 1);
            bool ok = kp < sk;
            if (causal) ok = ok && kp <= qp && (window <= 0 || kp > qp - window);
            if (!ok) sc[i] = kNegLog2;
          }
        }
        float mx[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
          mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
          corr[x] = ex2(m[x] - mx[x]);
          m[x] = mx[x];
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          sc[i] = ex2(sc[i] - mx[(i >> 1) & 1]);
          sum[(i >> 1) & 1] += sc[i];
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) l[x] = l[x] * corr[x] + sum[x];
      };
      // P in bf16 as the A fragments of the 8 k16 steps: registers 2i, 2i + 1
      // of the accumulator are A register i.
      auto pack_p = [&](uint32_t (&pa)[32], const float (&sc)[64]) {
#pragma unroll
        for (int i = 0; i < 32; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
      };
      auto rescale = [&](float (&acc)[D / 2]) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      };
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float sc[64];
      uint32_t pa[32];

      // Tile t's scores are issued before tile t - 1's P.V, and tile t's
      // softmax runs while that P.V is on the tensor cores.
      mbar_wait(q_full, r & 1);
      mbar_wait(k_full(it % kStages), (it / kStages) & 1);
      issue_s(sc, it % kStages);
      wgmma_wait<0>();
      fence_regs(sc);
      if (n_tiles == 1) mbar_arrive(q_empty);
      softmax(sc, k_first);
      pack_p(pa, sc);
      for (int t = 1; t < n_tiles; ++t) {
        const int s = (it + t) % kStages, sp = (it + t - 1) % kStages;
        mbar_wait(k_full(s), ((it + t) / kStages) & 1);
        issue_s(sc, s);
        rescale(acc);
        mbar_wait(v_full(sp), ((it + t - 1) / kStages) & 1);
        issue_pv(acc, pa, sp);
        wgmma_wait<1>();
        fence_regs(sc);
        if (t == n_tiles - 1) mbar_arrive(q_empty);  // this item's last Q.K^T is done
        softmax(sc, k_first + t * kBK);
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(kv_empty(sp));
        pack_p(pa, sc);
      }
      it += n_tiles;
      const int sp = (it - 1) % kStages;
      rescale(acc);
      mbar_wait(v_full(sp), ((it - 1) / kStages) & 1);
      issue_pv(acc, pa, sp);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(kv_empty(sp));

      // Epilogue: O / max(l, 1e-30) in bf16, straight from the registers to
      // rows row0 and row0 + 8 (rows at or beyond Sq are not written).
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
        l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
        l[x] = fmaxf(l[x], 1e-30f);
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int qr = row0 + 8 * x;
        if (qr >= sq) continue;
        __nv_bfloat16* const orow = o + ((static_cast<long long>(b) * sq + qr) * heads + h) * D;
#pragma unroll
        for (int jb = 0; jb < D / 8; ++jb)
          *reinterpret_cast<uint32_t*>(orow + 8 * jb + col) =
              pack_bf16(acc[4 * jb + 2 * x] / l[x], acc[4 * jb + 2 * x + 1] / l[x]);
      }
    }
  }
}

// cuTensorMapEncodeTiled of libcuda, found through the CUDA runtime so that
// the library needs no -lcuda.
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 4-D map (D, H, S, B) over a contiguous (B, S, H, D) bf16 tensor, one
// swizzle atom of columns by `rows` positions per box.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int batch, int seq, int heads, int rows) {
  using G = Geo<D>;
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)seq * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)G::kAtomCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
      elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      G::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int heads, int sq,
           int sk, int causal, int window, float scale_log2, cudaStream_t stream) {
  using G = Geo<D>;
  CUtensorMap mq, mk, mv;
  if (!make_map<D>(&mq, q, batch, sq, heads, kBQ) || !make_map<D>(&mk, k, batch, sk, heads, kBK) ||
      !make_map<D>(&mv, v, batch, sk, heads, kBK))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)G::kSmem);
  if (e != cudaSuccess) return (int)e;
  const int n_q = (sq + kBQ - 1) / kBQ, n_items = batch * heads * n_q;
  int dev = 0, sms = 0;  // one persistent CTA per SM
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  flash_fwd_wgmma_kernel<D><<<min(n_items, sms), kThreads, G::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), n_items, heads, n_q, sq, sk, causal, window,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: device pointers to bf16 (batch, sq|sk, heads, d), contiguous
// and 16-byte aligned; scale_log2 = f32(f32(1 / sqrt(d)) * f32(log2 e)).
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a shape it
// does not take or a tensor map that cuTensorMapEncodeTiled refuses).
int fa_forward_tensor_core_bf16(const void* q, const void* k, const void* v, void* o,
                                int batch, int heads, int sq, int sk, int d, int causal,
                                int window, float scale_log2, cudaStream_t stream) {
  if (sq <= 0 || sk <= 0 || (long long)batch * heads * ((sq + kBQ - 1) / kBQ) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch<32>(q, k, v, o, batch, heads, sq, sk, causal, window, scale_log2, stream);
    case 64: return launch<64>(q, k, v, o, batch, heads, sq, sk, causal, window, scale_log2, stream);
    case 128: return launch<128>(q, k, v, o, batch, heads, sq, sk, causal, window, scale_log2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
