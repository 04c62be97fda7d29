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
// so no scan across blocks is needed.  Kernel 5 (quantize) gives one CUDA
// block of 256 threads to one 256-element Lorenzo block, thread j owning
// element j (a delta through shared memory, a block-wide maximum).
// Kernels 6 and 7 (dequantize, dequantize_reduce) are one template,
// dq_tile_kernel, over tiles of 32 blocks as kernels 1-4 take them, with
// no look-back (the codes sit at fixed offsets).  Lane l of warp w owns
// elements 4l..4l+3 and 128+4l..128+4l+3 of blocks w, w + 8, w + 16 and
// w + 24 of its tile.  It issues every 16-byte load of those blocks'
// codes (and of acc, kernel 7) before the first scan: 128 B a lane (256 B
// with acc), 32 KB a CTA in flight.  Then, per block, it un-zigzags, runs
// the two-part warp scan of decode_block (scan_block) in registers and
// stores the f32 in 16-byte pieces: no shared memory, no __syncthreads.
// One 256-thread CTA per block, with 4-byte loads and a shared-memory
// block scan, holds at most 8 CTAs and so 8 KB of code loads in flight on
// an SM, about half of what keeps the H100's HBM busy.  Below kWideRows
// rows a call is too small to fill the card with such tiles, and its four
// scans a warp run one after the other; there a tile is 8 blocks, one a
// warp, so that four times as many CTAs share the work.
//
// Layout: f32 data is (nb, 256).  Wire words are uint32, LSB-first, block
// i's codes at word offset off_i = sum_{k<i} 8*bw_k (BLOCK % 32 == 0, so
// every block starts on a word boundary).
//
// What changed against the TPU design: the Pallas kernels walk a sequential
// grid and carry the running word offset in SMEM.  A GPU grid has no order.
// Kernels 1-4 are one pass each over tiles of 32 blocks (256 threads; warp
// w takes blocks w, w + 8, w + 16 and w + 24; tile indices drawn in start
// order), and a tile finds its first word with the decoupled look-back of
// lorenzo_common.cuh: no scan launch, no offsets array.
//
// The ring hop (kernel 2) runs two look-backs in one launch, plus a small
// launch that zeroes [total, cap).  Each CTA:
//   1. draws its tile; warp 0 reads the tile's 32 incoming widths while
//      the other warps prefetch their blocks' acc rows into L2;
//   2. look-back A (warp 0): publishes 8 * sum(bw_in) of the tile at once
//      and finds the tile's first incoming word;
//   3. stages the tile's incoming segment in shared memory (16-byte loads
//      from the boundary at or below its first word; words at or past
//      cap_in read as 0), decodes each block (lane l: elements 4l..4l+3 and
//      128+4l..128+4l+3, a two-part warp scan for the prefix sum), reduces
//      with acc rounded once, writes the f32 sum only when the caller asks
//      for it, re-quantizes at the outgoing bound, takes the Lorenzo deltas
//      and the block's width with warp shuffles and keeps the zigzag codes
//      in a shared row;
//   4. look-back B (warp 0): publishes 8 * sum(bw_out) of the tile in a
//      second state array (same epoch, same tile index) as soon as every
//      block's width is known and finds its first outgoing word; the tile
//      with the last block writes the stream's total.  Meanwhile every
//      warp packs its blocks in place (warp 0 after its look-back): lanes
//      8g .. 8g + 7 take the warp's block g, lane r packing codes
//      32r .. 32r + 31 LSB-first into words bw*r .. bw*r + bw - 1 (32
//      codes of bw bits are bw whole words: no atomics, no division);
//   5. copies each block's words out, coalesced, those below cap_out.
// The f32 sum never returns to device memory on the ring path.  Deadlock
// freedom: either look-back of tile t waits only on tiles below t, and
// tiles are drawn in start order, so each of those is running or done.
// Tile 0 waits on nothing; a tile whose predecessors finish both
// look-backs finishes its own (look-back B of tile t needs tiles below t
// to have passed look-back A, which never waits on t).  The incoming
// segment and the code rows take 68 KB of dynamic shared memory a CTA
// (three CTAs an SM), opted into once per device.  The pack is by runs and
// overlaps look-back B, not one thread per output word after it: building
// words one by one was the largest part of the kernel on the H100, and it
// sat on the critical path behind the look-back.
//
// Kernel 1 (quantize_pack) is the hop's send half alone: one pass over
// tiles of 32 blocks with one look-back, plus the tail launch.  Each CTA
// loads its blocks' x in the lane layout (16-byte loads), quantizes,
// encodes each block into its shared row (encode_block), publishes
// 8 * sum(bw) of the tile and looks back (warp 0; the tile with the last
// block writes the total) while the warps pack in place
// (pack_run_in_place), then copies the words out below cap.  x is read
// once; the codes never leave shared memory (36 KB a CTA, no opt-in).  The
// same deadlock argument holds: the look-back waits only on tiles below.
//
// Kernels 3 and 4 (unpack_dequantize_reduce, unpack_dequantize) are the
// hop's receive half alone, one template that differs in its last step:
// one launch per call, no tail (the output is dense f32).  Each CTA runs
// the receive front (receive_front: steps 1-3 above up to the staging,
// with the acc prefetch only for kernel 3, the warps reading their blocks'
// widths and anchors while warp 0 looks back), decodes each block with
// decode_block and writes acc + q * 2eb rounded once (fma_acc, kernel 3)
// or q * 2eb (kernel 4), 16-byte loads of acc and stores of f32.  The
// staged segment takes 32,800 B of static shared memory (no opt-in).  The
// same deadlock argument holds: the look-back waits only on tiles below,
// which were drawn earlier.
//
// Bound on this card: bytes.  Each element is read and written a few times
// as 4-byte words and does ~20-60 integer operations, far below the ~300
// operations per byte at which an H100 stops being memory-bound.  The design
// keeps every global access coalesced (16-byte loads of acc and stores of
// the f32 sum, consecutive stream words a warp), reads each stream word
// once per tile into shared memory, and does the in-block work (Lorenzo
// delta, max, prefix sum, bit placement) in registers and shared memory.
//
// Exactness (bitwise equal to the JAX kernel path and to the plain torch
// versions): q = __float2int_rn(__fmul_rn(x, recip)) (saturating, NaN -> 0);
// zigzag on int32; bw = 32 - clz(max code); reconstruction is an int32
// wrapping prefix sum plus the anchor, qf = __int2float_rn(q); the reduce is
// __fmaf_rn(qf, twoeb, acc), rounded once, passing a NaN in acc through as
// the reference does (fma_acc).  recip and twoeb arrive as device
// scalars computed by the wrapper, like the reference's (1, 1) operands.
// Compile without --use_fast_math.  Kernel 5's delta and maximum, the
// look-back, the staging, the 16-byte loads and the reduces live in
// lorenzo_common.cuh, shared with the entropy-coded wire kernels
// (entropy.cu).
//
// Capacity: words at index >= cap are never stored; kernel 1's and the
// hop's tail launches zero [nwords, cap).  On the receive side every
// word at index >= cap reads as 0.

#include "lorenzo_common.cuh"

namespace {

constexpr int kWordsPerBit = kBlock / 32;   // words per unit of bitwidth
// Rows from which kernels 6 and 7 give a warp kWarpBlocks blocks: four
// 32-block tiles for each of the H100's 132 SMs.
constexpr int kWideRows = 4 * 132 * kTileBlocks;

// The unfused quantize: the zigzag codes, per-block bitwidth and anchor of
// f32 blocks.
__global__ void __launch_bounds__(kBlock)
quantize_front_kernel(const float* __restrict__ x, const float* __restrict__ recip_p,
                      uint32_t* __restrict__ codes, int32_t* __restrict__ bw_out,
                      int32_t* __restrict__ anchor_out) {
  __shared__ int32_t q_s[kBlock];
  __shared__ uint32_t red[kWarps];
  const size_t i = (size_t)blockIdx.x * kBlock + threadIdx.x;
  const int32_t q = __float2int_rn(__fmul_rn(x[i], *recip_p));
  const uint32_t zig = lorenzo_zig(q, q_s);
  codes[i] = zig;
  const uint32_t umax = block_max(zig, red);
  if (threadIdx.x == 0) {
    bw_out[blockIdx.x] = 32 - __clz((int)umax);
    anchor_out[blockIdx.x] = q;
  }
}

constexpr int kSegWords = kTileBlocks * kBlock + 8;  // a tile's staged incoming segment
constexpr int kRun = 32;                             // codes a lane packs: bw whole words
constexpr int kZRow = kBlock + 4 * (kBlock / kRun);  // a block's codes, 4 words of skew a run
constexpr int kHopSmem = (kSegWords + kTileBlocks * kZRow) * 4;  // + the codes: 69,664 B

// Code e of a block in its shared row: runs of 32 codes 36 words apart, so
// that the eight lanes reading one 16-byte piece of eight runs hit 32
// different banks.
__device__ __forceinline__ int zrow(int e) { return e + 4 * (e / kRun); }

// Lane l's eight int32 values of a block (elements 4l+e and 128+4l+e,
// e < 4; before the multiply by 2*eb) from its eight un-zigzagged deltas
// dd: the int32-wrapping prefix sum over the block as a two-part warp scan
// (elements 0..127 are the lanes' low parts in lane order, 128..255 their
// high parts), plus the anchor.  The whole warp calls it.
__device__ __forceinline__ void scan_block(const uint32_t dd[8], uint32_t anchor, int lane,
                                           int32_t q[8]) {
  const uint32_t s_lo = dd[0] + dd[1] + dd[2] + dd[3];
  const uint32_t s_hi = dd[4] + dd[5] + dd[6] + dd[7];
  const uint32_t i_lo = warp_inclusive_sum(s_lo, lane);
  const uint32_t i_hi = warp_inclusive_sum(s_hi, lane);
  uint32_t run[2] = {anchor + (i_lo - s_lo),
                     anchor + __shfl_sync(0xffffffffu, i_lo, 31) + (i_hi - s_hi)};
#pragma unroll
  for (int e = 0; e < 8; ++e) q[e] = (int32_t)(run[e >> 2] += dd[e]);
}

// Receive: lane l's eight int32 values of a dense block (the layout of
// scan_block), decoded at width bw from the staged segment, whose word
// ``first`` is the block's first: unzigzag, then scan_block.
__device__ __forceinline__ void decode_block(const uint32_t* seg_s, int first, int bw,
                                             uint32_t anchor, int lane, int32_t q[8]) {
  const uint32_t mask = width_mask(bw);
  const int bit_base = first * 32 + 4 * lane * bw;
  uint32_t dd[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int bitpos = bit_base + ((e >> 2) * 128 + (e & 3)) * bw;
    const int wi = bitpos >> 5, sh = bitpos & 31;
    uint32_t u = seg_s[wi] >> sh;
    if (sh && sh + bw > 32) u |= seg_s[wi + 1] << (32 - sh);
    dd[e] = unzigzag(u & mask);
  }
  scan_block(dd, anchor, lane, q);
}

// Kernels 7 (kReduce: acc + q * 2eb, rounded once) and 6 (q * 2eb): one
// tile of 8 * wb blocks per CTA, warp w taking blocks w, w + 8, ..,
// w + 8 (wb - 1), wb <= kWarpBlocks (see the header comment).  ``codes``
// and ``acc`` may start off a 16-byte boundary (load4); ``out`` does not.
template <bool kReduce>
__global__ void __launch_bounds__(kTileThreads)
dq_tile_kernel(const uint32_t* __restrict__ codes, const int32_t* __restrict__ anchor_in,
               int nb, int wb, const float* __restrict__ twoeb_p,
               const float* __restrict__ acc, float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = blockIdx.x * kWarps * wb + warp;
  const float twoeb = *twoeb_p;
  uint4 c[kWarpBlocks][2];
  float4 a[kWarpBlocks][2];
  uint32_t anc[kWarpBlocks];
#pragma unroll
  for (int i = 0; i < kWarpBlocks; ++i) {  // every load before the first scan
    const int b = first + kWarps * i;
    if (i == wb || b >= nb) break;  // warp-uniform; later steps are further on
    const size_t i0 = (size_t)b * kBlock + 4 * lane;
    c[i][0] = load4(codes + i0);
    c[i][1] = load4(codes + i0 + 128);
    anc[i] = (uint32_t)anchor_in[b];
    if constexpr (kReduce) {
      a[i][0] = load4(acc + i0);
      a[i][1] = load4(acc + i0 + 128);
    }
  }
#pragma unroll
  for (int i = 0; i < kWarpBlocks; ++i) {
    const int b = first + kWarps * i;
    if (i == wb || b >= nb) break;
    const uint32_t u[8] = {c[i][0].x, c[i][0].y, c[i][0].z, c[i][0].w,
                           c[i][1].x, c[i][1].y, c[i][1].z, c[i][1].w};
    uint32_t dd[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) dd[e] = unzigzag(u[e]);
    int32_t q[8];
    scan_block(dd, anc[i], lane, q);
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      float v[4];
      if constexpr (kReduce) {
        const float av[4] = {a[i][part].x, a[i][part].y, a[i][part].z, a[i][part].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = fma_acc(__int2float_rn(q[4 * part + e]), twoeb, av[e]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = __fmul_rn(__int2float_rn(q[4 * part + e]), twoeb);
      }
      *reinterpret_cast<float4*>(out + (size_t)b * kBlock + 128 * part + 4 * lane) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Receive front of one tile of 32 incoming blocks (kernels 3 and 4; the
// hop runs the same steps inline).  Warp 0, lane i, reads block i's
// width, writes each block's in-tile word offset to inoff_s, publishes the
// tile's 8 * sum(bw) at once and looks back for its first word; meanwhile
// every warp reads its blocks' widths and anchors (bwi, anc: blocks
// warp + 8 i) and, with kPrefetch, fetches their acc rows into L2.  Then
// the CTA stages the tile's words in seg_s.  Every thread calls it (two
// __syncthreads inside); span_s is two shared words.  Returns ``first``:
// block blk's first word is seg_s[first + inoff_s[blk]].
template <bool kPrefetch>
__device__ __forceinline__ int receive_front(const uint32_t* __restrict__ packed,
                                             long long cap, const int32_t* __restrict__ bw_in,
                                             const int32_t* __restrict__ anchor_in, int nb,
                                             const float* __restrict__ acc, const Lookback& lb,
                                             int tile, int32_t* inoff_s, uint32_t* span_s,
                                             uint32_t* seg_s, int bwi[kWarpBlocks],
                                             int32_t anc[kWarpBlocks]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {  // the look-back at once: lane i reads block i's width
    const int b = tile * kTileBlocks + lane;
    const uint32_t w = b < nb ? (uint32_t)(bw_in[b] * kWordsPerBit) : 0u;
    const uint32_t incl = warp_inclusive_sum(w, lane);
    inoff_s[lane] = (int32_t)(incl - w);
    const uint32_t agg = __shfl_sync(0xffffffffu, incl, 31);
    const uint32_t excl = lookback_exclusive(lb, tile, agg);
    if (lane == 0) {
      span_s[0] = excl;
      span_s[1] = agg;
    }
  }
#pragma unroll
  for (int i = 0; i < kWarpBlocks; ++i) {
    const int b = tile * kTileBlocks + warp + kWarps * i;  // step i: 8 consecutive blocks
    bwi[i] = b < nb ? bw_in[b] : 0;
    anc[i] = b < nb ? anchor_in[b] : 0;
    if (kPrefetch && b < nb) {  // acc into L2 while the look-back resolves
      const float* ab = acc + (size_t)b * kBlock;
      asm volatile("prefetch.global.L2 [%0];" ::"l"(ab + 4 * lane));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(ab + 128 + 4 * lane));
    }
  }
  __syncthreads();
  const long long off = span_s[0];
  const long long lo = stage_segment(packed, cap, off, off + span_s[1], seg_s);
  __syncthreads();
  return (int)(off - lo);
}

// Kernels 3 (kReduce: acc + q * 2eb, rounded once) and 4 (q * 2eb): one
// tile of 32 blocks per CTA (see the header comment).
template <bool kReduce>
__global__ void __launch_bounds__(kTileThreads)
ud_lookback_kernel(const uint32_t* __restrict__ packed, long long cap,
                   const int32_t* __restrict__ bw_in, const int32_t* __restrict__ anchor_in,
                   int nb, const float* __restrict__ twoeb_p, const float* __restrict__ acc,
                   float* __restrict__ out, Lookback lb) {
  __shared__ __align__(16) uint32_t seg_s[kSegWords];  // the tile's words, staged
  __shared__ int32_t inoff_s[kTileBlocks];
  __shared__ uint32_t span_s[2];
  __shared__ int tile_s;
  const int tiles = (nb + kTileBlocks - 1) / kTileBlocks;
  const int tile = lookback_tile(lb, tiles, &tile_s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int bwi[kWarpBlocks];
  int32_t anc[kWarpBlocks];
  const int first = receive_front<kReduce>(packed, cap, bw_in, anchor_in, nb, acc, lb, tile,
                                           inoff_s, span_s, seg_s, bwi, anc);
  const float twoeb = *twoeb_p;
#pragma unroll
  for (int i = 0; i < kWarpBlocks; ++i) {
    const int blk = warp + kWarps * i;
    const int b = tile * kTileBlocks + blk;
    if (b >= nb) break;  // warp-uniform; later steps are further on
    int32_t q[8];
    decode_block(seg_s, first + inoff_s[blk], bwi[i], (uint32_t)anc[i], lane, q);
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const size_t i0 = (size_t)b * kBlock + 128 * part + 4 * lane;
      float v[4];
      if constexpr (kReduce) {
        const float4 a = load4(acc + i0);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = fma_acc(__int2float_rn(q[4 * part + e]), twoeb, av[e]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = __fmul_rn(__int2float_rn(q[4 * part + e]), twoeb);
      }
      *reinterpret_cast<float4*>(out + i0) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Send: the zigzag Lorenzo codes of lane l's eight quantized values (the
// layout of decode_block) into zb, the block's row of codes in shared
// memory (``zrow``);
// returns the block's width 32 - clz(max code).  The previous element
// comes from the same lane or by a shuffle; element 0 has none, element
// 128's is lane 31's element 127.
__device__ __forceinline__ int encode_block(const int32_t q[8], uint32_t* zb, int lane) {
  const int32_t up_lo = __shfl_up_sync(0xffffffffu, q[3], 1);
  const int32_t up_hi = __shfl_up_sync(0xffffffffu, q[7], 1);
  const int32_t last_lo = __shfl_sync(0xffffffffu, q[3], 31);
  uint32_t zz[8];
  zz[0] = zigzag(q[0], lane ? up_lo : q[0]);
  zz[4] = zigzag(q[4], lane ? up_hi : last_lo);
#pragma unroll
  for (int e = 1; e < 4; ++e) {
    zz[e] = zigzag(q[e], q[e - 1]);
    zz[4 + e] = zigzag(q[4 + e], q[3 + e]);
  }
  uint32_t m = max(max(max(zz[0], zz[1]), max(zz[2], zz[3])),
                   max(max(zz[4], zz[5]), max(zz[6], zz[7])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  *reinterpret_cast<uint4*>(zb + zrow(4 * lane)) = make_uint4(zz[0], zz[1], zz[2], zz[3]);
  *reinterpret_cast<uint4*>(zb + zrow(128 + 4 * lane)) =
      make_uint4(zz[4], zz[5], zz[6], zz[7]);
  return 32 - __clz((int)m);
}

// Send: a block's 8 * bw stream words, built in place.  Lane r of the
// eight that share the block packs its codes 32 r .. 32 r + 31, LSB-first,
// into words bw r .. bw r + bw - 1: 32 codes of bw bits fill bw whole words,
// so the lanes need no atomics and no division.  Every lane of the warp
// reads its codes before any writes (the warp's four blocks are its own);
// then zb[0, 8 * bw) is the block's segment.
__device__ __forceinline__ void pack_run_in_place(uint32_t* zb, int bw, int r) {
  uint32_t c[kRun];
#pragma unroll
  for (int k = 0; k < kRun; k += 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(zb + zrow(kRun * r + k));
    c[k] = v.x, c[k + 1] = v.y, c[k + 2] = v.z, c[k + 3] = v.w;
  }
  __syncwarp();
  uint32_t* out = zb + bw * r;
  uint32_t cur = 0u;
  int used = 0;  // bits of cur taken, 0..31
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    cur |= c[k] << used;
    if (used + bw >= 32) {  // the word is full: store it, keep the code's high bits
      *out++ = cur;
      cur = __funnelshift_l(c[k], 0u, used);  // c >> (32 - used), 0 when used == 0
    }
    used = (used + bw) & 31;
  }
}

// The ring hop: one tile of 32 blocks per CTA (see the header comment).
// ``x_out`` is written only with kEmit.
template <bool kEmit>
__global__ void __launch_bounds__(kTileThreads)
hop_lookback_kernel(const uint32_t* __restrict__ packed_in, long long cap_in,
                    const int32_t* __restrict__ bw_in, const int32_t* __restrict__ anchor_in,
                    int nb, const float* __restrict__ twoeb_p, const float* __restrict__ acc,
                    const float* __restrict__ recip_p, float* __restrict__ x_out,
                    uint32_t* __restrict__ packed_out, long long cap_out,
                    int32_t* __restrict__ bw_out, int32_t* __restrict__ anchor_out,
                    int32_t* __restrict__ total_out, Lookback lb_in, Lookback lb_out) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* const seg_s = smem;            // the incoming segment, staged
  uint32_t* const z_s = smem + kSegWords;  // block blk's codes, then its words, at row blk
  __shared__ int32_t inoff_s[kTileBlocks], wout_s[kTileBlocks], outoff_s[kTileBlocks];
  __shared__ uint32_t off_in_s, words_in_s, off_out_s;
  __shared__ int tile_s;
  const int tiles = (nb + kTileBlocks - 1) / kTileBlocks;
  const int tile = lookback_tile(lb_in, tiles, &tile_s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {  // look-back A at once: lane i reads block i's width
    const int b = tile * kTileBlocks + lane;
    const uint32_t w = b < nb ? (uint32_t)(bw_in[b] * kWordsPerBit) : 0u;
    const uint32_t incl = warp_inclusive_sum(w, lane);
    inoff_s[lane] = (int32_t)(incl - w);
    const uint32_t agg = __shfl_sync(0xffffffffu, incl, 31);
    const uint32_t excl = lookback_exclusive(lb_in, tile, agg);
    if (lane == 0) {
      off_in_s = excl;
      words_in_s = agg;
    }
  }
  int bwi[kWarpBlocks];
#pragma unroll
  for (int i = 0; i < kWarpBlocks; ++i) {
    const int blk = warp + kWarps * i;  // step i covers 8 consecutive blocks
    const int b = tile * kTileBlocks + blk;
    bwi[i] = b < nb ? bw_in[b] : 0;
    if (b < nb) {  // acc into L2 while look-back A resolves
      const float* ab = acc + (size_t)b * kBlock;
      asm volatile("prefetch.global.L2 [%0];" ::"l"(ab + 4 * lane));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(ab + 128 + 4 * lane));
    }
  }
  __syncthreads();
  const long long off = off_in_s;
  const long long end = off + words_in_s;
  const long long lo = stage_segment(packed_in, cap_in, off, end, seg_s);
  __syncthreads();
  const float twoeb = *twoeb_p, recip = *recip_p;
  int bwo[kWarpBlocks];
#pragma unroll
  for (int i = 0; i < kWarpBlocks; ++i) {
    const int blk = warp + kWarps * i;
    const int b = tile * kTileBlocks + blk;
    bwo[i] = 0;
    if (b < nb) {  // warp-uniform
      int32_t q[8];
      decode_block(seg_s, (int)(off - lo) + inoff_s[blk], bwi[i], (uint32_t)anchor_in[b],
                   lane, q);
      // Reduce, rounded once, and quantize the sum at the outgoing bound.
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        const size_t i0 = (size_t)b * kBlock + 128 * part + 4 * lane;
        const float4 a = load4(acc + i0);
        const float av[4] = {a.x, a.y, a.z, a.w};
        float xv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xv[e] = fma_acc(__int2float_rn(q[4 * part + e]), twoeb, av[e]);
          q[4 * part + e] = __float2int_rn(__fmul_rn(xv[e], recip));
        }
        if constexpr (kEmit)
          *reinterpret_cast<float4*>(x_out + i0) = make_float4(xv[0], xv[1], xv[2], xv[3]);
      }
      bwo[i] = encode_block(q, z_s + blk * kZRow, lane);
      if (lane == 0) {
        bw_out[b] = bwo[i];
        anchor_out[b] = q[0];
      }
    }
    if (lane == 0) wout_s[blk] = bwo[i] * kWordsPerBit;
  }
  __syncthreads();
  if (warp == 0) {  // look-back B: the tile's first outgoing word
    const uint32_t agg = tile_offsets(wout_s, outoff_s, lane);
    const uint32_t excl = lookback_exclusive(lb_out, tile, agg);
    if (lane == 0) {
      off_out_s = excl;
      if (tile == tiles - 1) *total_out = (int32_t)(excl + agg);
    }
  }
  {  // pack while look-back B resolves: lanes 8g .. 8g + 7 take the warp's block g
    const int g = lane >> 3;
    const int bw = g == 0 ? bwo[0] : g == 1 ? bwo[1] : g == 2 ? bwo[2] : bwo[3];
    pack_run_in_place(z_s + (warp + kWarps * g) * kZRow, bw, lane & 7);
  }
  __syncthreads();
  // Copy each block's segment out, the words below cap_out.
#pragma unroll
  for (int i = 0; i < kWarpBlocks; ++i) {
    const int blk = warp + kWarps * i;
    const long long base = (long long)off_out_s + outoff_s[blk];
    const uint32_t* zb = z_s + blk * kZRow;
    for (int j = lane; j < bwo[i] * kWordsPerBit; j += 32)
      if (base + j < cap_out) packed_out[base + j] = zb[j];
  }
}

// Zero the unused tail [total, cap) of the hop's outgoing capacity buffer.
__global__ void __launch_bounds__(kBlock)
hop_zero_tail_kernel(uint32_t* __restrict__ packed, long long cap,
                     const int32_t* __restrict__ total) {
  zero_tail(packed, cap, *total);
}

// Above 48 KB a kernel's dynamic shared memory needs an opt-in, once per
// kernel and device (racing callers set the same value).
template <bool kEmit>
int hop_opt_in() {
  static unsigned long long done = 0ull;  // bit d: device d opted in
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (__atomic_load_n(&done, __ATOMIC_ACQUIRE) & bit) return 0;
  e = cudaFuncSetAttribute(hop_lookback_kernel<kEmit>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kHopSmem);
  if (e != cudaSuccess) return (int)e;
  __atomic_fetch_or(&done, bit, __ATOMIC_RELEASE);
  return 0;
}

template <bool kEmit>
int hop_impl(const uint32_t* packed_in, long long cap_in, const int32_t* bw_in,
             const int32_t* anchor_in, int nb, const float* twoeb, const float* acc,
             const float* recip, float* x_out, uint32_t* packed_out, long long cap_out,
             int32_t* bw_out, int32_t* anchor_out, int32_t* total, Lookback lb_in,
             Lookback lb_out, cudaStream_t stream) {
  const int err = hop_opt_in<kEmit>();
  if (err) return err;
  const int tiles = (nb + kTileBlocks - 1) / kTileBlocks;
  hop_lookback_kernel<kEmit><<<tiles, kTileThreads, kHopSmem, stream>>>(
      packed_in, cap_in, bw_in, anchor_in, nb, twoeb, acc, recip, x_out, packed_out,
      cap_out, bw_out, anchor_out, total, lb_in, lb_out);
  LZ_CHECK();
  if (cap_out > 0) {
    const long long want = (cap_out + kBlock - 1) / kBlock;
    hop_zero_tail_kernel<<<(int)(want < kTailBlocks ? want : kTailBlocks), kBlock, 0,
                           stream>>>(packed_out, cap_out, total);
    LZ_CHECK();
  }
  return 0;
}

// Kernel 1: one tile of 32 blocks per CTA (see the header comment).
__global__ void __launch_bounds__(kTileThreads)
qp_lookback_kernel(const float* __restrict__ x, const float* __restrict__ recip_p, int nb,
                   uint32_t* __restrict__ packed, long long cap, int32_t* __restrict__ bw_out,
                   int32_t* __restrict__ anchor_out, int32_t* __restrict__ total_out,
                   Lookback lb) {
  __shared__ __align__(16) uint32_t z_s[kTileBlocks * kZRow];  // block blk's codes, then words
  __shared__ int32_t words_s[kTileBlocks], blkoff_s[kTileBlocks];
  __shared__ uint32_t off_s;
  __shared__ int tile_s;
  const int tiles = (nb + kTileBlocks - 1) / kTileBlocks;
  const int tile = lookback_tile(lb, tiles, &tile_s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float recip = *recip_p;
  int bw[kWarpBlocks];
#pragma unroll
  for (int i = 0; i < kWarpBlocks; ++i) {
    const int blk = warp + kWarps * i;  // step i covers 8 consecutive blocks
    const int b = tile * kTileBlocks + blk;
    bw[i] = 0;
    if (b < nb) {  // warp-uniform
      const float* xb = x + (size_t)b * kBlock;
      const float4 lo = load4(xb + 4 * lane), hi = load4(xb + 128 + 4 * lane);
      const float xv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      int32_t q[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) q[e] = __float2int_rn(__fmul_rn(xv[e], recip));
      bw[i] = encode_block(q, z_s + blk * kZRow, lane);
      if (lane == 0) {
        bw_out[b] = bw[i];
        anchor_out[b] = q[0];
      }
    }
    if (lane == 0) words_s[blk] = bw[i] * kWordsPerBit;
  }
  __syncthreads();
  if (warp == 0) {  // the tile's first word
    const uint32_t agg = tile_offsets(words_s, blkoff_s, lane);
    const uint32_t excl = lookback_exclusive(lb, tile, agg);
    if (lane == 0) {
      off_s = excl;
      if (tile == tiles - 1) *total_out = (int32_t)(excl + agg);
    }
  }
  {  // pack while the look-back resolves: lanes 8g .. 8g + 7 take the warp's block g
    const int g = lane >> 3;
    const int w = g == 0 ? bw[0] : g == 1 ? bw[1] : g == 2 ? bw[2] : bw[3];
    pack_run_in_place(z_s + (warp + kWarps * g) * kZRow, w, lane & 7);
  }
  __syncthreads();
  // Copy each block's segment out, the words below cap.
#pragma unroll
  for (int i = 0; i < kWarpBlocks; ++i) {
    const int blk = warp + kWarps * i;
    const long long base = (long long)off_s + blkoff_s[blk];
    const uint32_t* zb = z_s + blk * kZRow;
    for (int j = lane; j < bw[i] * kWordsPerBit; j += 32)
      if (base + j < cap) packed[base + j] = zb[j];
  }
}

// Zero the unused tail [total, cap) of kernel 1's capacity buffer.
__global__ void __launch_bounds__(kBlock)
qp_zero_tail_kernel(uint32_t* __restrict__ packed, long long cap,
                    const int32_t* __restrict__ total) {
  zero_tail(packed, cap, *total);
}

}  // namespace

extern "C" {

// Kernel 1.  ``lb_state`` holds ceil(nb / 32) 64-bit look-back words,
// ``lb_counter`` the tile counter (0 between launches on the stream);
// ``epoch`` tags this call's state words (see lorenzo_common.cuh).
// ``total`` receives the stream's true length in words.  nb > 0.
int lz_quantize_pack(const float* x, int nb, const float* recip, uint32_t* packed,
                     long long cap, int32_t* bw, int32_t* anchor, int32_t* total,
                     unsigned long long* lb_state, unsigned int* lb_counter,
                     unsigned int epoch, cudaStream_t stream) {
  const int tiles = (nb + kTileBlocks - 1) / kTileBlocks;
  qp_lookback_kernel<<<tiles, kTileThreads, 0, stream>>>(
      x, recip, nb, packed, cap, bw, anchor, total, Lookback{lb_state, lb_counter, epoch});
  LZ_CHECK();
  if (cap > 0) {
    const long long want = (cap + kBlock - 1) / kBlock;
    qp_zero_tail_kernel<<<(int)(want < kTailBlocks ? want : kTailBlocks), kBlock, 0,
                          stream>>>(packed, cap, total);
    LZ_CHECK();
  }
  return 0;
}

// Kernels 3 and 4 (kernel 3 with acc), one launch.  ``lb_state`` holds
// ceil(nb / 32) 64-bit look-back words, ``lb_counter`` the tile counter (0
// between launches on the stream); ``epoch`` tags this call's state words
// (see lorenzo_common.cuh).  ``out`` starts on a 16-byte boundary.  nb > 0.
int lz_unpack_dequantize(const uint32_t* packed, long long cap, const int32_t* bw,
                         const int32_t* anchor, int nb, const float* twoeb,
                         const float* acc, float* out, unsigned long long* lb_state,
                         unsigned int* lb_counter, unsigned int epoch,
                         cudaStream_t stream) {
  const int tiles = (nb + kTileBlocks - 1) / kTileBlocks;
  const Lookback lb{lb_state, lb_counter, epoch};
  if (acc)
    ud_lookback_kernel<true><<<tiles, kTileThreads, 0, stream>>>(packed, cap, bw, anchor, nb,
                                                                 twoeb, acc, out, lb);
  else
    ud_lookback_kernel<false><<<tiles, kTileThreads, 0, stream>>>(packed, cap, bw, anchor, nb,
                                                                  twoeb, nullptr, out, lb);
  LZ_CHECK();
  return 0;
}

// The ring hop.  ``x_out`` may be null (no f32 sum out).  ``lb_state``
// holds 2 * ceil(nb / 32) 64-bit look-back words (incoming, then
// outgoing), ``lb_counter`` the tile counter (0 between launches on the
// stream); ``epoch`` tags this call's state words (see lorenzo_common.cuh).
// ``total`` receives the outgoing stream's true length in words.  nb > 0.
int lz_unpack_reduce_repack(const uint32_t* packed_in, long long cap_in,
                            const int32_t* bw_in, const int32_t* anchor_in, int nb,
                            const float* twoeb, const float* acc, const float* recip,
                            float* x_out, uint32_t* packed_out, long long cap_out,
                            int32_t* bw_out, int32_t* anchor_out, int32_t* total,
                            unsigned long long* lb_state, unsigned int* lb_counter,
                            unsigned int epoch, cudaStream_t stream) {
  const int tiles = (nb + kTileBlocks - 1) / kTileBlocks;
  const Lookback lb_in{lb_state, lb_counter, epoch};
  const Lookback lb_out{lb_state + tiles, lb_counter, epoch};
  return x_out
      ? hop_impl<true>(packed_in, cap_in, bw_in, anchor_in, nb, twoeb, acc, recip, x_out,
                       packed_out, cap_out, bw_out, anchor_out, total, lb_in, lb_out, stream)
      : hop_impl<false>(packed_in, cap_in, bw_in, anchor_in, nb, twoeb, acc, recip, nullptr,
                        packed_out, cap_out, bw_out, anchor_out, total, lb_in, lb_out,
                        stream);
}

int lz_quantize(const float* x, int nb, const float* recip, uint32_t* codes,
                int32_t* bw, int32_t* anchor, cudaStream_t stream) {
  quantize_front_kernel<<<nb, kBlock, 0, stream>>>(x, recip, codes, bw, anchor);
  LZ_CHECK();
  return 0;
}

// Kernels 6 and 7 (kernel 7 with acc), one launch.  ``out`` starts on a
// 16-byte boundary.  nb > 0.
int lz_dequantize(const uint32_t* codes, const int32_t* anchor, int nb,
                  const float* twoeb, const float* acc, float* out,
                  cudaStream_t stream) {
  const int wb = nb >= kWideRows ? kWarpBlocks : 1;  // blocks a warp
  const int tiles = (nb + kWarps * wb - 1) / (kWarps * wb);
  if (acc)
    dq_tile_kernel<true><<<tiles, kTileThreads, 0, stream>>>(codes, anchor, nb, wb, twoeb,
                                                             acc, out);
  else
    dq_tile_kernel<false><<<tiles, kTileThreads, 0, stream>>>(codes, anchor, nb, wb, twoeb,
                                                              nullptr, out);
  LZ_CHECK();
  return 0;
}

}  // extern "C"
