// Hopper pieces of the bf16 fused-attention kernels at head_dim 32 and 64
// (qkv_attention.cu, B1/B2, qkv_attention_bwd.cu, B3, and attn_probe.cu,
// the probes P1/P2 on B1's body at head_dim 64): 3-D TMA loads of
// one head's 64-row tiles straight out of the packed (B, N, 3C) projection
// output, the matching wgmma matrix descriptors, and wgmma m64n64k16 (both
// operands from shared memory) and m64nDk16 (A from registers).  The
// mbarriers, named barriers and the tensor-map encoder come from
// hopper_tma_wgmma.cuh.  sm_90a only.
//
// A staged tile is 64 rows of one head's D values, bf16, rows of 2 D bytes,
// written by TMA under the swizzle whose span is one row: 128-byte rows and
// CU_TENSOR_MAP_SWIZZLE_128B at D = 64, 64-byte rows and
// CU_TENSOR_MAP_SWIZZLE_64B at D = 32 (16-byte chunk c of row r lands at
// chunk c ^ (r % 8), or c ^ ((r / 2) % 4)).  Tiles start on 1024-byte
// boundaries, so the descriptors' base-offset field stays 0.  One such tile
// is both canonical wgmma layouts:
//   K-major (the reduction runs along the row, over D: q and k in
//     s = q.k^T, dO and v in dp = dO.v^T): 8-row groups SBO = 8 x 2D bytes
//     apart, LBO unused; k-step kk starts 32 kk bytes into the row;
//   MN-major (the reduction runs over the rows, the output columns are the
//     D values: v in p.v, k in dlog.k, dO and q in the cols kernel): the D
//     values of a row are one swizzle span, 8-row groups SBO apart; k-step
//     kk starts 16 kk rows (32 kk x D bytes) in; imm-trans-b = 1.
// The layout type (descriptor bits 62-63) is 1 for the 128-byte swizzle
// and 2 for the 64-byte one.
//
// Accumulator fragments (PTX ISA, wgmma .m64nNk16, warp w of the warpgroup
// holds rows 16 w .. 16 w + 15, lane = 4 g + t): d[4j], d[4j+1] = (row g,
// columns 8j + 2t, + 1), d[4j+2], d[4j+3] = (row g + 8, the same columns).
// A register fragment of a k16 step kk is mma.m16n8k16's A: (g, 16kk + 2t),
// (g + 8, 16kk + 2t), (g, 16kk + 8 + 2t), (g + 8, 16kk + 8 + 2t), two bf16
// per register, so the f32 accumulator blocks 2kk and 2kk + 1, rounded and
// packed, are the A operand of the next product (to_a below).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_tma_wgmma.cuh"

namespace wgmma {

constexpr int kRows = 64;  // rows of a staged tile and of a warpgroup
constexpr int kConsumers = 128;  // one consumer warpgroup
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kStages = 2;  // the ring of streamed tiles

// Whether (dtype: 0 = float32, 1 = bfloat16; head_dim) runs the wgmma
// bodies, the ones that pass the row log-sum-exp L and the output from the
// forward to the backward.  The one statement of that rule: both entry
// points check their arguments by it, and tpat_qkv_attention_reads_lse
// exports it to the wrapper.
inline bool takes(int dtype, int head_dim) {
  return dtype == 1 && (head_dim == 32 || head_dim == 64);
}

template <int D>
struct Tile {
  static_assert(D == 32 || D == 64, "the wgmma bodies take head_dim 32 or 64");
  static constexpr uint32_t kRowBytes = 2 * D;
  static constexpr uint32_t kBytes = kRows * kRowBytes;  // 4 or 8 KB
  static constexpr uint32_t kSbo = 8 * kRowBytes;        // one swizzle atom
  static constexpr uint64_t kLayout = D == 64 ? 1 : 2;   // 128B or 64B
};

// ---- TMA -------------------------------------------------------------------

// The box of `map` at (c0 along the contiguous axis, c1, c2) into `dst`; its
// bytes (zeros outside the tensor included) complete on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(hopper::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(hopper::smem_addr(bar)),
      "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The tensor map of a bf16 (batch, n, cols) tensor at `base` (16-byte
// aligned, cols % 8 == 0) in boxes of one head's D columns x 64 rows of one
// sample, swizzled as the tiles above; rows past n read as zeros and never
// reach into the next sample.
template <int D>
inline cudaError_t head_tile_map(CUtensorMap* map, const void* base,
                                 uint64_t batch, uint64_t n, uint64_t cols) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {cols, n, batch};
  const cuuint64_t strides[2] = {cols * sizeof(__nv_bfloat16),
                                 n * cols * sizeof(__nv_bfloat16)};
  const cuuint32_t box[3] = {D, kRows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- descriptors -----------------------------------------------------------

template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(Tile<D>::kSbo >> 4) << 32) |
         (Tile<D>::kLayout << 62);
}

// k-step kk of a tile at shared address `tile` as a K-major operand.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc<D>(tile + 32u * kk);
}

// k-step kk of a tile as an MN-major operand (B with imm-trans-b = 1).
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc<D>(tile + 16u * Tile<D>::kRowBytes * kk);
}

// ---- wgmma -----------------------------------------------------------------

template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TPAT_W8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64, f32) (+)= A (64 x 16, shared, K-major) . B (16 x 64, shared,
// K-major); accumulate = 0 overwrites d.
__device__ __forceinline__ void ss_n64(float (&d)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : TPAT_W8(0), TPAT_W8(8), TPAT_W8(16), TPAT_W8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16, registers) . B (16 x 64, shared, MN-major).
__device__ __forceinline__ void rs_n64(float (&d)[32], const uint32_t a[4],
                                       uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : TPAT_W8(0), TPAT_W8(8), TPAT_W8(16), TPAT_W8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32) += A (64 x 16, registers) . B (16 x 32, shared, MN-major).
__device__ __forceinline__ void rs_n32(float (&d)[16], const uint32_t a[4],
                                       uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : TPAT_W8(0), TPAT_W8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef TPAT_W8

// d (64 x D) += A . B for one k16 step, B MN-major: the p.v, dlog.k,
// p^T.dO and dlog^T.q form.
template <int D>
__device__ __forceinline__ void rs(float (&d)[D / 2], const uint32_t a[4],
                                   uint64_t db) {
  if constexpr (D == 64)
    rs_n64(d, a, db);
  else
    rs_n32(d, a, db);
}

// s (64 x 64) = A . B^T over the D columns, both tiles K-major (q.k^T,
// dO.v^T, and k.q^T, v.dO^T in the cols kernel): D / 16 k-steps in order,
// the first overwriting s.  The one product code for the logits and dp of
// every kernel, so that the same operands give the same bits.
template <int D>
__device__ __forceinline__ void product_nt(float (&s)[32], uint32_t a_tile,
                                           uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ss_n64(s, desc_k<D>(a_tile, kk), desc_k<D>(b_tile, kk), kk > 0);
}

// acc (64 x D) += A (64 x 64, four k16 A fragments) . tile (64 x D),
// the tile MN-major.
template <int D>
__device__ __forceinline__ void product_nn(float (&acc)[D / 2],
                                           const uint32_t a[4][4],
                                           uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) rs<D>(acc, a[kk], desc_mn<D>(tile, kk));
}

// ---- fragments -------------------------------------------------------------

// 2^x on the special-function unit (one MUFU.EX2; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The four k16 A fragments of a 64 x 64 f32 accumulator, rounded to bf16.
__device__ __forceinline__ void to_a(uint32_t a[4][4], const float s[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float* lo = s + 8 * kk;  // column block 2kk
    const float* hi = lo + 4;      // column block 2kk + 1
    a[kk][0] = pack_bf16(lo[0], lo[1]);
    a[kk][1] = pack_bf16(lo[2], lo[3]);
    a[kk][2] = pack_bf16(hi[0], hi[1]);
    a[kk][3] = pack_bf16(hi[2], hi[3]);
  }
}

// Reductions over the 4 lanes of a quad (one accumulator row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Store a 64 x D f32 accumulator times `scale` as bf16 into rows [row0,
// row0 + 64) of dst (row stride `stride` values), rows at or past n
// skipped.  Every consumer thread.
template <int D>
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, size_t stride,
                                           const float acc[D / 2], int row0,
                                           int n, float scale) {
  const int lane = threadIdx.x & 31;
  const int r = row0 + 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if (row >= n) continue;
    __nv_bfloat16* p = dst + static_cast<size_t>(row) * stride + c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j) =
          pack_bf16(acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
  }
}

}  // namespace wgmma
