// Tensor-core pieces of the bf16 attention kernels (qkv_attention.cu, B1/B2,
// qkv_attention_bwd.cu, B3, window_attention.cu and window_attention_bwd.cu,
// the B5/B6 forward and backward; attn_probe.cu, the probes P1/P2, takes only
// column_sums4, as B1's wgmma body does):
// 16-byte cp.async tile copies, ldmatrix fragment loads, mma.sync m16n8k16
// bf16 products with f32 accumulation, movmatrix transposes of fragments,
// and the quad reductions over the accumulator layout.
//
// Tiles are 64 rows of one head's D values (D a multiple of 16), bf16 in
// shared memory with rows padded to kLd = D + 8 values: row r starts 16*r
// bytes (mod 128) further along the banks for D = 64 (144-byte rows), 48*r
// for D = 80 (176-byte rows) and 80*r for D = 32 (80-byte rows: 0, 80, 32,
// 112, 64, 16, 96, 48 for r = 0..7), so the eight row addresses of one
// ldmatrix phase hit eight distinct 16-byte bank groups.  A 64-row tile is
// 64 * D / 8 16-byte cp.async chunks, D / 16 per thread of a 128-thread CTA
// (2 at D = 32; 5 at D = 80).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), lane = 4 g + t:
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g,
//     8+2t..), a3 = (g+8, 8+2t..), two bf16 per register, low half first;
//   B (16 x 8): b0 = (k 2t..2t+1, n g), b1 = (k 8+2t.., n g);
//   C (16 x 8, f32): c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1).
// So the C fragments of two neighbouring 8-column tiles, rounded to bf16,
// are the A fragment of the 16 x 16 block they cover (p.v, dlog.k), and the
// rows of one C column sit on the lanes with the same t (column sums
// reduce over lane bits 2, 3 and 4).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;  // rows of a staged tile (queries or keys)
constexpr int kWarps = 4;  // each warp owns 16 rows of the CTA's tile
constexpr int kThreads = 32 * kWarps;

template <int D>
struct Tile {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  static constexpr int kLd = D + 8;  // padded row, in bf16 values
  static constexpr int kChunks = D / 8;  // 16-byte pieces of a row
  static constexpr int kElems = kRows * kLd;
  static constexpr size_t kBytes = kElems * sizeof(bf16);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (src is
// then not read but must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` committed groups are still in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// Rows [r0, r0 + 64) of one head's section (row stride `stride` values) into
// a padded shared tile; rows at or past n are zero.  All kThreads threads.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t stride, int r0, int n) {
  using T = Tile<D>;
  for (int i = threadIdx.x; i < kRows * T::kChunks; i += kThreads) {
    const int r = i / T::kChunks;
    const int c = (i - r * T::kChunks) * 8;
    const int row = r0 + r;
    const bool valid = row < n;
    cp_async16(dst + r * T::kLd + c,
               src + static_cast<size_t>(valid ? row : 0) * stride + c, valid);
  }
}

// load_tile for a tile of ROWS rows staged by a CTA of THREADS threads (the
// probes' query tiles of 32 and 128 rows, CTAs of 2 and 8 warps).
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_rows(bf16* dst, const bf16* src,
                                               size_t stride, int r0, int n) {
  using T = Tile<D>;
  for (int i = threadIdx.x; i < ROWS * T::kChunks; i += THREADS) {
    const int r = i / T::kChunks;
    const int c = (i - r * T::kChunks) * 8;
    const int row = r0 + r;
    const bool valid = row < n;
    cp_async16(dst + r * T::kLd + c,
               src + static_cast<size_t>(valid ? row : 0) * stride + c, valid);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b on the tensor cores: A 16 x 16 bf16, B 16 x 8 bf16, C f32.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 into one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of rows [r0, r0 + 16) of a tile, one per 16-column k-step.
template <int D>
__device__ __forceinline__ void load_a(uint32_t a[D / 16][4], const bf16* t,
                                       int r0, int lane) {
  const bf16* p = t + (r0 + (lane & 15)) * Tile<D>::kLd + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(a[kk], p + kk * 16);
}

// c[j] = A . B^T for the 16 rows of `a` against tile rows [n0 + 8j,
// n0 + 8j + 8), j = 0, 1: the sum over the D columns in k-step order, from
// zero.  The one product code for the logits (and dp) in every kernel, so
// that the same operands give the same bits.
template <int D>
__device__ __forceinline__ void product_nt(float c[2][4],
                                           const uint32_t a[D / 16][4],
                                           const bf16* t, int n0, int lane) {
  const bf16* p = t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * Tile<D>::kLd +
                  ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t b[4];
    ldmatrix_x4(b, p + kk * 16);
    mma_bf16(c[0], a[kk], b[0], b[1]);
    mma_bf16(c[1], a[kk], b[2], b[3]);
  }
}

// acc += A . tile[k0 .. k0 + 16) for a 16 x 16 A fragment (rows x tile rows)
// and the tile's D columns: the p.v form (B read transposed).
template <int D>
__device__ __forceinline__ void product_nn(float acc[D / 8][4],
                                           const uint32_t a[4], const bf16* t,
                                           int k0, int lane) {
  const bf16* p = t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                          Tile<D>::kLd +
                  (lane >> 4) * 8;
#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, p + dj * 16);
    mma_bf16(acc[2 * dj], a, b[0], b[1]);
    mma_bf16(acc[2 * dj + 1], a, b[2], b[3]);
  }
}

// The A fragment of a 16 x 16 block from the C fragments of its two 8-column
// halves, rounded to bf16.
__device__ __forceinline__ void to_a(uint32_t a[4], const float c[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// The transpose of an 8 x 8 b16 matrix held one register per lane in the
// layout of a0 above (lane 4 g + t: row g, columns 2t..2t+1).
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// The A fragment of the transpose of a 16 x 16 block from its A fragment:
// each 8 x 8 quarter transposed, the two off-diagonal quarters swapped.
__device__ __forceinline__ void transpose_a(uint32_t at[4],
                                            const uint32_t a[4]) {
  at[0] = movmatrix_trans(a[0]);
  at[1] = movmatrix_trans(a[2]);
  at[2] = movmatrix_trans(a[1]);
  at[3] = movmatrix_trans(a[3]);
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

// Sums over the 8 quads of a warp (the 16 rows) of a lane's four
// accumulator columns, v[2j + e] = column 8j + 2t + e, as a reduce-scatter
// over lane bits 4, 3 and 2: four shuffles where a sum per column takes
// twelve.  Returns the sum of column 8 b4 + 2t + b3 (b4, b3 the lane's bits
// 4 and 3); the lanes with bit 2 clear hold each column once.
__device__ __forceinline__ float column_sums4(const float v[4], int lane) {
  const bool b4 = lane & 16;
  const bool b3 = lane & 8;
  const float w0 =
      (b4 ? v[2] : v[0]) + __shfl_xor_sync(0xffffffffu, b4 ? v[0] : v[2], 16);
  const float w1 =
      (b4 ? v[3] : v[1]) + __shfl_xor_sync(0xffffffffu, b4 ? v[1] : v[3], 16);
  const float x =
      (b3 ? w1 : w0) + __shfl_xor_sync(0xffffffffu, b3 ? w0 : w1, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// Store an f32 accumulator tile (16 rows x D, C layout) as bf16 times
// `scale`, rows [row0, row0 + 16) of dst (row stride `stride`), rows at or
// past n skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, size_t stride,
                                           const float acc[D / 8][4], int row0,
                                           int n, float scale, int lane) {
  const int g = lane >> 2;
  const int c = (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= n) continue;
    bf16* p = dst + static_cast<size_t>(row) * stride + c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j) =
          pack_bf16(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
  }
}

}  // namespace mma
