// The gradient pieces of the bf16 window-attention backward kernels, shared
// by window_attention_dense.cu (the dense form) and window_attention_banded.cu
// (the banded form): the split-bf16 product into a D-wide accumulator and
// the F.normalize VJP of a warp's 16 rows on the way out.

#pragma once

#include <cstddef>
#include <cstdint>

#include "attention_mma.cuh"
#include "window_attention_tc.cuh"

namespace window_attention {

// acc += (A_hi + A_lo) . (tile_hi + tile_lo)[k0 .. k0 + 16) without lo.lo.
template <int D>
__device__ __forceinline__ void split_nn(float acc[D / 8][4],
                                         const uint32_t ahi[4],
                                         const uint32_t alo[4],
                                         const mma::bf16* thi,
                                         const mma::bf16* tlo, int k0,
                                         int lane) {
  mma::product_nn<D>(acc, ahi, thi, k0, lane);
  mma::product_nn<D>(acc, ahi, tlo, k0, lane);
  mma::product_nn<D>(acc, alo, thi, k0, lane);
}

// The F.normalize VJP of a warp's 16 rows from row r0 of the staged x^
// (hi + lo) in the accumulator layout, g <- (g - x^ <x^, g>) * fac[row],
// then stored as bf16 rows of dst; rows at or past `valid` are skipped.
template <int D>
__device__ __forceinline__ void store_normalised(
    mma::bf16* dst, size_t stride, float g[D / 8][4], const mma::bf16* xhi,
    const mma::bf16* xlo, const float* fac, int r0, int valid, int lane) {
  constexpr int ld = TcSmem<D>::kLd;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + (lane >> 2) + 8 * i;
    float xs[D / 8][2];
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int at = r * ld + 8 * j + t2 + e;
        xs[j][e] = __bfloat162float(xhi[at]) + __bfloat162float(xlo[at]);
        dot = fmaf(xs[j][e], g[j][2 * i + e], dot);
      }
    dot = mma::quad_sum(dot);
    const float f = fac[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        g[j][2 * i + e] = (g[j][2 * i + e] - xs[j][e] * dot) * f;
  }
  mma::store_rows<D>(dst, stride, g, r0, valid, 1.f, lane);
}

}  // namespace window_attention
