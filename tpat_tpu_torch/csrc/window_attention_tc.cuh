// The bf16 tensor-core pieces shared by the Hopper window-attention
// sources, window_attention_dense.cu (the dense form) and
// window_attention_banded.cu (the banded form), forward and backward: the
// split of a normalised row into bf16 hi and lo, the split-bf16 cosine and
// the online row statistics.
//
// A CTA stages a window unit's rows, the whole grid (dense, at most 256
// tokens) or one 128-token chunk (banded), whose queries are its keys, and
// one warp takes each 16 rows.
//
// The forward and the backward compute cos, the logits and the row max m
// and sum l with this code alone: the same normalisation and split
// (split_row), the same three bf16 products hi.hi + hi.lo + lo.hi in the
// same order (split_nt), the same online update over the live key blocks
// in the same order (online_block).  So the backward's stats sweep gets
// the forward's m and l bit for bit.

#pragma once

#include <cstdint>

#include "attention_mma.cuh"
#include "window_attention_common.cuh"

namespace window_attention {

constexpr int kBlk = 16;         // rows of a warp's block (queries or keys)
constexpr float kDead = -1e29f;  // template entries at or below: p = 0

// Staged bf16 tiles of a unit: rows padded to kLd = D + 8 values.
template <int D>
struct TcSmem {
  static constexpr int kLd = mma::Tile<D>::kLd;
};

// x <- x^ = x * rsqrt(max(sum x^2, 1e-24)) in f32 for one staged row, split
// into hi = bf16(x^) (in place) and lo = bf16(x^ - hi); returns the factor.
// The row moves as 16-byte words (a staged row starts on a 16-byte
// boundary; eight rows of 80 bytes hit eight distinct bank groups) and
// stays packed in registers between the sum and the split.
template <int D>
__device__ __forceinline__ float split_row(mma::bf16* hi, mma::bf16* lo) {
  static_assert(D % 8 == 0, "a row is whole 16-byte words");
  uint32_t x[D / 2];  // bf16 pairs, d = 2i in the low half
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 u = reinterpret_cast<const uint4*>(hi)[c];
    x[4 * c] = u.x;
    x[4 * c + 1] = u.y;
    x[4 * c + 2] = u.z;
    x[4 * c + 3] = u.w;
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    const float v0 = __uint_as_float(x[i] << 16);
    const float v1 = __uint_as_float(x[i] & 0xffff0000u);
    s = fmaf(v0, v0, s);
    s = fmaf(v1, v1, s);
  }
  const float f = rsqrtf(fmaxf(s, kEps2));
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t xi = x[4 * c + i];
      const float v0 = __uint_as_float(xi << 16) * f;
      const float v1 = __uint_as_float(xi & 0xffff0000u) * f;
      h[i] = mma::pack_bf16(v0, v1);
      l[i] = mma::pack_bf16(v0 - __uint_as_float(h[i] << 16),
                            v1 - __uint_as_float(h[i] & 0xffff0000u));
    }
    reinterpret_cast<uint4*>(hi)[c] = make_uint4(h[0], h[1], h[2], h[3]);
    reinterpret_cast<uint4*>(lo)[c] = make_uint4(l[0], l[1], l[2], l[3]);
  }
  return f;
}

// c[j] = (A_hi + A_lo) . (B_hi + B_lo)^T without the lo.lo term, for the 16
// rows of the A fragments against tile rows [n0 + 8j, n0 + 8j + 8): per
// k-step hi.hi, hi.lo, lo.hi, f32 accumulation from zero.
template <int D>
__device__ __forceinline__ void split_nt(float c[2][4],
                                         const uint32_t ahi[D / 16][4],
                                         const uint32_t alo[D / 16][4],
                                         const mma::bf16* bhi,
                                         const mma::bf16* blo, int n0,
                                         int lane) {
  const int off = (n0 + (lane & 7) + ((lane >> 4) << 3)) * TcSmem<D>::kLd +
                  ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t h[4], l[4];
    mma::ldmatrix_x4(h, bhi + off + kk * 16);
    mma::ldmatrix_x4(l, blo + off + kk * 16);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mma::mma_bf16(c[j], ahi[kk], h[2 * j], h[2 * j + 1]);
      mma::mma_bf16(c[j], ahi[kk], l[2 * j], l[2 * j + 1]);
      mma::mma_bf16(c[j], alo[kk], h[2 * j], h[2 * j + 1]);
    }
  }
}

// One key block into the online row statistics of the lane's two rows (g,
// g + 8): m <- max(m, the block's row max), l <- l * alpha + sum exp(s - m),
// alpha = exp(m_old - m) (1 while m is -inf).  s becomes exp(s - m) (0 at
// -inf).  l is the lane's share: the row's sum is the quad's.
__device__ __forceinline__ void online_block(float s[2][4], float m[2],
                                             float l[2], float alpha[2]) {
  float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], mma::quad_max(mt[i]));
    alpha[i] = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
    l[i] *= alpha[i];
    m[i] = m_new;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      s[j][e] = s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - m[i]);
      l[i] += s[j][e];
    }
}

}  // namespace window_attention
