// The bf16 tensor-core pieces shared by the window-attention forward
// (window_attention.cu) and backward (window_attention_bwd.cu): which
// geometries take them, the live map of 16 x 16 template blocks, staging a
// window unit's rows, the split of a normalised row into bf16 hi and lo,
// the split-bf16 cosine and the online row statistics.
//
// A window unit is the row's whole key window: the grid (dense, at most 256
// tokens) or one 128-token chunk (banded).  Its queries are its keys, so a
// CTA stages the unit's q, k and v once and one warp takes each 16 rows.
//
// The forward and the backward compute cos, the logits and the row max m
// and sum l with this code alone: the same normalisation and split
// (split_row), the same three bf16 products hi.hi + hi.lo + lo.hi in the
// same order (split_nt), the same online update over the live key blocks
// in the same order (row_logits, online_block).  So the backward's stats
// sweep gets the forward's m and l bit for bit.

#pragma once

#include <cstdint>

#include "attention_mma.cuh"
#include "window_attention_common.cuh"

namespace window_attention {

constexpr int kBlk = 16;         // rows of a warp's block (queries or keys)
constexpr int kMaxWindow = 256;  // the tensor-core kernels' largest window
constexpr float kDead = -1e29f;  // template entries at or below: p = 0

// The dispatch rule of both sources: bf16 at a window of at most 256 keys
// (every banded geometry, a dense grid of up to 256 tokens) runs the
// tensor-core kernels; f32 and larger dense grids the FMA kernels.
inline bool tensor_cores(int n, int dtype, int banded) {
  return dtype == 1 && window_keys(n, banded) <= kMaxWindow;
}

__host__ __device__ __forceinline__ int units(int n, int banded) {
  return banded ? n / kChunk : 1;
}

__host__ __device__ __forceinline__ int blocks(int n, int banded) {
  return (window_keys(n, banded) + kBlk - 1) / kBlk;
}

// The live map's bytes, (H, units, nb, nb), rounded up to a multiple of
// 256 so that what follows it in a scratch buffer stays 256-byte aligned.
inline size_t live_bytes(int n, int num_heads, int banded) {
  const size_t nb = blocks(n, banded);
  return (static_cast<size_t>(num_heads) * units(n, banded) * nb * nb + 255) /
         256 * 256;
}

// Staged bf16 tiles of a unit: rows padded to kLd = D + 8 values.
template <int D>
struct TcSmem {
  static constexpr int kLd = mma::Tile<D>::kLd;
  static __host__ __device__ size_t tile(int rows) {
    return static_cast<size_t>(rows) * kLd * 2;
  }
};

// The live map: one CTA per (unit, head, query block qb).  live[qb][kb] =
// some entry of the 16 x 16 block above kDead, or a row of qb with none at
// all (its p is uniform over the window, so the whole query block is kept).
// A block that is not live has p = 0 exactly and adds exact zeros to every
// sum, so the kernels skip it.
__global__ void __launch_bounds__(kThreads)
    window_attention_live_kernel(const float* tmpl, unsigned char* live_map,
                                 int n, int banded) {
  __shared__ unsigned char row_live[kBlk][kMaxWindow / kBlk];
  __shared__ bool dead_row[kBlk];  // a row with no live entry at all
  const int w = window_keys(n, banded);
  const int nb = blocks(n, banded);
  const int unit = blockIdx.x;
  const int h = blockIdx.y;
  const int qb = blockIdx.z;
  const int rows = min(kBlk, w - qb * kBlk);
  const float* tm = tmpl + (static_cast<size_t>(h) * n +
                            unit * (banded ? kChunk : 0) + qb * kBlk) *
                               w;
  // the block's entries, coalesced (consecutive threads on consecutive
  // entries), all loads of a thread in flight at once
  constexpr int kPer = kBlk * kMaxWindow / kThreads;
  float t[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    t[k] = i < rows * w ? tm[i] : kDead;
  }
  for (int i = threadIdx.x; i < kBlk * nb; i += kThreads)
    row_live[i / nb][i % nb] = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {  // each finder writes the same 1
    const int i = threadIdx.x + k * kThreads;
    if (t[k] > kDead) row_live[i / w][(i % w) / kBlk] = 1;
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    bool any = false;
    for (int k = 0; k < nb; ++k) any |= row_live[threadIdx.x][k] != 0;
    dead_row[threadIdx.x] = !any;
  }
  __syncthreads();
  if (threadIdx.x < nb) {
    const int kb = threadIdx.x;
    bool any = false;
    for (int r = 0; r < rows; ++r) any |= row_live[r][kb] != 0 || dead_row[r];
    live_map[((static_cast<size_t>(h) * gridDim.x + unit) * nb + qb) * nb +
             kb] = any;
  }
}

// Launch the live map of an (H, n, window) template into live_map
// (live_bytes(...) bytes).
inline cudaError_t launch_live(const float* tmpl, unsigned char* live_map,
                               int n, int num_heads, int banded,
                               cudaStream_t stream) {
  window_attention_live_kernel<<<dim3(units(n, banded), num_heads,
                                      blocks(n, banded)),
                                 kThreads, 0, stream>>>(tmpl, live_map, n,
                                                        banded);
  return cudaGetLastError();
}

// Rows [0, rows) of one head's section (row stride `stride` values) into a
// padded tile; rows at or past `valid` are zero.  All threads.
template <int D>
__device__ __forceinline__ void stage_rows(mma::bf16* dst,
                                           const mma::bf16* src,
                                           size_t stride, int valid,
                                           int rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    const bool ok = r < valid;
    mma::cp_async16(dst + r * TcSmem<D>::kLd + c,
                    src + static_cast<size_t>(ok ? r : 0) * stride + c, ok);
  }
}

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

// The logits of query block qb (the warp's q^ fragments) against key block
// kb of the staged k^ (hi, lo), in the accumulator layout: cos * scale +
// template, -inf at a padding row or key (at or past w).  tm is the unit's
// (w, w) template, row stride w.
template <int D>
__device__ __forceinline__ void row_logits(float s[2][4],
                                           const uint32_t qh[D / 16][4],
                                           const uint32_t ql[D / 16][4],
                                           const mma::bf16* khi,
                                           const mma::bf16* klo,
                                           const float* tm, float scale,
                                           int w, int qb, int kb, int lane) {
  split_nt<D>(s, qh, ql, khi, klo, kb * kBlk, lane);
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = qb * kBlk + g + 8 * (e >> 1);
      const int key = kb * kBlk + 8 * j + t2 + (e & 1);
      s[j][e] = row < w && key < w ? logit(s[j][e], scale, tm[row * w + key])
                                   : -INFINITY;
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
