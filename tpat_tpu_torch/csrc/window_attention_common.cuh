// Device helpers shared by window_attention.cu (forward) and
// window_attention_bwd.cu (backward): typed loads and stores, staging a
// 64-row tile of one head's slice of the packed qkv into shared memory,
// the cosine normalisation, the 64 x 64 tile product and the logit.
//
// Two families of kernels compute the logits, each with one code:
// - the f32 FMA kernels (f32, and bf16 at a dense grid over 256 tokens,
//   which no model path runs): the normalisation and tile_dot below, the
//   same f32 FMA chain over d in order, then logit();
// - the bf16 tensor-core kernels: window_attention_tc.cuh's split_row and
//   split_nt (cos as three bf16 products hi.hi + hi.lo + lo.hi of the
//   normalised rows), then logit().
// Within a family the forward and the backward kernels get the same bits
// for a logit of the same operand order, and in the tensor-core family the
// backward's stats sweep gets the forward's row max and sum (online_block).
// Across the families they differ in the last bits of cos.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace window_attention {

constexpr int kThreads = 256;
constexpr int kTile = 64;    // rows (queries or keys) per staged tile
constexpr int kChunk = 128;  // the banded form's block-diagonal chunk
constexpr float kEps2 = 1e-24f;  // F.normalize's 1e-12 floor, squared, in f32
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's dynamic limit
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

// Rows [r0, r0 + 64) of one head's slice into shared memory as f32, rows
// padded to D + 1 floats; rows at or past `limit` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          size_t row_stride, int r0,
                                          int limit) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int row = r0 + r;
    dst[r * (D + 1) + d] =
        row < limit
            ? Io<T>::load(src + static_cast<size_t>(row) * row_stride + d)
            : 0.f;
  }
}

// x <- x * rsqrt(max(sum x^2, 1e-24)) for each of the 64 staged rows, in
// f32 (four threads per row); the factor goes to fac[r] when fac is given.
// A zero row stays zero.
template <int D>
__device__ __forceinline__ void normalise_rows(float* x, float* fac) {
  const int r = threadIdx.x >> 2;
  const int part = threadIdx.x & 3;
  float s = 0.f;
  for (int d = part; d < D; d += 4) {
    const float v = x[r * (D + 1) + d];
    s = fmaf(v, v, s);
  }
  s += __shfl_xor_sync(kFull, s, 1);
  s += __shfl_xor_sync(kFull, s, 2);
  const float f = rsqrtf(fmaxf(s, kEps2));
  for (int d = part; d < D; d += 4) x[r * (D + 1) + d] *= f;
  if (fac != nullptr && part == 0) fac[r] = f;
}

// The thread's 4 x 4 products of staged rows ty + 16i of a against rows
// tx + 16j of b, f32 FMA accumulation over d in order.
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int tx, int ty, float out[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(x[i], y[j], out[i][j]);
  }
}

// cos(q, k) * scale + template, in f32.  A -1e30 template entry (a
// cross-window pair) stays -1e30, so exp(logit - row max) is exactly 0.
__device__ __forceinline__ float logit(float cos, float scale, float tmpl) {
  return fmaf(cos, scale, tmpl);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Sum over the 16 threads (tx = 0..15) that share a ty: one row of a
// thread's 4 x 4 (or 4 x D/16) micro-tile.
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The first key of a query row's column window, and the number of keys in
// it: the whole grid (dense), or the row's own 128-token chunk (banded).
// The template's row stride is that count.
__host__ __device__ __forceinline__ int key_begin(int row, int banded) {
  return banded ? (row / kChunk) * kChunk : 0;
}

__host__ __device__ __forceinline__ int window_keys(int n, int banded) {
  return banded ? kChunk : n;
}

}  // namespace window_attention
