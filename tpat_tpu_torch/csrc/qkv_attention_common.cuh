// Pieces shared by the packed-qkv attention forward (qkv_attention.cu, B1
// and B2) and the attention probes built on its body (attn_probe.cu, P1 and
// P2): the dtype loads and stores, the staging of a head's rows into shared
// memory, the thread's logit micro-tile and the reductions over the 16 lanes
// of a query row.  256 threads per CTA, as a 16 x 16 grid (tx = tid & 15,
// ty = tid >> 4).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

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
  // p is cast to v's dtype before p.v, as in the JAX kernels
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

// Rows [r0, r0 + rows) of one head's section (D values each) into shared
// memory as f32 with row stride ld; rows past n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          size_t row_stride, int r0, int rows,
                                          int n) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int row = r0 + r;
    dst[r * ld + d] =
        row < n ? Io<T>::load(src + static_cast<size_t>(row) * row_stride + d)
                : 0.f;
  }
}

// The thread's RI x 4 logits: rows ty + 16i of the Q tile against keys
// tx + 16j of the K tile (both with row stride D + 1), f32 accumulation,
// scale applied to the f32 sum.
template <int D, int RI>
__device__ __forceinline__ void tile_logits(const float* qs, const float* ks,
                                            int tx, int ty, float scale,
                                            float s[RI][4]) {
  constexpr int ld = D + 1;
  float acc[RI][4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float q[RI], k[4];
#pragma unroll
    for (int i = 0; i < RI; ++i) q[i] = qs[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) k[j] = ks[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(q[i], k[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = acc[i][j] * scale;
}

// Reductions over the 16 lanes (tx = 0..15) that share a query row.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace
