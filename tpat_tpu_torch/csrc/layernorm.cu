// Fused LayerNorm over the last dimension, forward and backward, for Hopper
// (sm_90a).
//
// Replaces tpat_tpu/ops/pallas_layernorm.py: _ln_fwd_kernel (forward) and
// _ln_bwd_kernel (backward), reached from models/vit.py::FusedLayerNorm
// (Block.norm1 / norm2 with use_fused_layernorm=True).
//
// What it computes, per row of x (M, D):
//   forward:  mu = mean(x), var = mean((x - mu)^2) (two passes, centred, not
//             E[x^2] - mu^2), rstd = rsqrt(var + eps), all in f32;
//             y = (x - mu) * rstd * w + b in f32, written in x's dtype, and
//             mu, rstd (M,) f32 for the backward;
//   backward: xhat = (x - mu) * rstd, dyg = dy * w,
//             dx = rstd * (dyg - mean(dyg) - xhat * mean(dyg * xhat)) in dy's
//             dtype, and per-CTA f32 partials of dw = sum_rows dy * xhat and
//             db = sum_rows dy into (tiles, D) buffers that the wrapper sums
//             (the JAX kernel's (grid, 1, d) partials): no atomics, so the
//             result is deterministic.
//
// What bounds it: bytes.  The forward reads x once and writes y once (about
// 1 flop per byte in bf16), the backward reads x and dy and writes dx; the
// H100's 3.35 TB/s is the limit, and everything else is kept off device
// memory.  Design:
//   - one warp per row, eight rows per 256-thread CTA in the forward; each
//     lane holds its share of the row in registers (16-byte vector loads,
//     lane l takes vectors l, l + 32, ...), so x is read from memory once
//     and both statistics passes run on registers with warp shuffles;
//   - the backward's CTA covers kRowsBwd rows, one warp per row in turn, w in
//     shared memory; each lane owns the same columns in every row, so its
//     dw/db partials stay in registers over the tile and are reduced across
//     the eight warps through shared memory once, at the end;
//   - the width is a template parameter (the embed widths of the repo's
//     configs: 192, 384, 768, 1024, 1280), so the per-lane arrays are
//     registers; a row's vectors not divisible by 32 leave the last lanes
//     idle.
// Plain f32 arithmetic, no tensor cores: there is no product to feed them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsBwd = 64;  // rows per backward CTA: one (tiles, D) partial row each

template <typename T>
struct Vec;

// 16 bytes = 4 floats
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float v[kN]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float v[kN]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// 16 bytes = 8 bf16, rounded to nearest even on the way out
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float v[kN]) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float v[kN]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};

// f32 parameters, kN of them from p
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float v[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 r = *reinterpret_cast<const float4*>(p + i);
    v[i] = r.x;
    v[i + 1] = r.y;
    v[i + 2] = r.z;
    v[i + 3] = r.w;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The row layout of one lane: kPer vectors of kN values, vector i of lane l
// at column (l + 32 i) * kN; vectors at or past kVecs do not exist.
template <typename T, int D>
struct Row {
  static constexpr int kN = Vec<T>::kN;
  static_assert(D % kN == 0, "width must be a multiple of the vector");
  static constexpr int kVecs = D / kN;
  static constexpr int kPer = (kVecs + 31) / 32;
  static __device__ __forceinline__ bool has(int lane, int i) {
    return lane + 32 * i < kVecs;
  }
  static __device__ __forceinline__ int col(int lane, int i) {
    return (lane + 32 * i) * kN;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    layernorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ b, T* __restrict__ y,
                         float* __restrict__ mu_out,
                         float* __restrict__ rstd_out, int m, float eps) {
  using R = Row<T, D>;
  constexpr int kN = R::kN;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= m) return;
  const T* src = x + static_cast<size_t>(row) * D;

  float v[R::kPer][kN];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < R::kPer; ++i) {
    if (R::has(lane, i)) {
      Vec<T>::load(src + R::col(lane, i), v[i]);
#pragma unroll
      for (int j = 0; j < kN; ++j) sum += v[i][j];
    }
  }
  const float mu = warp_sum(sum) / static_cast<float>(D);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < R::kPer; ++i) {
    if (R::has(lane, i)) {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        v[i][j] -= mu;
        sq += v[i][j] * v[i][j];
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(D) + eps);

  T* dst = y + static_cast<size_t>(row) * D;
#pragma unroll
  for (int i = 0; i < R::kPer; ++i) {
    if (R::has(lane, i)) {
      float g[kN], bb[kN];
      load_f32<kN>(w + R::col(lane, i), g);
      load_f32<kN>(b + R::col(lane, i), bb);
#pragma unroll
      for (int j = 0; j < kN; ++j) v[i][j] = v[i][j] * rstd * g[j] + bb[j];
      Vec<T>::store(dst + R::col(lane, i), v[i]);
    }
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    layernorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ mu_in,
                         const float* __restrict__ rstd_in,
                         const T* __restrict__ dy, T* __restrict__ dx,
                         float* __restrict__ dw_part,
                         float* __restrict__ db_part, int m) {
  using R = Row<T, D>;
  constexpr int kN = R::kN;
  __shared__ float red[kWarps][D];
  __shared__ float g[D];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kRowsBwd;
  for (int c = threadIdx.x; c < D; c += kThreads) g[c] = w[c];
  __syncthreads();

  float dw[R::kPer][kN], db[R::kPer][kN];
#pragma unroll
  for (int i = 0; i < R::kPer; ++i)
#pragma unroll
    for (int j = 0; j < kN; ++j) dw[i][j] = db[i][j] = 0.f;

  for (int r = r0 + warp; r < min(r0 + kRowsBwd, m); r += kWarps) {
    const size_t at = static_cast<size_t>(r) * D;
    const float mu = mu_in[r];
    const float rstd = rstd_in[r];
    float xh[R::kPer][kN], d[R::kPer][kN];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < R::kPer; ++i) {
      if (R::has(lane, i)) {
        Vec<T>::load(x + at + R::col(lane, i), xh[i]);
        Vec<T>::load(dy + at + R::col(lane, i), d[i]);
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          xh[i][j] = (xh[i][j] - mu) * rstd;
          const float dyg = d[i][j] * g[R::col(lane, i) + j];
          s1 += dyg;
          s2 += dyg * xh[i][j];
          dw[i][j] += d[i][j] * xh[i][j];
          db[i][j] += d[i][j];
        }
      }
    }
    const float m1 = warp_sum(s1) / static_cast<float>(D);
    const float m2 = warp_sum(s2) / static_cast<float>(D);
#pragma unroll
    for (int i = 0; i < R::kPer; ++i) {
      if (R::has(lane, i)) {
#pragma unroll
        for (int j = 0; j < kN; ++j)
          d[i][j] = rstd * (d[i][j] * g[R::col(lane, i) + j] - m1 -
                            xh[i][j] * m2);
        Vec<T>::store(dx + at + R::col(lane, i), d[i]);
      }
    }
  }

  // the tile's partials: each warp's column sums, then the sum over warps
  // in warp order (one thread per column)
  float* outs[2] = {dw_part, db_part};
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int i = 0; i < R::kPer; ++i) {
      if (R::has(lane, i)) {
#pragma unroll
        for (int j = 0; j < kN; ++j)
          red[warp][R::col(lane, i) + j] = which == 0 ? dw[i][j] : db[i][j];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) s += red[k][c];
      outs[which][static_cast<size_t>(blockIdx.x) * D + c] = s;
    }
    __syncthreads();
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T, int D>
cudaError_t launch_fwd(const void* x, const float* w, const float* b, void* y,
                       float* mu, float* rstd, int m, float eps,
                       cudaStream_t stream) {
  const dim3 grid((m + kWarps - 1) / kWarps);
  layernorm_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(y), mu, rstd, m, eps);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* x, const float* w, const float* mu,
                       const float* rstd, const void* dy, void* dx,
                       float* dw_part, float* db_part, int m,
                       cudaStream_t stream) {
  const dim3 grid((m + kRowsBwd - 1) / kRowsBwd);
  layernorm_bwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, mu, rstd, static_cast<const T*>(dy),
      static_cast<T*>(dx), dw_part, db_part, m);
  return cudaGetLastError();
}

// Dispatch on (dtype, width): dtype 0 = float32, 1 = bfloat16.
#define TPAT_LN_DISPATCH(CALL)                                       \
  switch (d) {                                                       \
    case 192:                                                        \
      return dtype == 0 ? CALL(float, 192) : CALL(__nv_bfloat16, 192); \
    case 384:                                                        \
      return dtype == 0 ? CALL(float, 384) : CALL(__nv_bfloat16, 384); \
    case 768:                                                        \
      return dtype == 0 ? CALL(float, 768) : CALL(__nv_bfloat16, 768); \
    case 1024:                                                       \
      return dtype == 0 ? CALL(float, 1024)                          \
                        : CALL(__nv_bfloat16, 1024);                 \
    case 1280:                                                       \
      return dtype == 0 ? CALL(float, 1280)                          \
                        : CALL(__nv_bfloat16, 1280);                 \
    default:                                                         \
      return cudaErrorInvalidValue;                                  \
  }

}  // namespace

// Rows per backward CTA: the partial buffers hold ceil(m / this) rows, so the
// wrapper sizes them from here and nowhere else.
extern "C" int tpat_layernorm_bwd_rows() { return kRowsBwd; }

// x, y: (m, d) contiguous, 16-byte aligned; w, b: (d,) f32; mu, rstd: (m,)
// f32.  Returns the CUDA error of the launch (0 on success).
extern "C" int tpat_layernorm_fwd(const void* x, const float* w,
                                  const float* b, void* y, float* mu,
                                  float* rstd, int m, int d, int dtype,
                                  float eps, void* stream) {
  if (m < 1 || (dtype != 0 && dtype != 1) ||
      !(aligned(x) && aligned(w) && aligned(b) && aligned(y)))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
#define TPAT_LN_FWD(T, D) launch_fwd<T, D>(x, w, b, y, mu, rstd, m, eps, s)
  TPAT_LN_DISPATCH(TPAT_LN_FWD)
#undef TPAT_LN_FWD
}

// x, dy, dx: (m, d) contiguous, 16-byte aligned, one dtype; w: (d,) f32;
// mu, rstd: (m,) f32 from the forward; dw_part, db_part: (ceil(m /
// tpat_layernorm_bwd_rows()), d) f32, one row per CTA.
extern "C" int tpat_layernorm_bwd(const void* x, const float* w,
                                  const float* mu, const float* rstd,
                                  const void* dy, void* dx, float* dw_part,
                                  float* db_part, int m, int d, int dtype,
                                  void* stream) {
  if (m < 1 || (dtype != 0 && dtype != 1) ||
      !(aligned(x) && aligned(w) && aligned(dy) && aligned(dx)))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
#define TPAT_LN_BWD(T, D) \
  launch_bwd<T, D>(x, w, mu, rstd, dy, dx, dw_part, db_part, m, s)
  TPAT_LN_DISPATCH(TPAT_LN_BWD)
#undef TPAT_LN_BWD
}
