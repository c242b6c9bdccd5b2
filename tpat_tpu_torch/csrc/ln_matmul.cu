// LayerNorm prologue fused into a matrix product, for Hopper (sm_90a): the
// counterpart of the probe kernel scripts/probe_ln_matmul.py::_ln_mm_kernel.
//
// What it computes, for x (M, K), g and b (K,) f32, w (K, N):
//   y   = LN(x) per row with f32 statistics (mean, then the centred
//         variance), y = (x - mu) * rsqrt(var + eps) * g + b, rounded to x's
//         dtype (the TPU kernel's y.astype(x.dtype));
//   out = y . w, accumulated in f32, written in x's dtype.
// The product is computed here, in the kernel's own body: no library GEMM.
//
// What bounds it: operations.  At the probe's shapes (M = 128 * 257,
// K = 768, N = 2304) the product is 116 GFLOP against 205 MB of traffic,
// far above the H100's ~295 operations per byte in bf16.  This first kernel
// runs the product as f32 FMA tiles (no tensor cores), so it is bound by the
// FMA pipes, well below the bf16 tensor-core bound; mma/wgmma tiles are
// later work.  Design (one CTA = one (64-row, 128-column) output tile, 256
// threads):
//   - prologue: the tile's 64 rows of x, the whole K of each, go to shared
//     memory in x's dtype (64 x 768 bf16 = 96 KB); one warp per row computes
//     mu and rstd over that copy and overwrites it with the rounded y, so x
//     is read from device memory once per CTA and y never goes there;
//   - main loop: 32-row slices of w (converted to f32) stream through shared
//     memory; each thread accumulates a 4 x 8 register tile (rows ty + 16 i,
//     columns tx + 16 j), reading y and w from shared memory;
//   - CTAs of neighbouring column tiles share their x rows, and blockIdx.x
//     runs over the column tiles first, so the repeated reads of x hit L2;
//   - ragged edges (M = 32896 is not a multiple of 64) are masked: rows past
//     M are zero (their y is b, never written), columns past N and the k
//     slice past K load as zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 64;   // rows per CTA
constexpr int kBN = 128;  // columns per CTA
constexpr int kBK = 32;   // rows of w per streamed slice

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int k, size_t itemsize) {
  return kBM * static_cast<size_t>(k) * itemsize + kBK * kBN * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_matmul_kernel(const T* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ b, const T* __restrict__ w,
                     T* __restrict__ out, int m, int k, int n, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ys = reinterpret_cast<T*>(smem_raw);  // (kBM, k), y after the prologue
  float* ws = reinterpret_cast<float*>(smem_raw + kBM * static_cast<size_t>(k) *
                                                      sizeof(T));  // (kBK, kBN)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;

  // prologue: LN of the tile's rows, one warp per row
  for (int r = warp; r < kBM; r += kWarps) {
    const int row = m0 + r;
    T* yr = ys + static_cast<size_t>(r) * k;
    const T* xr = x + static_cast<size_t>(row) * k;
    float sum = 0.f;
    for (int c = lane; c < k; c += 32) {
      const float v = row < m ? Io<T>::load(xr + c) : 0.f;
      Io<T>::store(&yr[c], v);  // exact: v is a value of T
      sum += v;
    }
    const float mu = warp_sum(sum) / static_cast<float>(k);
    float sq = 0.f;
    for (int c = lane; c < k; c += 32) {
      const float d = Io<T>::load(&yr[c]) - mu;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(k) + eps);
    for (int c = lane; c < k; c += 32)
      Io<T>::store(&yr[c], (Io<T>::load(&yr[c]) - mu) * rstd * g[c] + b[c]);
  }

  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    __syncthreads();  // the prologue done, or the previous slice consumed
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int kk = e / kBN;
      const int cc = e - kk * kBN;
      ws[e] = k0 + kk < k && n0 + cc < n
                  ? Io<T>::load(w + static_cast<size_t>(k0 + kk) * n + n0 + cc)
                  : 0.f;
    }
    __syncthreads();
    const int kn = min(kBK, k - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float a[4], bw[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = Io<T>::load(&ys[static_cast<size_t>(ty + 16 * i) * k + k0 + kk]);
#pragma unroll
      for (int j = 0; j < 8; ++j) bw[j] = ws[kk * kBN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < n) Io<T>::store(out + static_cast<size_t>(row) * n + col, acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* g, const float* b,
                   const void* w, void* out, int m, int k, int n, float eps,
                   cudaStream_t stream) {
  auto kernel = ln_matmul_kernel<T>;
  const size_t smem = smem_bytes(k, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), g, b, static_cast<const T*>(w),
      static_cast<T*>(out), m, k, n, eps);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory a CTA needs at depth k: the wrapper refuses a k whose
// tile does not fit.
extern "C" long long tpat_ln_matmul_smem(int k, int dtype) {
  return static_cast<long long>(smem_bytes(k, dtype == 0 ? 4 : 2));
}

// dtype: 0 = float32, 1 = bfloat16 (x, w and out).  x: (m, k), w: (k, n),
// out: (m, n), all contiguous; g, b: (k,) f32.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int tpat_ln_matmul(const void* x, const float* g, const float* b,
                              const void* w, void* out, int m, int k, int n,
                              int dtype, float eps, void* stream) {
  if (m < 1 || k < 1 || n < 1 || (m + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, g, b, w, out, m, k, n, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g, b, w, out, m, k, n, eps, s);
  return cudaErrorInvalidValue;
}
