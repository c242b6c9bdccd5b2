// The polynomial GELU, forward and backward, for Hopper (sm_90a): B-G.
//
// Replaces no Pallas kernel: tpat_tpu/ops/fast_gelu.py::gelu_poly is jnp,
// which XLA fuses into one elementwise pass on the TPU.  This is that pass
// for ops/fast_gelu.py::_GeluPoly (models/vit.py::Mlp), whose eager Horner
// loop otherwise runs about twenty f32 passes over the (B, N, 4C) MLP
// activation forward and forty backward.
//
// What it computes, per element, in f32 from the bf16 input x:
//   forward:  c = clamp(x, -4, 4), u = c c, P = Horner(phi, u),
//             y = x (0.5 + c P), rounded to bf16;
//   backward: P as above, P' = Horner(dphi, u), w = 1 inside (-4, 4), 1/2 at
//             +-4 and 0 outside (NaN included), then
//             dx = g ((0.5 + c P) + (x w) (P + (2 u) P')), rounded to bf16.
// Every product and sum is __fmul_rn / __fadd_rn in the order and
// association of _GeluPoly's eager ops, so nvcc contracts nothing into an
// FMA and each result is bit-equal to the eager path: the clamp keeps NaN
// (as torch.clamp does; fminf/fmaxf would drop it), and the coefficients
// arrive as kernel arguments, rounded to f32 from _PHI_COEFFS and
// _DPHI_COEFFS by the wrapper.
//
// What bounds it: bytes.  The forward moves 4 bytes an element (x in, y
// out) for ~25 f32 operations, the backward 6 (x and g in, dx out) for ~45:
// both below the card's ridge of ~10 non-FMA operations a byte.  Design:
//   - 16-byte vector loads (ld.global.nc) and stores, 8 bf16 a vector; each
//     thread loads its four vectors before it computes any, so that enough
//     loads are in flight to cover the memory latency;
//   - one CTA of 256 threads per 8192 elements, each CTA streaming its chunk
//     once and retiring: a grid-stride loop over the SMs' resident CTAs
//     reached 76-82% of the byte bound at the cells' shapes on an H100,
//     this grid 88-92%; no shared memory and no TMA, which a pure stream
//     does not need;
//   - one templated routine, map_elements, streams both directions; the
//     elements past the last whole vector are computed one at a time by
//     CTA 0; the wrapper hands the kernels 16-byte aligned pointers (a
//     view off 16 bytes is copied first).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors a thread
constexpr int kVec = 8;     // bf16 a 16-byte vector
constexpr int kPerCta = kThreads * kUnroll * kVec;  // elements a CTA covers
// CTAs an SM must hold: left free, ptxas gives the backward 78-109
// registers, three CTAs an SM or fewer, and it reaches 80-88% of its byte
// bound on an H100 against 90-92% at four (56 registers, no spills)
constexpr int kMinCtas = 4;

struct Phi {
  float k[9];  // P, highest degree first
};

struct Dphi {
  float k[8];  // P', highest degree first
};

// clamp(x, -4, 4) keeping NaN, as torch.clamp does: max.NaN and min.NaN
// return NaN for a NaN operand, where fmaxf and fminf return the bound
__device__ __forceinline__ float clamp4(float x) {
  float r;
  asm("max.NaN.f32 %0, %1, 0fC0800000;" : "=f"(r) : "f"(x));
  asm("min.NaN.f32 %0, %1, 0f40800000;" : "=f"(r) : "f"(r));
  return r;
}

template <int K>
__device__ __forceinline__ float horner(const float (&k)[K], float u) {
  float p = k[0];
#pragma unroll
  for (int i = 1; i < K; ++i) p = __fadd_rn(__fmul_rn(p, u), k[i]);
  return p;
}

__device__ __forceinline__ float gelu_fwd(float x, const Phi& phi) {
  const float c = clamp4(x);
  const float p = horner(phi.k, __fmul_rn(c, c));
  return __fmul_rn(x, __fadd_rn(0.5f, __fmul_rn(c, p)));
}

__device__ __forceinline__ float gelu_bwd(float x, float g, const Phi& phi,
                                          const Dphi& dphi) {
  const float c = clamp4(x);
  const float u = __fmul_rn(c, c);
  const float p = horner(phi.k, u);
  const float dp = horner(dphi.k, u);
  const float a = fabsf(x);
  const float w = a < 4.f ? 1.f : (a == 4.f ? 0.5f : 0.f);
  const float inner = __fadd_rn(p, __fmul_rn(__fmul_rn(2.f, u), dp));
  const float deriv = __fadd_rn(__fadd_rn(0.5f, __fmul_rn(c, p)),
                                __fmul_rn(__fmul_rn(x, w), inner));
  return __fmul_rn(g, deriv);
}

__device__ __forceinline__ void unpack(const uint4& r, float v[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// cvt.rn.bf16x2.f32: each half rounded as __float2bfloat16_rn rounds it
__device__ __forceinline__ uint4 pack(const float v[kVec]) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return r;
}

// out[i] = the forward at x[i], or with kGrad the backward at x[i] and
// g[i], over n elements, the pointers 16-byte aligned.  Thread t of CTA b
// takes the vectors b * kThreads * kUnroll + j * kThreads + t
// (j < kUnroll), then CTA 0 the fewer than 8 elements past the last whole
// vector.
template <bool kGrad>
__device__ __forceinline__ void map_elements(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
    __nv_bfloat16* __restrict__ out, int64_t n, const Phi& phi,
    const Dphi& dphi) {
  const auto op = [&](float xe, float ge) {
    return kGrad ? gelu_bwd(xe, ge, phi, dphi) : gelu_fwd(xe, phi);
  };
  const int64_t nv = n / kVec;
  const int64_t v0 = int64_t(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  uint4* ov = reinterpret_cast<uint4*>(out);
  uint4 rx[kUnroll], rg[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const int64_t v = v0 + j * kThreads;
    if (v < nv) {
      rx[j] = __ldg(xv + v);
      if (kGrad) rg[j] = __ldg(gv + v);
    }
  }
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const int64_t v = v0 + j * kThreads;
    if (v < nv) {
      float a[kVec], b[kVec] = {};
      unpack(rx[j], a);
      if (kGrad) unpack(rg[j], b);
#pragma unroll
      for (int e = 0; e < kVec; ++e) a[e] = op(a[e], b[e]);
      ov[v] = pack(a);
    }
  }
  const int64_t i = nv * kVec + threadIdx.x;
  if (blockIdx.x == 0 && i < n)
    out[i] = __float2bfloat16_rn(
        op(__bfloat162float(x[i]), kGrad ? __bfloat162float(g[i]) : 0.f));
}

__global__ void __launch_bounds__(kThreads, kMinCtas)
    gelu_poly_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                         __nv_bfloat16* __restrict__ y, int64_t n, Phi phi) {
  map_elements<false>(x, nullptr, y, n, phi, Dphi{});
}

__global__ void __launch_bounds__(kThreads, kMinCtas)
    gelu_poly_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ g,
                         __nv_bfloat16* __restrict__ dx, int64_t n, Phi phi,
                         Dphi dphi) {
  map_elements<true>(x, g, dx, n, phi, dphi);
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int grid_for(int64_t n) { return int((n + kPerCta - 1) / kPerCta); }

}  // namespace

// x, y: n contiguous bf16, 16-byte aligned; phi: P's 9 f32 coefficients,
// highest degree first.  Returns the CUDA error of the launch (0 on
// success; nothing is launched for n = 0).
extern "C" int tpat_gelu_poly_fwd(const void* x, void* y, int64_t n,
                                  const float* phi, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (!aligned(x) || !aligned(y)) return cudaErrorMisalignedAddress;
  if (n == 0) return cudaSuccess;
  Phi p;
  for (int i = 0; i < 9; ++i) p.k[i] = phi[i];
  gelu_poly_fwd_kernel<<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
      n, p);
  return cudaGetLastError();
}

// x, g, dx: n contiguous bf16, 16-byte aligned; phi: P's 9 coefficients,
// dphi: P''s 8, highest degree first.  Returns as tpat_gelu_poly_fwd.
extern "C" int tpat_gelu_poly_bwd(const void* x, const void* g, void* dx,
                                  int64_t n, const float* phi,
                                  const float* dphi, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (!aligned(x) || !aligned(g) || !aligned(dx))
    return cudaErrorMisalignedAddress;
  if (n == 0) return cudaSuccess;
  Phi p;
  Dphi d;
  for (int i = 0; i < 9; ++i) p.k[i] = phi[i];
  for (int i = 0; i < 8; ++i) d.k[i] = dphi[i];
  gelu_poly_bwd_kernel<<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(dx),
      n, p, d);
  return cudaGetLastError();
}
