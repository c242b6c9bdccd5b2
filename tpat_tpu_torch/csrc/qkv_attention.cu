// Fused packed-qkv attention forward with pruning-score emission, for Hopper
// (sm_90a).
//
// Replaces tpat_tpu/ops/pallas_attention.py::_qkv_kernel (non-prefix form),
// the TPU kernel every block of the static-pruned eval forward runs
// (models/vit.py::PrunedAttention with attention_impl='fused').
//
// What it computes, per (batch b, head h):
//   p   = softmax(q . k^T * D^-1/2) in f32 over all N keys (exact, not
//         approximate), normalised by multiplying with the reciprocal of the
//         row sum;
//   out = cast_to_input_dtype(p) . v, accumulated in f32, written in the
//         input dtype -- the same rounding point as the JAX kernel;
//   'patch_mean': column sums of the normalised f32 p over query rows >= extra
//                 (the AudioMAE importance signal);
//   'cls':        the row-0 probabilities (the AST importance signal);
//   none:         no score output and no score work.
// q, k and v are read straight out of the packed (B, N, 3C) projection output
// (sections at column offsets 0, C and 2C, head h at h*D) and out is written
// as (B, N, C): no permute on either side.
//
// What bounds it at the serving shapes (D = 64, N in {257, 181, 127, 90}):
// the N^2.D score and p.v work per head.  Each query tile re-reads its
// head's K and V (N.D values) from L2, but every K or V element a CTA loads
// feeds BQ = 64 FMAs, so the FMA pipes, not memory, are the limit.
//
// Design (one CTA = one (b, h, tile of BQ query rows), 256 threads):
//   - the Q tile is held in shared memory as f32; K (and V) stream through
//     shared memory in tiles of BK keys, so N is not bounded by shared memory;
//   - pass 1 walks K once and keeps each row's running max and denominator
//     (online rescaling), so the softmax is exact without holding a BQ x N
//     logit tile;
//   - pass 2 walks K and V again, recomputes the same logits (same code, same
//     order, so p <= 1 and rows sum to 1), writes the normalised p tile to
//     shared memory, accumulates p.v in registers and reduces the tile's
//     column sums;
//   - column sums go to an f32 partial buffer (B, H, n_qtiles, N) that the
//     wrapper sums over q-tiles: no atomics, so scores are deterministic;
//   - each thread owns a 4 x 4 register micro-tile (rows ty + 16i, keys or
//     head dims tx + 16j); shared rows are padded by one float so the column
//     walks of the micro-tile hit distinct banks;
//   - ragged edges (none of 257/181/127/90 is a multiple of 64) are masked:
//     rows past N load as zero and are never written, keys past N get p = 0.
// Plain FMA loops, no tensor cores: the first port is right and simple;
// mma/wgmma tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per CTA
constexpr int kBK = 64;  // keys per streamed tile
constexpr int kModeNone = 0;
constexpr int kModePatchMean = 1;
constexpr int kModeCls = 2;

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
  // p is cast to v's dtype before p.v, as in the JAX kernel
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

// Shared-memory layout in floats.
template <int D>
struct Smem {
  static constexpr int kLd = D + 1;     // padded Q/K rows
  static constexpr int kPLd = kBK + 1;  // padded p rows
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kLd;
  static constexpr int kV = kK + kBK * kLd;
  static constexpr int kP = kV + kBK * D;
  static constexpr int kRed = kP + kBQ * kPLd;
  static constexpr int kFloats = kRed + 4 * kBK;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// Rows [r0, r0 + rows) of one head's section into shared memory as f32;
// rows past n are zero.
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

// The thread's 4 x 4 logits: rows ty + 16i of the Q tile against keys
// tx + 16j of the K tile, f32 accumulation, scale applied to the f32 sum.
template <int D>
__device__ __forceinline__ void tile_logits(const float* qs, const float* ks,
                                            int tx, int ty, float scale,
                                            float s[4][4]) {
  constexpr int ld = Smem<D>::kLd;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float q[4], k[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = qs[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) k[j] = ks[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(q[i], k[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    qkv_attention_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                             float* __restrict__ colsum, int n, int num_heads,
                             int mode, int extra, float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  using S = Smem<D>;
  constexpr int kDj = D / 16;
  extern __shared__ float smem[];
  float* qs = smem + S::kQ;
  float* ks = smem + S::kK;
  float* vs = smem + S::kV;
  float* ps = smem + S::kP;
  float* red = smem + S::kRed;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = num_heads * D;
  const size_t row_stride = 3 * static_cast<size_t>(c);
  const T* q_src = qkv + static_cast<size_t>(b) * n * row_stride +
                   static_cast<size_t>(h) * D;
  const T* k_src = q_src + c;
  const T* v_src = q_src + 2 * c;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = qt * kBQ;

  load_rows<T, D>(qs, S::kLd, q_src, row_stride, q0, kBQ, n);

  // pass 1: running row max and denominator
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed (and Q loaded)
    load_rows<T, D>(ks, S::kLd, k_src, row_stride, k0, kBK, n);
    __syncthreads();
    float s[4][4];
    tile_logits<D>(qs, ks, tx, ty, scale, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < n) mt = fmaxf(mt, s[i][j]);
      const float m_new = fmaxf(m[i], row_max(mt));  // key k0 is always valid
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < n) sum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum(sum);
      m[i] = m_new;
    }
  }

  // pass 2: normalised p, p.v and the score column sums
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = 1.f / l[i];
  float o[4][kDj];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDj; ++j) o[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBK) {
    __syncthreads();
    load_rows<T, D>(ks, S::kLd, k_src, row_stride, k0, kBK, n);
    load_rows<T, D>(vs, D, v_src, row_stride, k0, kBK, n);
    __syncthreads();
    float s[4][4];
    tile_logits<D>(qs, ks, tx, ty, scale, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * S::kPLd + tx + 16 * j] =
            k0 + tx + 16 * j < n ? expf(s[i][j] - m[i]) * inv[i] : 0.f;
    __syncthreads();

    const int kn = min(kBK, n - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float p[4], v[kDj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = Io<T>::round(ps[(ty + 16 * i) * S::kPLd + kk]);
#pragma unroll
      for (int j = 0; j < kDj; ++j) v[j] = vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDj; ++j) o[i][j] = fmaf(p[i], v[j], o[i][j]);
    }

    if (mode == kModePatchMean) {
      // four partial sums of 16 rows per key column, then one per column
      const int col = tid & (kBK - 1);
      const int part = tid / kBK;
      float acc = 0.f;
      for (int r = part * 16; r < part * 16 + 16; ++r) {
        const int row = q0 + r;
        if (row >= extra && row < n) acc += ps[r * S::kPLd + col];
      }
      red[part * kBK + col] = acc;
      __syncthreads();
      if (tid < kBK && k0 + tid < n) {
        const size_t at =
            ((static_cast<size_t>(b) * num_heads + h) * gridDim.x + qt) * n;
        colsum[at + k0 + tid] =
            red[tid] + red[kBK + tid] + red[2 * kBK + tid] + red[3 * kBK + tid];
      }
    } else if (mode == kModeCls && qt == 0) {
      if (tid < kBK && k0 + tid < n) {
        const size_t at = (static_cast<size_t>(b) * num_heads + h) * n;
        colsum[at + k0 + tid] = ps[tid];  // query row 0
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < n) {
      T* dst = out + (static_cast<size_t>(b) * n + row) * c +
               static_cast<size_t>(h) * D;
#pragma unroll
      for (int j = 0; j < kDj; ++j) Io<T>::store(dst + tx + 16 * j, o[i][j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* qkv, void* out, void* colsum, int batch, int n,
                   int num_heads, int mode, int extra, float scale,
                   cudaStream_t stream) {
  auto kernel = qkv_attention_fwd_kernel<T, D>;
  constexpr size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBQ - 1) / kBQ, num_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out),
      static_cast<float*>(colsum), n, num_heads, mode, extra, scale);
  return cudaGetLastError();
}

}  // namespace

// Query rows per CTA: the patch_mean partial buffer holds ceil(n / this)
// q-tiles, so the wrapper sizes it from here and nowhere else.
extern "C" int tpat_qkv_attention_qtile() { return kBQ; }

// dtype: 0 = float32, 1 = bfloat16.  mode: 0 = none, 1 = patch_mean,
// 2 = cls.  colsum: (batch, num_heads, n_qtiles, n) f32 for patch_mean, with
// n_qtiles = ceil(n / tpat_qkv_attention_qtile()),
// (batch, num_heads, 1, n) for cls, unused for none.  Returns the CUDA error
// of the launch (0 on success).
extern "C" int tpat_qkv_attention_fwd(const void* qkv, void* out, void* colsum,
                                      int batch, int n, int num_heads,
                                      int head_dim, int dtype, int mode,
                                      int extra, float scale, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || num_heads < 1 ||
      num_heads > 65535 || mode < kModeNone || mode > kModeCls || extra < 0 ||
      (mode != kModeNone && colsum == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(qkv, out, colsum, batch, n, num_heads, mode,
                             extra, scale, s);
  if (dtype == 0 && head_dim == 80)
    return launch<float, 80>(qkv, out, colsum, batch, n, num_heads, mode,
                             extra, scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(qkv, out, colsum, batch, n, num_heads,
                                     mode, extra, scale, s);
  if (dtype == 1 && head_dim == 80)
    return launch<__nv_bfloat16, 80>(qkv, out, colsum, batch, n, num_heads,
                                     mode, extra, scale, s);
  return cudaErrorInvalidValue;
}
