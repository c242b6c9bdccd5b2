// Fused packed-qkv attention forward with pruning-score emission, for Hopper
// (sm_90a).
//
// Replaces tpat_tpu/ops/pallas_attention.py::_qkv_kernel in both its forms:
// the plain one every block of the static forward runs, and the prefix one
// (prefix=True, kv_valid) the hybrid anneal runs after its first drop block
// (models/vit.py::PrunedAttention with attention_impl='fused').
//
// What it computes, per (batch b, head h):
//   p   = softmax(q . k^T * D^-1/2) in f32 over the keys [0, kv_valid)
//         (exact, not approximate), normalised by multiplying with the
//         reciprocal of the row sum; keys at or past kv_valid get p = 0, as
//         the TPU kernel's -1e30 logit gives them (kv_valid = N: all keys);
//   out = cast_to_input_dtype(p) . v, accumulated in f32, written in the
//         input dtype -- the same rounding point as the JAX kernel;
//   'patch_mean': column sums of the normalised f32 p over query rows in
//                 [extra, kv_valid) (the AudioMAE importance signal);
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
//     rows past N load as zero and are never written, keys past N get p = 0;
//   - the prefix form is the same code with kv_valid < N in the key
//     predicate: rows at or past kv_valid are still computed and written, as
//     on the TPU (later blocks read them; the pooled feature leaves them out).
// Plain FMA loops, no tensor cores: the first port is right and simple;
// mma/wgmma tiles are later work.

#include <cmath>
#include <cstddef>

#include "qkv_attention_common.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per CTA
constexpr int kBK = 64;  // keys per streamed tile
constexpr int kModeNone = 0;
constexpr int kModePatchMean = 1;
constexpr int kModeCls = 2;

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    qkv_attention_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                             float* __restrict__ colsum, int n, int num_heads,
                             int mode, int extra, int kv_valid, float scale) {
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
    tile_logits<D, 4>(qs, ks, tx, ty, scale, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < kv_valid) mt = fmaxf(mt, s[i][j]);
      // key 0 is valid, so m is finite from the first tile on
      const float m_new = fmaxf(m[i], row_max(mt));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < kv_valid) sum += expf(s[i][j] - m_new);
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
    tile_logits<D, 4>(qs, ks, tx, ty, scale, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * S::kPLd + tx + 16 * j] =
            k0 + tx + 16 * j < kv_valid ? expf(s[i][j] - m[i]) * inv[i] : 0.f;
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
        if (row >= extra && row < kv_valid) acc += ps[r * S::kPLd + col];
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
                   int num_heads, int mode, int extra, int kv_valid,
                   float scale, cudaStream_t stream) {
  auto kernel = qkv_attention_fwd_kernel<T, D>;
  constexpr size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBQ - 1) / kBQ, num_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out),
      static_cast<float*>(colsum), n, num_heads, mode, extra, kv_valid,
      scale);
  return cudaGetLastError();
}

}  // namespace

// Query rows per CTA: the patch_mean partial buffer holds ceil(n / this)
// q-tiles, so the wrapper sizes it from here and nowhere else.
extern "C" int tpat_qkv_attention_qtile() { return kBQ; }

// dtype: 0 = float32, 1 = bfloat16.  mode: 0 = none, 1 = patch_mean,
// 2 = cls.  colsum: (batch, num_heads, n_qtiles, n) f32 for patch_mean, with
// n_qtiles = ceil(n / tpat_qkv_attention_qtile()),
// (batch, num_heads, 1, n) for cls, unused for none.  kv_valid in
// (extra, n]: keys [0, kv_valid) are valid (n for the plain form).  Returns
// the CUDA error of the launch (0 on success).
extern "C" int tpat_qkv_attention_fwd(const void* qkv, void* out, void* colsum,
                                      int batch, int n, int num_heads,
                                      int head_dim, int dtype, int mode,
                                      int extra, int kv_valid, float scale,
                                      void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || num_heads < 1 ||
      num_heads > 65535 || mode < kModeNone || mode > kModeCls || extra < 0 ||
      kv_valid <= extra || kv_valid > n ||
      (mode != kModeNone && colsum == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(qkv, out, colsum, batch, n, num_heads, mode,
                             extra, kv_valid, scale, s);
  if (dtype == 0 && head_dim == 80)
    return launch<float, 80>(qkv, out, colsum, batch, n, num_heads, mode,
                             extra, kv_valid, scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(qkv, out, colsum, batch, n, num_heads,
                                     mode, extra, kv_valid, scale, s);
  if (dtype == 1 && head_dim == 80)
    return launch<__nv_bfloat16, 80>(qkv, out, colsum, batch, n, num_heads,
                                     mode, extra, kv_valid, scale, s);
  return cudaErrorInvalidValue;
}
