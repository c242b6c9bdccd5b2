// Fused swin_v2_cr window attention, forward, in exact f32 FMA tiles, for
// Hopper (sm_90a): both forms in f32, and the dense form in bf16 at a grid
// that window_attention_dense.cu does not take (over 256 tokens, or not a
// whole number of 16-token blocks), which no model path runs.  bf16 dense
// grids of up to 256 tokens are window_attention_dense.cu's, the banded form
// in bf16 window_attention_banded.cu's.
//
// Replaces tpat_tpu/ops/pallas_window_attention.py::_fwd_kernel, the TPU
// kernel that both _fused_impl (dense, the ESC-50 decoder grid, N = 256) and
// _banded_impl (banded, the AudioSet grid, N = 512) run in every block of
// the MAE decoder: here as either runs it in f32 (the parity checks at 1e-5).
//
// What it computes, per (batch b, head h), from the packed (B, N, 3C) qkv
// (sections [q | k | v], heads contiguous, C = H * D), the (H,) f32 scales
// and the f32 template:
//   q^ = q * rsqrt(max(sum q^2, 1e-24)), k^ likewise, in f32;
//   logit[i, j] = (q^_i . k^_j) * scale[h] + template[h, i, j - kb(i)];
//   p = softmax over the row's window of keys, in f32;
//   out_i = sum_j round(p_ij) v_j, accumulated in f32, cast to qkv's type;
// where the row's window of keys is the whole grid (dense: kb = 0, the
// template is (H, N, N)) or the row's own 128-token chunk of the window-major
// order (banded: kb(i) = 128 * (i / 128), the band is (H, N, 128)).  p is
// rounded to v's type before p . v, as the TPU kernel rounds it.  A -1e30
// template entry (a pair in two windows) gives an exact 0; the row max is
// finite because every row's own token is in its window.
//
// What bounds it.  At the ESC-50 decoder in f32 (B = 32, H = 16, D = 32, N =
// 256) a call must move qkv 50.3 MB + template 4.2 MB + out 16.8 MB, about
// 21 us at 3.35 TB/s, and do 4 D FLOPs a (query, key) pair of the window
// outside the tensor cores (TF32 would break the f32 checks): 4.3 GFLOP,
// 64 us at 67 TFLOP/s.  No model step runs it in f32; the checks do.
//
// The design: one CTA per (b, h, 64-query tile); the tile's q rows staged
// and normalised once, the row's window of keys (N or 128) streamed through
// shared memory in 64-key tiles, the logits of the whole window kept in
// shared memory (64 x (window + 1) floats), the products f32 FMA loops on
// 4 x 4 register micro-tiles.

#include <cstdint>

#include "window_attention_common.cuh"

namespace {

using namespace window_attention;

struct FwdArgs {
  const void* qkv;
  const float* scale;
  const float* tmpl;
  void* out;
  int n, num_heads, banded;
};

template <int D>
size_t fwd_smem_bytes(int n, int banded) {
  const int nk = banded ? kChunk : n;
  return (2 * kTile * (D + 1) + static_cast<size_t>(kTile) * (nk + 1)) *
         sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    window_attention_fwd_kernel(const FwdArgs a) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kDj = D / 16;
  const int n = a.n;
  const int nk = window_keys(n, a.banded);
  const int lld = nk + 1;
  extern __shared__ float smem[];
  float* qs = smem;                 // the query tile, normalised
  float* ks = qs + kTile * (D + 1);  // a key tile, normalised; then a V tile
  float* lg = ks + kTile * (D + 1);  // logits, then p, [row][key]

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = blockIdx.x * kTile;
  const int kb = key_begin(r0, a.banded);  // a 64-row tile lies in one chunk
  const int c = a.num_heads * D;
  const size_t stride = 3 * static_cast<size_t>(c);
  const T* q_src = static_cast<const T*>(a.qkv) +
                   static_cast<size_t>(b) * n * stride +
                   static_cast<size_t>(h) * D;
  const T* k_src = q_src + c;
  const T* v_src = q_src + 2 * c;
  const float* tm = a.tmpl + static_cast<size_t>(h) * n * nk;
  const float scale = a.scale[h];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  load_rows<T, D>(qs, q_src, stride, r0, n);
  __syncthreads();
  normalise_rows<D>(qs, nullptr);

  // logits of the whole window
  for (int k0 = 0; k0 < nk; k0 += kTile) {
    __syncthreads();  // q normalised; the previous key tile consumed
    load_rows<T, D>(ks, k_src, stride, kb + k0, kb + nk);
    __syncthreads();
    normalise_rows<D>(ks, nullptr);
    __syncthreads();
    float cs[4][4];
    tile_dot<D>(qs, ks, tx, ty, cs);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = r0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= nk) continue;
        lg[r * lld + col] =
            row < n ? logit(cs[i][j], scale,
                            tm[static_cast<size_t>(row) * nk + col])
                    : 0.f;
      }
    }
  }
  __syncthreads();

  // exact softmax, one warp per row; p rounded to the working type
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    if (r0 + r >= n) continue;
    float* row = lg + r * lld;
    float m = -INFINITY;
    for (int j = lane; j < nk; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < nk; j += 32) row[j] = Io<T>::round(row[j] / sum);
  }

  // out = p . v
  float acc[4][kDj];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDj; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < nk; k0 += kTile) {
    __syncthreads();  // p written; the previous V tile consumed
    load_rows<T, D>(ks, v_src, stride, kb + k0, kb + nk);
    __syncthreads();
    const int kn = min(kTile, nk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float p[4], v[kDj];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = lg[(ty + 16 * i) * lld + k0 + kk];
#pragma unroll
      for (int j = 0; j < kDj; ++j) v[j] = ks[kk * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDj; ++j) acc[i][j] = fmaf(p[i], v[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= n) continue;
    T* dst = static_cast<T*>(a.out) + (static_cast<size_t>(b) * n + row) * c +
             static_cast<size_t>(h) * D;
#pragma unroll
    for (int j = 0; j < kDj; ++j) Io<T>::store(dst + tx + 16 * j, acc[i][j]);
  }
}

template <typename T, int D>
cudaError_t launch(const FwdArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<D>(a.n, a.banded);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = window_attention_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kTile - 1) / kTile, a.num_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  qkv: (batch, n, 3 C) contiguous, C =
// num_heads * head_dim; scale: (num_heads,) f32; tmpl: (num_heads, n, n) f32
// (banded = 0) or (num_heads, n, 128) f32 with n % 128 == 0 (banded = 1),
// all on the device; out: (batch, n, C) in qkv's dtype.  bf16 only at a
// dense grid that window_attention_dense.cu does not take.  Launches the
// FMA kernel on `stream`, synchronises nothing, and returns the CUDA error
// (0 on success).
extern "C" int tpat_window_attention_fwd(const void* qkv, const void* scale,
                                         const void* tmpl, void* out,
                                         int batch, int n, int num_heads,
                                         int head_dim, int dtype, int banded,
                                         void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || num_heads < 1 ||
      num_heads > 65535 || (banded != 0 && banded != 1) ||
      (banded && n % kChunk != 0) || qkv == nullptr || scale == nullptr ||
      tmpl == nullptr || out == nullptr) {
    return cudaErrorInvalidValue;
  }
  const FwdArgs a{qkv, static_cast<const float*>(scale),
                  static_cast<const float*>(tmpl), out, n, num_heads, banded};
  const auto s = static_cast<cudaStream_t>(stream);
  // head_dim 32 only: the MAE decoder's 512 / 16, the one width the path
  // runs; bf16 only where the Hopper sources take no call
  if (head_dim != 32 || (dtype == 1 && (banded || dense_takes(n))))
    return cudaErrorInvalidValue;
  if (dtype == 0) return launch<float, 32>(a, batch, s);
  if (dtype == 1) return launch<__nv_bfloat16, 32>(a, batch, s);
  return cudaErrorInvalidValue;
}
