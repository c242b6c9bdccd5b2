// Fused swin_v2_cr window attention, forward, for Hopper (sm_90a): the dense
// form in bf16 on the tensor cores, and both forms in f32 in an exact FMA
// kernel.  The banded form in bf16 is window_attention_banded.cu's.
//
// Replaces tpat_tpu/ops/pallas_window_attention.py::_fwd_kernel, the TPU
// kernel that both _fused_impl (dense, the ESC-50 decoder grid, N = 256) and
// _banded_impl (banded, the AudioSet grid, N = 512) run in every block of
// the MAE decoder: here as _fused_impl runs it (and, in f32, _banded_impl).
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
// What bounds it.  At the ESC-50 decoder (B = 32, H = 16, D = 32, N = 256,
// bf16) a call must move qkv 25.2 MB + template 4.2 MB + out 8.4 MB, about
// 11 us at 3.35 TB/s.  The useful work is 4 D FLOPs per live pair (one
// whose template entry is not the -1e30 exclusion): 2 of a dense query
// block's 16 key blocks, 1 of a banded chunk's 8, well under a us on the
// tensor cores.  At the AudioSet decoder (N = 512, banded) qkv is 50 MB,
// the band 4.2 MB, out 16.8 MB: about 21 us.  Memory-bound.
//
// bf16 (every ESC-50-grid pretrain step), a tensor-core design written for
// both forms, on window_attention_tc.cuh, which the backward shares; the
// entry point takes the dense form only (the banded form, whose launches
// and staging this design spends its time on, is window_attention_banded
// .cu's: one kernel, batch-looping CTAs on TMA):
//   0. live: the live map of 16 x 16 template blocks (one launch per call,
//      reading the template once); a block with no entry above -1e29 has
//      p = 0 exactly, and a query block with a row that has no live entry
//      at all (uniform p) is kept whole.
//   1. main: one CTA per (window unit, head, sample), the unit the row's
//      whole key window (the grid up to 256 tokens, or one 128-token
//      chunk), so its queries are its keys: q, k and v staged once (16-byte
//      cp.async, rows padded to 40 values), q and k normalised in f32 and
//      split into hi = bf16(x^) and lo = bf16(x^ - hi).  One warp per 16
//      query rows, its q^ fragments in registers, two sweeps over the live
//      key blocks only:
//      a. cos = hi.hi + hi.lo + lo.hi (three bf16 mma.sync m16n8k16, f32
//         accumulation), the logits, and m and l online, the backward's
//         stats sweep code, so both see the same m and l;
//      b. cos and the logits again, p = exp(s - m) * (1 / l) on the
//         accumulator fragments, rounded to bf16 into the A operand after
//         it is normalised (the TPU's rounding point; a flash-style
//         rescaled accumulator would round unnormalised p), and
//         out += round(p) . v as one bf16 product.
//      A recomputed cos is cheap: 2 live key blocks per query block on the
//      ESC-50 grid, 1 in a banded chunk.
// f32 (held to plain at 1e-5), and bf16 at a dense grid over 256 tokens
// (which no model path runs, and whose unit the CTA's shared memory could
// not hold), keep the exact FMA kernel: one CTA per (b, h, 64-query tile);
// the tile's q rows staged and normalised once, the row's window of keys
// (N or 128) streamed through shared memory in 64-key tiles, the logits of
// the whole window kept in shared memory (64 x (window + 1) floats), the
// products f32 FMA loops on 4 x 4 register micro-tiles.

#include <cstdint>

#include "attention_mma.cuh"
#include "window_attention_common.cuh"
#include "window_attention_tc.cuh"

namespace {

using namespace window_attention;

struct FwdArgs {
  const void* qkv;
  const float* scale;
  const float* tmpl;
  unsigned char* live;  // tensor cores: (H, units, nb, nb) live blocks
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

// Shared memory for R = 16 nb staged rows: five bf16 tiles (q^ hi, q^ lo,
// k^ hi, k^ lo, v) and the unit's live map.
template <int D>
size_t tc_smem_bytes(int nb) {
  return 5 * TcSmem<D>::tile(nb * kBlk) + nb * nb;
}

// One CTA per (unit, head, sample), 32 nb threads; at most 64 registers, so
// that two CTAs of 16 warps (the dense grid) or four of 8 (a banded chunk)
// share an SM and one's staging overlaps another's products.
template <int D>
__global__ void __launch_bounds__(32 * kMaxWindow / kBlk, 2)
    window_attention_fwd_bf16_kernel(const FwdArgs a) {
  using mma::bf16;
  constexpr int ld = TcSmem<D>::kLd;
  const int n = a.n;
  const int w = window_keys(n, a.banded);
  const int nb = blocks(n, a.banded);
  const int rows = nb * kBlk;
  const int unit = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = a.banded ? unit * kChunk : 0;  // the unit's first token
  const int c = a.num_heads * D;
  const size_t stride = 3 * static_cast<size_t>(c);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t tb = TcSmem<D>::tile(rows);
  bf16* qhi = reinterpret_cast<bf16*>(smem_raw);
  bf16* qlo = reinterpret_cast<bf16*>(smem_raw + tb);
  bf16* khi = reinterpret_cast<bf16*>(smem_raw + 2 * tb);
  bf16* klo = reinterpret_cast<bf16*>(smem_raw + 3 * tb);
  bf16* vt = reinterpret_cast<bf16*>(smem_raw + 4 * tb);
  unsigned char* live = smem_raw + 5 * tb;

  const bf16* q_src = static_cast<const bf16*>(a.qkv) +
                      (static_cast<size_t>(b) * n + row0) * stride +
                      static_cast<size_t>(h) * D;
  stage_rows<D>(qhi, q_src, stride, w, rows);
  stage_rows<D>(khi, q_src + c, stride, w, rows);
  mma::cp_async_commit();
  stage_rows<D>(vt, q_src + 2 * c, stride, w, rows);  // lands during the split
  mma::cp_async_commit();
  const unsigned char* live_src =
      a.live + (static_cast<size_t>(h) * gridDim.x + unit) * nb * nb;
  for (int i = threadIdx.x; i < nb * nb; i += blockDim.x) live[i] = live_src[i];
  mma::cp_async_wait<1>();
  __syncthreads();
  {  // one thread per row of q (threads [0, rows)) and of k
    const int r = threadIdx.x % rows;
    if (threadIdx.x < rows)
      split_row<D>(qhi + r * ld, qlo + r * ld);
    else
      split_row<D>(khi + r * ld, klo + r * ld);
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // warp on query block `warp`; no barrier from here on
  const float* tm = a.tmpl + (static_cast<size_t>(h) * n + row0) * w;
  const float scale = a.scale[h];
  const int qb = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned char* qlive = live + qb * nb;
  // the warp's q^ fragments, loaded again for each block: kept across the
  // loops they would take the registers of two CTAs per SM
  uint32_t ah[D / 16][4], al[D / 16][4];

  // a. m and l, online over the live key blocks
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  for (int kb = 0; kb < nb; ++kb) {
    if (!qlive[kb]) continue;
    float s[2][4], alpha[2];
    mma::load_a<D>(ah, qhi, qb * kBlk, lane);
    mma::load_a<D>(al, qlo, qb * kBlk, lane);
    row_logits<D>(s, ah, al, khi, klo, tm, scale, w, qb, kb, lane);
    online_block(s, m, l, alpha);
  }
  float il[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) il[i] = 1.f / mma::quad_sum(l[i]);

  // b. out = round(p) . v over the same blocks
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int kb = 0; kb < nb; ++kb) {
    if (!qlive[kb]) continue;
    float s[2][4];
    mma::load_a<D>(ah, qhi, qb * kBlk, lane);
    mma::load_a<D>(al, qlo, qb * kBlk, lane);
    row_logits<D>(s, ah, al, khi, klo, tm, scale, w, qb, kb, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)  // -inf: a padding row or key
        s[j][e] = s[j][e] == -INFINITY ? 0.f
                                       : expf(s[j][e] - m[e >> 1]) * il[e >> 1];
    uint32_t pa[4];
    mma::to_a(pa, s);
    mma::product_nn<D>(acc, pa, vt, kb * kBlk, lane);
  }
  bf16* dst = static_cast<bf16*>(a.out) +
              (static_cast<size_t>(b) * n + row0) * c +
              static_cast<size_t>(h) * D;
  mma::store_rows<D>(dst, c, acc, qb * kBlk, w, 1.f, lane);
}

template <int D>
cudaError_t launch_bf16(const FwdArgs& a, int batch, cudaStream_t stream) {
  cudaError_t err =
      launch_live(a.tmpl, a.live, a.n, a.num_heads, a.banded, stream);
  if (err != cudaSuccess) return err;
  const int nb = blocks(a.n, a.banded);
  const size_t smem = tc_smem_bytes<D>(nb);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = window_attention_fwd_bf16_kernel<D>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(units(a.n, a.banded), a.num_heads, batch), 32 * nb, smem,
           stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The bytes of scratch the forward needs: the live map where the tensor
// cores run, else none.
extern "C" long long tpat_window_attention_fwd_scratch_bytes(int n,
                                                             int num_heads,
                                                             int dtype,
                                                             int banded) {
  return tensor_cores(n, dtype, banded)
             ? static_cast<long long>(live_bytes(n, num_heads, banded))
             : 0;
}

// dtype: 0 = float32, 1 = bfloat16.  qkv: (batch, n, 3 C) contiguous, C =
// num_heads * head_dim; scale: (num_heads,) f32; tmpl: (num_heads, n, n) f32
// (banded = 0) or (num_heads, n, 128) f32 with n % 128 == 0 (banded = 1),
// all on the device; scratch: tpat_window_attention_fwd_scratch_bytes(...)
// bytes (may be null when that is 0); out: (batch, n, C) in qkv's dtype.
// Launches on `stream` (bf16 at a window of up to 256 keys: the live map,
// then the tensor-core kernel; else the FMA kernel), synchronises nothing,
// and returns the first CUDA error (0 on success).
extern "C" int tpat_window_attention_fwd(const void* qkv, const void* scale,
                                         const void* tmpl, void* scratch,
                                         void* out, int batch, int n,
                                         int num_heads, int head_dim,
                                         int dtype, int banded,
                                         void* stream) {
  const bool tc = tensor_cores(n, dtype, banded);
  if (batch < 1 || batch > 65535 || n < 1 || num_heads < 1 ||
      num_heads > 65535 || (banded != 0 && banded != 1) ||
      (banded && n % kChunk != 0) || qkv == nullptr || scale == nullptr ||
      tmpl == nullptr || out == nullptr || (tc && scratch == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const FwdArgs a{qkv, static_cast<const float*>(scale),
                  static_cast<const float*>(tmpl),
                  static_cast<unsigned char*>(scratch), out, n, num_heads,
                  banded};
  const auto s = static_cast<cudaStream_t>(stream);
  // head_dim 32 only: the MAE decoder's 512 / 16, the one width the path
  // runs; the banded form in bf16 is window_attention_banded.cu's
  if (head_dim != 32 || (banded && dtype == 1)) return cudaErrorInvalidValue;
  if (tc) return launch_bf16<32>(a, batch, s);
  if (dtype == 0) return launch<float, 32>(a, batch, s);
  if (dtype == 1) return launch<__nv_bfloat16, 32>(a, batch, s);
  return cudaErrorInvalidValue;
}
