// Fused swin_v2_cr window attention, backward, in exact f32 FMA kernels, for
// Hopper (sm_90a): both forms in f32, and the dense form in bf16 at a grid
// that window_attention_dense.cu does not take (over 256 tokens, or not a
// whole number of 16-token blocks), which no model path runs.  bf16 dense
// grids of up to 256 tokens are window_attention_dense.cu's, the banded form
// in bf16 window_attention_banded.cu's.
//
// Replaces tpat_tpu/ops/pallas_window_attention.py::_bwd_kernel (dense, via
// _fused_bwd_impl) and ::_banded_bwd_kernel (banded, via _banded_bwd_impl),
// the TPU kernels the custom VJPs of fused_window_attention and
// fused_window_attention_banded run in every decoder block of an MAE
// pretrain step: here as they run in f32 (the parity checks at 1e-4 of the
// largest gradient).
//
// What it computes, per (batch b, head h), with the forward's notation (the
// row's window of keys is the whole grid, or its own 128-token chunk):
//   p     = softmax(cos * scale[h] + template) in f32, recomputed;
//   dp    = dO . v^T from the working-type inputs, accumulated in f32;
//   dlog  = p (dp - sum_j dp p), kept in f32 (not rounded, unlike B3);
//   dcos  = dlog * scale[h];
//   dq^   = dcos . k^, dk^ = dcos^T . q^, in f32;
//   dq    = (dq^ - q^ <q^, dq^>) * rsqrt(max(|q|^2, 1e-24)), dk likewise
//           (the F.normalize VJP for |x| > eps, as the TPU kernel writes it);
//   dv    = round(p)^T . dO;
//   d_scale[h]    = sum over b, i, j of dlog * cos;
//   d_template[h] = sum over b of dlog (dense (N, N); banded (N, 128));
// d_qkv packed as [dq | dk | dv] in qkv's type, as the TPU kernel writes it.
//
// What is different on Hopper.  On the TPU the batch is the innermost
// sequential grid axis, and d_scale and d_template ride it as resident
// accumulators.  CTAs on the card run in no order, so every sum over the
// batch is taken in a fixed order by one CTA (the template kernel below
// loops over the batch): no floating-point atomics, the same bits from run
// to run.
//
// The design: exact FMA kernels on f32 tiles with 4 x 4 register
// micro-tiles (tensor-core f32 would be TF32), three in turn:
//   1. rows: one CTA per (b, h, 64-query tile): the exact softmax of the
//      tile's whole window in shared memory, delta, then dlog and dq; writes
//      dq and the f32 (B, H, 3, N) scratch [m | l | delta].
//   2. cols: one CTA per (b, h, 64-key tile): walks the query tiles whose
//      window holds its keys, recomputes p and dlog, sums dk^ and dv.
//   3. template: one CTA per (h, 64-query tile, 64-key tile of the window):
//      loops over the batch in order for d_template, and writes one d_scale
//      partial.

#include <cstdint>

#include "window_attention_common.cuh"

namespace {

using namespace window_attention;

struct BwdArgs {
  const void* qkv;
  const float* scale;
  const float* tmpl;
  const void* dout;
  void* dqkv;
  float* stats;  // (B, H, 3, N) m | l | delta
  float* dtmpl;
  float* ds_part;  // (H, partials)
  int batch, n, num_heads, banded;
};

// d_scale partials per head: one per template CTA (64-query tiles times
// the 64-key tiles of a window).
int partials(int n, int banded) {
  const int row_tiles = (n + kTile - 1) / kTile;
  const int key_tiles = banded ? kChunk / kTile : row_tiles;
  return row_tiles * key_tiles;
}

size_t scratch_bytes(int batch, int n, int num_heads) {
  return static_cast<size_t>(batch) * num_heads * 3 * n * sizeof(float);
}

template <typename T, int D>
struct Slices {
  const T* q;   // this (b, h)'s q rows; k and v follow at + c and + 2c
  const T* d_o;  // this (b, h)'s dO rows
  T* dq;        // this (b, h)'s dq rows; dk and dv at + c and + 2c
  size_t stride;
  int c;
  __device__ Slices(const BwdArgs& a, int b, int h) {
    c = a.num_heads * D;
    stride = 3 * static_cast<size_t>(c);
    const size_t head = static_cast<size_t>(h) * D;
    q = static_cast<const T*>(a.qkv) + static_cast<size_t>(b) * a.n * stride +
        head;
    d_o = static_cast<const T*>(a.dout) + static_cast<size_t>(b) * a.n * c +
          head;
    dq = static_cast<T*>(a.dqkv) + static_cast<size_t>(b) * a.n * stride + head;
  }
};

// ---------------------------------------------------------------------------
// 1. rows: dq and the softmax statistics
// ---------------------------------------------------------------------------

template <int D>
size_t rows_smem_bytes(int n, int banded) {
  const int nk = window_keys(n, banded);
  return (4 * kTile * (D + 1) + 3 * kTile +
          static_cast<size_t>(kTile) * (nk + 1)) *
         sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) window_attention_bwd_rows_kernel(
    const BwdArgs a) {
  constexpr int kDj = D / 16;
  constexpr int ld = D + 1;
  const int n = a.n;
  const int nk = window_keys(n, a.banded);
  const int lld = nk + 1;
  extern __shared__ float smem[];
  float* qs = smem;           // query tile, normalised
  float* dos = qs + kTile * ld;
  float* ks = dos + kTile * ld;  // key tile, normalised
  float* vs = ks + kTile * ld;
  float* qfac = vs + kTile * ld;   // per-row rsqrt factor
  float* mrow = qfac + kTile;      // row max
  float* lrow = mrow + kTile;      // row sum
  float* lg = lrow + kTile;        // logits -> p -> dcos, [row][key]

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = blockIdx.x * kTile;
  const int kb = key_begin(r0, a.banded);
  const Slices<T, D> sl(a, b, h);
  const T* k_src = sl.q + sl.c;
  const T* v_src = sl.q + 2 * sl.c;
  const float* tm = a.tmpl + static_cast<size_t>(h) * n * nk;
  const float scale = a.scale[h];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  load_rows<T, D>(qs, sl.q, sl.stride, r0, n);
  load_rows<T, D>(dos, sl.d_o, sl.c, r0, n);
  __syncthreads();
  normalise_rows<D>(qs, qfac);

  // logits of the whole window
  for (int k0 = 0; k0 < nk; k0 += kTile) {
    __syncthreads();
    load_rows<T, D>(ks, k_src, sl.stride, kb + k0, kb + nk);
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

  // exact softmax in f32, one warp per row: lg becomes p
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    float* row = lg + r * lld;
    if (r0 + r >= n) {
      for (int j = lane; j < nk; j += 32) row[j] = 0.f;
      if (lane == 0) mrow[r] = lrow[r] = 0.f;
      continue;
    }
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
    for (int j = lane; j < nk; j += 32) row[j] = row[j] / sum;
    if (lane == 0) {
      mrow[r] = m;
      lrow[r] = sum;
    }
  }

  // delta = sum_j dp p
  float delta[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < nk; k0 += kTile) {
    __syncthreads();
    load_rows<T, D>(vs, v_src, sl.stride, kb + k0, kb + nk);
    __syncthreads();
    float dp[4][4];
    tile_dot<D>(dos, vs, tx, ty, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col < nk)
          delta[i] = fmaf(dp[i][j], lg[(ty + 16 * i) * lld + col], delta[i]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) delta[i] = row_sum16(delta[i]);

  // dlog, dcos (in place of p) and dq^ = dcos . k^
  float acc[4][kDj];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDj; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < nk; k0 += kTile) {
    __syncthreads();
    load_rows<T, D>(ks, k_src, sl.stride, kb + k0, kb + nk);
    load_rows<T, D>(vs, v_src, sl.stride, kb + k0, kb + nk);
    __syncthreads();
    normalise_rows<D>(ks, nullptr);
    float dp[4][4];
    tile_dot<D>(dos, vs, tx, ty, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= nk) continue;
        float* e = lg + (ty + 16 * i) * lld + col;
        *e = *e * (dp[i][j] - delta[i]) * scale;
      }
    __syncthreads();
    const int kn = min(kTile, nk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float g[4], kd[kDj];
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = lg[(ty + 16 * i) * lld + k0 + kk];
#pragma unroll
      for (int j = 0; j < kDj; ++j) kd[j] = ks[kk * ld + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDj; ++j) acc[i][j] = fmaf(g[i], kd[j], acc[i][j]);
    }
  }

  // dq = (dq^ - q^ <q^, dq^>) * qfac; the statistics
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kDj; ++j)
      dot = fmaf(qs[r * ld + tx + 16 * j], acc[i][j], dot);
    dot = row_sum16(dot);
    const int row = r0 + r;
    if (row >= n) continue;
    T* dst = sl.dq + static_cast<size_t>(row) * sl.stride;
#pragma unroll
    for (int j = 0; j < kDj; ++j) {
      const float qn = qs[r * ld + tx + 16 * j];
      Io<T>::store(dst + tx + 16 * j, (acc[i][j] - qn * dot) * qfac[r]);
    }
    if (tx == 0) {
      float* st = a.stats + (static_cast<size_t>(b) * a.num_heads + h) * 3 * n;
      st[row] = mrow[r];
      st[n + row] = lrow[r];
      st[2 * n + row] = delta[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Shared by cols and template: stage a query tile with its statistics
// ---------------------------------------------------------------------------

// Query rows [q0, q0 + 64) (normalised) and their dO rows, and m, l, delta
// per row into vec[0..64), vec[64..128), vec[128..192); rows at or past
// `limit` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_queries(const BwdArgs& a,
                                             const Slices<T, D>& sl, int b,
                                             int h, int q0, int limit,
                                             float* qs, float* dos,
                                             float* vec) {
  load_rows<T, D>(qs, sl.q, sl.stride, q0, limit);
  load_rows<T, D>(dos, sl.d_o, sl.c, q0, limit);
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    const float* st =
        a.stats + (static_cast<size_t>(b) * a.num_heads + h) * 3 * a.n;
    const bool ok = row < limit;
    vec[threadIdx.x] = ok ? st[row] : 0.f;
    vec[kTile + threadIdx.x] = ok ? st[a.n + row] : 1.f;
    vec[2 * kTile + threadIdx.x] = ok ? st[2 * a.n + row] : 0.f;
  }
  __syncthreads();
  normalise_rows<D>(qs, nullptr);
}

// ---------------------------------------------------------------------------
// 2. cols: dk and dv
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t cols_smem_bytes() {
  return (5 * kTile * (D + 1) + 2 * kTile * (kTile + 1) + 3 * kTile) *
         sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) window_attention_bwd_cols_kernel(
    const BwdArgs a) {
  constexpr int kDj = D / 16;
  constexpr int ld = D + 1;
  constexpr int pld = kTile + 1;
  const int n = a.n;
  const int nk = window_keys(n, a.banded);
  extern __shared__ float smem[];
  float* ks = smem;  // key tile, normalised
  float* vs = ks + kTile * ld;
  float* qs = vs + kTile * ld;
  float* dos = qs + kTile * ld;
  float* kfac = dos + kTile * ld;  // 64 floats, padded to a tile
  float* gs = kfac + kTile * ld;   // dcos, [query][key]
  float* pr = gs + kTile * pld;    // p rounded to the working type
  float* vec = pr + kTile * pld;   // m | l | delta of the query tile

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kTile;
  const int rb = key_begin(k0, a.banded);  // the rows whose window holds k0
  const int nr = window_keys(n, a.banded);
  const Slices<T, D> sl(a, b, h);
  const float* tm = a.tmpl + static_cast<size_t>(h) * n * nk;
  const float scale = a.scale[h];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  load_rows<T, D>(ks, sl.q + sl.c, sl.stride, k0, n);
  load_rows<T, D>(vs, sl.q + 2 * sl.c, sl.stride, k0, n);
  __syncthreads();
  normalise_rows<D>(ks, kfac);

  float dk[4][kDj], dv[4][kDj];  // keys k0 + ty + 16i, dims tx + 16j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDj; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = rb; q0 < rb + nr; q0 += kTile) {
    __syncthreads();  // the previous query tile consumed
    load_queries<T, D>(a, sl, b, h, q0, rb + nr, qs, dos, vec);
    __syncthreads();
    float cs[4][4], dp[4][4];
    tile_dot<D>(qs, ks, tx, ty, cs);
    tile_dot<D>(dos, vs, tx, ty, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
      const int kbr = key_begin(row, a.banded);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float g = 0.f, p = 0.f;
        if (row < rb + nr && key < n) {
          const float t = tm[static_cast<size_t>(row) * nk + (key - kbr)];
          p = expf(logit(cs[i][j], scale, t) - vec[r]) / vec[kTile + r];
          g = p * (dp[i][j] - vec[2 * kTile + r]) * scale;
        }
        gs[r * pld + tx + 16 * j] = g;
        pr[r * pld + tx + 16 * j] = Io<T>::round(p);
      }
    }
    __syncthreads();
    const int qn = min(kTile, rb + nr - q0);
    for (int r = 0; r < qn; ++r) {
      float g[4], p[4], qd[kDj], od[kDj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        g[i] = gs[r * pld + ty + 16 * i];
        p[i] = pr[r * pld + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < kDj; ++j) {
        qd[j] = qs[r * ld + tx + 16 * j];
        od[j] = dos[r * ld + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDj; ++j) {
          dk[i][j] = fmaf(g[i], qd[j], dk[i][j]);
          dv[i][j] = fmaf(p[i], od[j], dv[i][j]);
        }
    }
  }

  // dk = (dk^ - k^ <k^, dk^>) * kfac
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kDj; ++j)
      dot = fmaf(ks[r * ld + tx + 16 * j], dk[i][j], dot);
    dot = row_sum16(dot);
    const int key = k0 + r;
    if (key >= n) continue;
    T* dst = sl.dq + static_cast<size_t>(key) * sl.stride;
#pragma unroll
    for (int j = 0; j < kDj; ++j) {
      const float kn = ks[r * ld + tx + 16 * j];
      Io<T>::store(dst + sl.c + tx + 16 * j, (dk[i][j] - kn * dot) * kfac[r]);
      Io<T>::store(dst + 2 * sl.c + tx + 16 * j, dv[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. template: d_template summed over the batch, d_scale partials
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t tmpl_smem_bytes() {
  return (4 * kTile * (D + 1) + 3 * kTile + kThreads / 32) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) window_attention_bwd_tmpl_kernel(
    const BwdArgs a) {
  constexpr int ld = D + 1;
  const int n = a.n;
  const int nk = window_keys(n, a.banded);
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * ld;
  float* ks = dos + kTile * ld;
  float* vs = ks + kTile * ld;
  float* vec = vs + kTile * ld;     // m | l | delta of the query tile
  float* red = vec + 3 * kTile;     // one d_scale sum per warp

  const int r0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * kTile;  // first key of the tile, in the window
  const int h = blockIdx.z;
  const int kb = key_begin(r0, a.banded);
  const float* tm = a.tmpl + static_cast<size_t>(h) * n * nk;
  float* dtm = a.dtmpl + static_cast<size_t>(h) * n * nk;
  const float scale = a.scale[h];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float t[4][4], acc[4][4];
  bool ok[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = r0 + ty + 16 * i;
      const int col = c0 + tx + 16 * j;
      ok[i][j] = row < n && col < nk;
      t[i][j] = ok[i][j] ? tm[static_cast<size_t>(row) * nk + col] : 0.f;
      acc[i][j] = 0.f;
    }
  float ds = 0.f;

  for (int b = 0; b < a.batch; ++b) {
    const Slices<T, D> sl(a, b, h);
    __syncthreads();  // the previous sample's tiles consumed
    load_rows<T, D>(ks, sl.q + sl.c, sl.stride, kb + c0, kb + nk);
    load_rows<T, D>(vs, sl.q + 2 * sl.c, sl.stride, kb + c0, kb + nk);
    load_queries<T, D>(a, sl, b, h, r0, n, qs, dos, vec);
    normalise_rows<D>(ks, nullptr);
    __syncthreads();
    float cs[4][4], dp[4][4];
    tile_dot<D>(qs, ks, tx, ty, cs);
    tile_dot<D>(dos, vs, tx, ty, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!ok[i][j]) continue;
        const float p =
            expf(logit(cs[i][j], scale, t[i][j]) - vec[r]) / vec[kTile + r];
        const float g = p * (dp[i][j] - vec[2 * kTile + r]);
        acc[i][j] += g;
        ds = fmaf(g, cs[i][j], ds);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ok[i][j])
        dtm[static_cast<size_t>(r0 + ty + 16 * i) * nk + c0 + tx + 16 * j] =
            acc[i][j];
  ds = warp_sum(ds);
  if ((tid & 31) == 0) red[tid >> 5] = ds;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
    // one partial per (query tile, key tile) of the head
    a.ds_part[static_cast<size_t>(h) * gridDim.x * gridDim.y +
              blockIdx.x * gridDim.y + blockIdx.y] = s;
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, dim3 grid, size_t smem,
                       const BwdArgs& a, cudaStream_t stream) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const int tiles = (a.n + kTile - 1) / kTile;
  const dim3 per_sample(tiles, a.num_heads, a.batch);
  cudaError_t err = launch_one(window_attention_bwd_rows_kernel<T, D>,
                               per_sample, rows_smem_bytes<D>(a.n, a.banded),
                               a, stream);
  if (err != cudaSuccess) return err;
  err = launch_one(window_attention_bwd_cols_kernel<T, D>, per_sample,
                   cols_smem_bytes<D>(), a, stream);
  if (err != cudaSuccess) return err;
  const dim3 tmpl_grid(tiles, partials(a.n, a.banded) / tiles, a.num_heads);
  return launch_one(window_attention_bwd_tmpl_kernel<T, D>, tmpl_grid,
                    tmpl_smem_bytes<D>(), a, stream);
}

}  // namespace

// The number of d_scale partials per head the backward writes, and the bytes
// of the scratch it needs.
extern "C" int tpat_window_attention_bwd_partials(int n, int banded) {
  return partials(n, banded);
}

extern "C" long long tpat_window_attention_bwd_scratch_bytes(int batch, int n,
                                                             int num_heads) {
  return static_cast<long long>(scratch_bytes(batch, n, num_heads));
}

// dtype: 0 = float32, 1 = bfloat16.  qkv: (batch, n, 3 C) contiguous;
// scale: (num_heads,) f32; tmpl: (num_heads, n, n) f32 (banded = 0) or
// (num_heads, n, 128) f32 with n % 128 == 0 (banded = 1); dout: (batch, n, C)
// in qkv's dtype.  bf16 only at a dense grid that window_attention_dense.cu
// does not take.  Writes dqkv (batch, n, 3 C) in qkv's dtype, dtmpl (the
// template's shape, f32, summed over the batch) and ds_part (num_heads,
// tpat_window_attention_bwd_partials(...)) f32, whose rows sum to d_scale;
// scratch holds tpat_window_attention_bwd_scratch_bytes(...) bytes, 256-byte
// aligned.  Launches the rows, cols and template kernels in turn on
// `stream`, synchronises nothing, and returns the first CUDA error (0 on
// success).
extern "C" int tpat_window_attention_bwd(
    const void* qkv, const void* scale, const void* tmpl, const void* dout,
    void* dqkv, void* scratch, void* dtmpl, void* ds_part, int batch, int n,
    int num_heads, int head_dim, int dtype, int banded, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || num_heads < 1 ||
      num_heads > 65535 || (banded != 0 && banded != 1) ||
      (banded && n % kChunk != 0) || qkv == nullptr || scale == nullptr ||
      tmpl == nullptr || dout == nullptr || dqkv == nullptr ||
      scratch == nullptr || dtmpl == nullptr || ds_part == nullptr) {
    return cudaErrorInvalidValue;
  }
  const BwdArgs a{qkv, static_cast<const float*>(scale),
                  static_cast<const float*>(tmpl), dout, dqkv,
                  static_cast<float*>(scratch), static_cast<float*>(dtmpl),
                  static_cast<float*>(ds_part), batch, n, num_heads, banded};
  const auto s = static_cast<cudaStream_t>(stream);
  // head_dim 32 only: the MAE decoder's 512 / 16, the one width the path
  // runs; bf16 only where the Hopper sources take no call
  if (head_dim != 32 || (dtype == 1 && (banded || dense_takes(n))))
    return cudaErrorInvalidValue;
  if (dtype == 0) return launch<float, 32>(a, s);
  if (dtype == 1) return launch<__nv_bfloat16, 32>(a, s);
  return cudaErrorInvalidValue;
}
