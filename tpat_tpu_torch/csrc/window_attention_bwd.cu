// Fused swin_v2_cr window attention, backward, for Hopper (sm_90a): the dense
// and the banded form in one set of kernel bodies.
//
// Replaces tpat_tpu/ops/pallas_window_attention.py::_bwd_kernel (dense, via
// _fused_bwd_impl) and ::_banded_bwd_kernel (banded, via _banded_bwd_impl),
// the TPU kernels the custom VJPs of fused_window_attention and
// fused_window_attention_banded run in every decoder block of an MAE
// pretrain step.
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
// batch is taken as per-sample partials summed afterwards in a fixed order:
// no floating-point atomics, the same bits from run to run.
//
// What bounds it.  At the ESC-50 decoder (B = 32, H = 16, D = 32, N = 256,
// bf16) a call must read qkv 25.2 MB, dO 8.4 MB and the template 4.2 MB and
// write d_qkv 25.2 MB and d_template 4.2 MB: 67 MB, about 20 us at
// 3.35 TB/s.  The useful work is 10 D FLOPs per live pair (one whose
// template entry is not the -1e30 exclusion), a few us on the tensor cores.
// At the AudioSet decoder (N = 512, banded) about 126 MB, 38 us.
//
// bf16 (every pretrain step), one tensor-core design for both forms, whose
// live map, staging, split and stats sweep are window_attention_tc.cuh's,
// shared with the forward.  A CTA takes one (window unit, head, sample):
// the unit is the row's whole key window, the grid (dense, N <= 256) or one
// 128-token chunk (banded), so its queries are its keys and it writes dq,
// dk and dv complete.  One warp per 16 rows of the unit (W <= 256 rows: at
// most 16 warps).
//   0. live: one CTA per (unit, head, 16 queries) marks each 16 x 16 block
//      that holds a template entry above -1e29.  A block with none has
//      p = 0 exactly, so dlog = 0 and it adds exact zeros to every sum:
//      the kernels skip it, and its d_template is written 0.  (A query
//      block with a row that has no live entry at all, where p is uniform,
//      is kept whole.)  Window-major chunks hold whole windows of 16
//      tokens, so a banded chunk keeps 8 of its 64 blocks; the ESC-50 grid
//      (32 x 8 tokens, 4 x 4 windows) keeps 2 key blocks of each query
//      block's 16, either shift.
//   1. main: stage q, k, v, dO (16-byte cp.async), normalise q and k in
//      f32 and split each into hi = bf16(x^) and lo = bf16(x^ - hi).  The
//      three products whose operands are f32 in the TPU kernel (cos, dq^,
//      dk^) run as three bf16 mma.sync m16n8k16 terms, hi.hi + hi.lo +
//      lo.hi, with f32 accumulation; dp and dv are single bf16 products, as
//      on the TPU.  Per sample the logits and dp are computed twice:
//      a. stats sweep, warp w on query block w: cos and dp over the live
//         key blocks, the row max m, sum l and D_run = sum exp(s - m) dp
//         online (rescaled as l is), so delta = D_run / l;
//      b. gradient sweep, warp w on key block w, the products taken with
//         the keys as the A operand (cos^T = k^.q^T, dp^T = v.dO^T) so that
//         p^T and dlog^T come out in the accumulator layout of the warp's
//         16 keys: dv += round(p)^T.dO and dk^ += dcos^T.q^ straight from
//         registers.  dq^ += dcos.k^ takes the same fragments transposed by
//         movmatrix into an f32 accumulator of the query block in shared
//         memory; at step t warp w takes query block (w + t) mod nb, so no
//         two warps touch one block in a step (a barrier between steps).
//      It writes dlog of its live blocks into a per-sample (B, H, N, W)
//      f32 partial and one d_scale partial per CTA.
//   2. template sum: d_template[h] = sum over b of the partials, in batch
//      order, on the live blocks; 0 elsewhere.
// f32 (the parity checks at 1e-4 of the largest gradient): tensor-core f32
// would be TF32, so it keeps exact FMA kernels on f32 tiles with 4 x 4
// register micro-tiles (as does bf16 at a dense grid over 256 tokens, which
// no model path runs), three in turn:
//   1. rows: one CTA per (b, h, 64-query tile): the exact softmax of the
//      tile's whole window in shared memory, delta, then dlog and dq; writes
//      dq and the f32 (B, H, 3, N) scratch [m | l | delta].
//   2. cols: one CTA per (b, h, 64-key tile): walks the query tiles whose
//      window holds its keys, recomputes p and dlog, sums dk^ and dv.
//   3. template: one CTA per (h, 64-query tile, 64-key tile of the window):
//      loops over the batch in order for d_template, and writes one d_scale
//      partial.

#include <cstdint>

#include "attention_mma.cuh"
#include "window_attention_common.cuh"
#include "window_attention_tc.cuh"

namespace {

using namespace window_attention;

struct BwdArgs {
  const void* qkv;
  const float* scale;
  const float* tmpl;
  const void* dout;
  void* dqkv;
  float* stats;  // FMA kernels: (B, H, 3, N) m | l | delta
  unsigned char* live;  // tensor cores: (H, units, nb, nb) live blocks
  float* part;   // tensor cores: (B, H, N, W) per-sample dlog
  float* dtmpl;
  float* ds_part;  // (H, partials)
  int batch, n, num_heads, banded;
};

// d_scale partials per head: tensor cores one per (sample, unit); FMA one
// per template CTA (64-query tiles times the 64-key tiles of a window).
int partials(int batch, int n, int banded, int dtype) {
  if (tensor_cores(n, dtype, banded)) return batch * units(n, banded);
  const int row_tiles = (n + kTile - 1) / kTile;
  const int key_tiles = banded ? kChunk / kTile : row_tiles;
  return row_tiles * key_tiles;
}

size_t scratch_bytes(int batch, int n, int num_heads, int dtype, int banded) {
  if (tensor_cores(n, dtype, banded))
    return live_bytes(n, num_heads, banded) +
           static_cast<size_t>(batch) * num_heads * n *
               window_keys(n, banded) * sizeof(float);
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
// bf16 on the tensor cores: live blocks, main, template sum
// ---------------------------------------------------------------------------

// Shared memory of the main kernel for R = 16 nb staged rows: six bf16 tiles
// (q^ hi, q^ lo, k^ hi, k^ lo, v, dO; rows padded to 40 values), the f32 dq^
// accumulator of each query block in fragment order, five per-row vectors
// (m, 1/l, delta, and the q and k normalisation factors), one d_scale sum
// per warp and the live map.
template <int D>
size_t bwd_smem_bytes(int nb) {
  const int rows = nb * kBlk;
  return 6 * TcSmem<D>::tile(rows) + static_cast<size_t>(rows) * D * 4 +
         5 * static_cast<size_t>(rows) * 4 + kBlk * 4 + nb * nb;
}

// acc += (A_hi + A_lo) . (tile_hi + tile_lo)[k0 .. k0 + 16) without lo.lo.
template <int D>
__device__ __forceinline__ void split_nn(float acc[D / 8][4],
                                         const uint32_t ahi[4],
                                         const uint32_t alo[4],
                                         const mma::bf16* thi,
                                         const mma::bf16* tlo, int k0,
                                         int lane) {
  mma::product_nn<D>(acc, ahi, thi, k0, lane);
  mma::product_nn<D>(acc, ahi, tlo, k0, lane);
  mma::product_nn<D>(acc, alo, thi, k0, lane);
}

// The F.normalize VJP of a warp's 16 rows from row r0 of the staged x^
// (hi + lo) in the accumulator layout, g <- (g - x^ <x^, g>) * fac[row],
// then stored as bf16 rows of dst; rows at or past `valid` are skipped.
template <int D>
__device__ __forceinline__ void store_normalised(
    mma::bf16* dst, size_t stride, float g[D / 8][4], const mma::bf16* xhi,
    const mma::bf16* xlo, const float* fac, int r0, int valid, int lane) {
  constexpr int ld = TcSmem<D>::kLd;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + (lane >> 2) + 8 * i;
    float xs[D / 8][2];
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int at = r * ld + 8 * j + t2 + e;
        xs[j][e] = __bfloat162float(xhi[at]) + __bfloat162float(xlo[at]);
        dot = fmaf(xs[j][e], g[j][2 * i + e], dot);
      }
    dot = mma::quad_sum(dot);
    const float f = fac[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        g[j][2 * i + e] = (g[j][2 * i + e] - xs[j][e] * dot) * f;
  }
  mma::store_rows<D>(dst, stride, g, r0, valid, 1.f, lane);
}

// 1. main: one CTA per (unit, head, sample), 32 nb threads.
template <int D>
__global__ void __launch_bounds__(32 * kMaxWindow / kBlk)
    window_attention_bwd_bf16_kernel(const BwdArgs a) {
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
  bf16* dot = reinterpret_cast<bf16*>(smem_raw + 5 * tb);
  // dq^ accumulator, [query block][register][lane]
  float* dqa = reinterpret_cast<float*>(smem_raw + 6 * tb);
  float* mrow = dqa + rows * D;
  float* irow = mrow + rows;  // 1 / l
  float* drow = irow + rows;  // delta
  float* qfac = drow + rows;
  float* kfac = qfac + rows;
  float* red = kfac + rows;
  unsigned char* live = reinterpret_cast<unsigned char*>(red + kBlk);

  const bf16* q_src = static_cast<const bf16*>(a.qkv) +
                      (static_cast<size_t>(b) * n + row0) * stride +
                      static_cast<size_t>(h) * D;
  const bf16* do_src = static_cast<const bf16*>(a.dout) +
                       (static_cast<size_t>(b) * n + row0) * c +
                       static_cast<size_t>(h) * D;
  stage_rows<D>(qhi, q_src, stride, w, rows);
  stage_rows<D>(khi, q_src + c, stride, w, rows);
  stage_rows<D>(vt, q_src + 2 * c, stride, w, rows);
  stage_rows<D>(dot, do_src, c, w, rows);
  mma::cp_async_commit();
  const unsigned char* live_src =
      a.live + (static_cast<size_t>(h) * gridDim.x + unit) * nb * nb;
  for (int i = threadIdx.x; i < nb * nb; i += blockDim.x) live[i] = live_src[i];
  mma::cp_async_wait<0>();
  __syncthreads();
  {  // one thread per row of q (threads [0, rows)) and of k
    const int r = threadIdx.x % rows;
    if (threadIdx.x < rows)
      qfac[r] = split_row<D>(qhi + r * ld, qlo + r * ld);
    else
      kfac[r] = split_row<D>(khi + r * ld, klo + r * ld);
  }
  __syncthreads();

  const float* tm = a.tmpl + (static_cast<size_t>(h) * n + row0) * w;
  float* part = a.part +
                ((static_cast<size_t>(b) * a.num_heads + h) * n + row0) * w;
  const float scale = a.scale[h];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;

  // a. stats sweep: warp on query block `warp`
  {
    const int qb = warp;
    uint32_t ah[D / 16][4], al[D / 16][4], da[D / 16][4];
    mma::load_a<D>(ah, qhi, qb * kBlk, lane);
    mma::load_a<D>(al, qlo, qb * kBlk, lane);
    mma::load_a<D>(da, dot, qb * kBlk, lane);
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float d_run[2] = {0.f, 0.f};
    for (int kb = 0; kb < nb; ++kb) {
      if (!live[qb * nb + kb]) continue;
      float s[2][4], dp[2][4], alpha[2];
      row_logits<D>(s, ah, al, khi, klo, tm, scale, w, qb, kb, lane);
      mma::product_nt<D>(dp, da, vt, kb * kBlk, lane);
      online_block(s, m, l, alpha);  // s becomes exp(s - m)
#pragma unroll
      for (int i = 0; i < 2; ++i) d_run[i] *= alpha[i];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d_run[e >> 1] = fmaf(s[j][e], dp[j][e], d_run[e >> 1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l_row = mma::quad_sum(l[i]);
      const float d_row = mma::quad_sum(d_run[i]);
      if ((lane & 3) == 0) {
        const int row = qb * kBlk + g + 8 * i;
        mrow[row] = m[i];
        irow[row] = 1.f / l_row;
        drow[row] = d_row / l_row;
      }
    }
    for (int i = 0; i < D / 2; ++i) dqa[(qb * kBlk * D) + i * 32 + lane] = 0.f;
  }
  __syncthreads();

  // b. gradient sweep: warp on key block `warp`
  const int kb = warp;
  uint32_t ah[D / 16][4], al[D / 16][4], va[D / 16][4];
  mma::load_a<D>(ah, khi, kb * kBlk, lane);
  mma::load_a<D>(al, klo, kb * kBlk, lane);
  mma::load_a<D>(va, vt, kb * kBlk, lane);
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  float ds = 0.f;
  for (int t = 0; t < nb; ++t) {
    const int qb = kb + t < nb ? kb + t : kb + t - nb;
    if (live[qb * nb + kb]) {
      float s[2][4], dp[2][4];
      split_nt<D>(s, ah, al, qhi, qlo, qb * kBlk, lane);  // cos^T
      mma::product_nt<D>(dp, va, dot, qb * kBlk, lane);   // dp^T
      float p[2][4], gh[2][4], gl[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kb * kBlk + g + 8 * (e >> 1);
          const int q = qb * kBlk + 8 * j + t2 + (e & 1);
          float pv = 0.f, dl = 0.f;
          if (key < w && q < w) {
            const size_t at = static_cast<size_t>(q) * w + key;
            pv = expf(logit(s[j][e], scale, tm[at]) - mrow[q]) * irow[q];
            dl = pv * (dp[j][e] - drow[q]);
            part[at] = dl;
            ds = fmaf(dl, s[j][e], ds);
          }
          const float dc = dl * scale;
          p[j][e] = pv;
          gh[j][e] = dc;
          gl[j][e] = dc - __bfloat162float(__float2bfloat16(dc));
        }
      uint32_t pa[4], gha[4], gla[4];
      mma::to_a(pa, p);
      mma::to_a(gha, gh);
      mma::to_a(gla, gl);
      mma::product_nn<D>(dv, pa, dot, qb * kBlk, lane);
      split_nn<D>(dk, gha, gla, qhi, qlo, qb * kBlk, lane);
      uint32_t tha[4], tla[4];  // dcos of (queries, keys)
      mma::transpose_a(tha, gha);
      mma::transpose_a(tla, gla);
      float* acc_s = dqa + qb * kBlk * D + lane;
      float acc[D / 8][4];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = acc_s[(4 * j + e) * 32];
      split_nn<D>(acc, tha, tla, khi, klo, kb * kBlk, lane);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_s[(4 * j + e) * 32] = acc[j][e];
    }
    __syncthreads();  // query block ownership moves on
  }

  bf16* dst = static_cast<bf16*>(a.dqkv) +
              (static_cast<size_t>(b) * n + row0) * stride +
              static_cast<size_t>(h) * D;
  store_normalised<D>(dst + c, stride, dk, khi, klo, kfac, kb * kBlk, w, lane);
  mma::store_rows<D>(dst + 2 * c, stride, dv, kb * kBlk, w, 1.f, lane);
  {
    const int qb = warp;
    const float* acc_s = dqa + qb * kBlk * D + lane;
    float dq[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[j][e] = acc_s[(4 * j + e) * 32];
    store_normalised<D>(dst, stride, dq, qhi, qlo, qfac, qb * kBlk, w, lane);
  }
  ds = warp_sum(ds);
  if (lane == 0) red[warp] = ds;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int i = 0; i < nb; ++i) sum += red[i];
    a.ds_part[static_cast<size_t>(h) * a.batch * gridDim.x +
              static_cast<size_t>(b) * gridDim.x + unit] = sum;
  }
}

// 2. template sum: d_template = sum over the batch of the partials, in batch
// order, on the live blocks; 0 on the others.  One thread per entry.
__global__ void __launch_bounds__(kThreads)
    window_attention_bwd_tmpl_sum_kernel(const BwdArgs a) {
  const int n = a.n;
  const int w = window_keys(n, a.banded);
  const int nb = blocks(n, a.banded);
  const size_t plane = static_cast<size_t>(n) * w;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= a.num_heads * plane) return;
  const int h = static_cast<int>(idx / plane);
  const int row = static_cast<int>((idx - h * plane) / w);
  const int key = static_cast<int>(idx % w);
  const int unit = a.banded ? row / kChunk : 0;
  const int r = row - (a.banded ? unit * kChunk : 0);
  const bool is_live =
      a.live[((static_cast<size_t>(h) * units(n, a.banded) + unit) * nb +
              r / kBlk) * nb + key / kBlk] != 0;
  float sum = 0.f;
  if (is_live)
#pragma unroll 8
    for (int b = 0; b < a.batch; ++b)
      sum += a.part[static_cast<size_t>(b) * a.num_heads * plane + idx];
  a.dtmpl[idx] = sum;
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
  const dim3 tmpl_grid(tiles, partials(a.batch, a.n, a.banded, 0) / tiles,
                       a.num_heads);
  return launch_one(window_attention_bwd_tmpl_kernel<T, D>, tmpl_grid,
                    tmpl_smem_bytes<D>(), a, stream);
}

template <int D>
cudaError_t launch_bf16(const BwdArgs& a, cudaStream_t stream) {
  const int u = units(a.n, a.banded);
  const int nb = blocks(a.n, a.banded);
  cudaError_t err =
      launch_live(a.tmpl, a.live, a.n, a.num_heads, a.banded, stream);
  if (err != cudaSuccess) return err;
  auto kernel = window_attention_bwd_bf16_kernel<D>;
  const size_t smem = bwd_smem_bytes<D>(nb);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(u, a.num_heads, a.batch), 32 * nb, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t entries =
      static_cast<size_t>(a.num_heads) * a.n * window_keys(a.n, a.banded);
  auto sum = window_attention_bwd_tmpl_sum_kernel;
  sum<<<static_cast<unsigned>((entries + kThreads - 1) / kThreads), kThreads,
        0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The number of d_scale partials per head the backward writes, and the bytes
// of the scratch it needs.
extern "C" int tpat_window_attention_bwd_partials(int batch, int n, int banded,
                                                  int dtype) {
  return partials(batch, n, banded, dtype);
}

extern "C" long long tpat_window_attention_bwd_scratch_bytes(
    int batch, int n, int num_heads, int dtype, int banded) {
  return static_cast<long long>(
      scratch_bytes(batch, n, num_heads, dtype, banded));
}

// dtype: 0 = float32, 1 = bfloat16.  qkv: (batch, n, 3 C) contiguous;
// scale: (num_heads,) f32; tmpl: (num_heads, n, n) f32 (banded = 0) or
// (num_heads, n, 128) f32 with n % 128 == 0 (banded = 1); dout: (batch, n, C)
// in qkv's dtype.  Writes dqkv (batch, n, 3 C) in qkv's dtype, dtmpl (the
// template's shape, f32, summed over the batch) and ds_part (num_heads,
// tpat_window_attention_bwd_partials(...)) f32, whose rows sum to d_scale;
// scratch holds tpat_window_attention_bwd_scratch_bytes(...) bytes, 256-byte
// aligned.  Launches its kernels in turn on `stream` (bf16 at a window of up
// to 256 keys: live, main, template sum; else the FMA rows, cols,
// template), synchronises nothing, and returns the first CUDA error (0 on
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
  const bool tc = tensor_cores(n, dtype, banded);
  auto* bytes = static_cast<unsigned char*>(scratch);
  const BwdArgs a{qkv, static_cast<const float*>(scale),
                  static_cast<const float*>(tmpl), dout, dqkv,
                  tc ? nullptr : reinterpret_cast<float*>(bytes),
                  tc ? bytes : nullptr,
                  tc ? reinterpret_cast<float*>(
                           bytes + live_bytes(n, num_heads, banded))
                     : nullptr,
                  static_cast<float*>(dtmpl), static_cast<float*>(ds_part),
                  batch, n, num_heads, banded};
  const auto s = static_cast<cudaStream_t>(stream);
  // head_dim 32 only: the MAE decoder's 512 / 16, the one width the path runs
  if (head_dim != 32) return cudaErrorInvalidValue;
  if (tc) return launch_bf16<32>(a, s);
  if (dtype == 0) return launch<float, 32>(a, s);
  if (dtype == 1) return launch<__nv_bfloat16, 32>(a, s);
  return cudaErrorInvalidValue;
}
