// Backward of the fused packed-qkv attention, for Hopper (sm_90a).
//
// Replaces tpat_tpu/ops/pallas_attention.py::_qkv_bwd_kernel, the TPU
// kernel the custom VJPs of fused_qkv_attention and
// fused_qkv_attention_prefix run in every block of every train step.
//
// What it computes, per (batch b, head h), from the packed (B, N, 3C) qkv,
// the output cotangent dO (B, N, C) and an optional score cotangent ds
// (B, N) f32, already pre-scaled and zero on the extra tokens by the wrapper:
//   p     = softmax(q . k^T * D^-1/2) in f32 over the keys [0, kv_valid),
//           normalised by a reciprocal multiply (keys past kv_valid: p = 0);
//   dp    = dO . v^T in f32 from the working-type operands, plus ds[key] on
//           the rows the score reads ('patch_mean': [extra, kv_valid);
//           'cls': row 0);
//   dlog  = p (dp - sum_k dp p), in f32, rounded to the working type;
//   dq    = (dlog . k) * D^-1/2, dk = (dlog^T . q) * D^-1/2, accumulated in
//           f32 and rounded once;
//   dv    = (p rounded to the working type)^T . dO;
// written into the packed (B, N, 3C) layout [dq | dk | dv], as the TPU kernel
// writes them.  The rounding points are the TPU kernel's.
//
// What is different on Hopper, and the design.  dk and dv are sums over every
// query row; on the TPU one grid step holds the whole (N, N) tile of a head,
// but CTAs on the card run in no order.  So, with no atomics and nothing
// (B, H, N, N) in HBM, two kernels run in turn on the stream:
//   1. rows: one CTA per (b, h, 64-row query tile).  It writes dq and the
//      f32 (B, H, 3, N) scratch [m | 1/l | delta].
//   2. cols: one CTA per (b, h, 64-key tile).  It holds its K and V tiles,
//      walks every query tile, recomputes p from m and 1/l and dp, and
//      accumulates dk and dv in registers; it writes them once.  Key tiles
//      wholly past kv_valid write zeros.
// Deterministic: every sum has one owner and a fixed order.
//
// bf16 (every path of the model): the bound is bytes (0.98 ms per b128
// hybrid-0.8 step, against ~10 N^2 D FLOPs that the tensor cores do in a
// fraction of it), so every product runs as mma.sync m16n8k16 with f32
// accumulation on bf16 tiles staged by 16-byte cp.async into padded rows,
// the streamed tiles double-buffered (attention_mma.cuh).  Four warps, each
// owning 16 rows of the CTA's tile; keys (rows kernel) or queries (cols
// kernel) are processed 16 at a time.
//   rows: two sweeps over the keys.  Sweep 1 computes s = q.k^T and
//     dp = dO.v^T and keeps m, l and the unnormalised D_run = sum_k
//     exp(s - m) dp_k online (D_run is rescaled by exp(m_old - m_new) as l
//     is), so delta = D_run / l at its end.  Sweep 2 recomputes s and dp,
//     forms dlog on the accumulator fragments and feeds it, rounded to bf16,
//     as the A operand of dq += dlog.k (k read transposed by ldmatrix).
//     The Q and dO fragments stay in registers.
//   cols: the products are taken with the key tile as the A operand:
//     s^T = k.q^T and dp^T = v.dO^T, so p^T and dlog^T come out in the
//     accumulator layout of the warp's 16 keys and, rounded to bf16, are the
//     A operands of dv += round(p)^T.dO and dk += dlog^T.q straight from
//     registers (dO and q read transposed by ldmatrix), with no trip through
//     shared memory.  Each logit is the same exact bf16 products summed over
//     the same k-steps in the same order as in the rows kernel (the one
//     product_nt code with the operands' roles swapped).
// f32 (the parity checks, held to plain at 1e-4 of the largest gradient):
// tensor-core f32 would be TF32, so it stays on exact FMA loops with 4 x 4
// register micro-tiles over f32 tiles in shared memory; its rows kernel
// sweeps the keys three times (m and l; delta; dlog and dq).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "attention_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // query rows or keys per CTA and per streamed tile
constexpr int kModeNone = 0;
constexpr int kModePatchMean = 1;
constexpr int kModeCls = 2;

// The FMA kernels' loads, stores and rounding: f32 only (bf16 runs the
// tensor-core kernels below).
template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

// Shared-memory layout in floats: four staged (64, D) tiles with rows padded
// by one float, two (64, 64) tiles, and four 64-vectors.
template <int D>
struct Smem {
  static constexpr int kLd = D + 1;
  static constexpr int kPLd = kTile + 1;
  static constexpr int kA = 0;
  static constexpr int kB = kA + kTile * kLd;
  static constexpr int kC = kB + kTile * kLd;
  static constexpr int kD = kC + kTile * kLd;
  static constexpr int kP = kD + kTile * kLd;
  static constexpr int kP2 = kP + kTile * kPLd;
  static constexpr int kVec = kP2 + kTile * kPLd;
  static constexpr int kFloats = kVec + 4 * kTile;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// Rows [r0, r0 + 64) of one head's slice into shared memory as f32; rows
// past n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          size_t row_stride, int r0, int n) {
  constexpr int ld = Smem<D>::kLd;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int row = r0 + r;
    dst[r * ld + d] =
        row < n ? Io<T>::load(src + static_cast<size_t>(row) * row_stride + d)
                : 0.f;
  }
}

// The thread's 4 x 4 products of rows ty + 16i of a against rows tx + 16j
// of b, f32 accumulation in d order.  The logits are this times the scale,
// computed by the same code in both kernels.
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int tx, int ty, float out[4][4]) {
  constexpr int ld = Smem<D>::kLd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(x[i], y[j], out[i][j]);
  }
}

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

// Whether query row `row` receives the score cotangent.
__device__ __forceinline__ bool score_row(int row, int mode, int extra,
                                          int kv_valid) {
  if (mode == kModePatchMean) return row >= extra && row < kv_valid;
  if (mode == kModeCls) return row == 0;
  return false;
}

struct Args {
  const void* qkv;
  const void* dout;
  const float* ds;
  void* dqkv;
  float* stats;
  int n, num_heads, mode, extra, kv_valid;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    qkv_attention_bwd_rows_kernel(const Args a) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  using S = Smem<D>;
  constexpr int kDj = D / 16;
  extern __shared__ float smem[];
  float* qs = smem + S::kA;
  float* dos = smem + S::kB;
  float* ks = smem + S::kC;
  float* vs = smem + S::kD;
  float* ps = smem + S::kP;

  const int n = a.n;
  const int kv = a.kv_valid;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = a.num_heads * D;
  const size_t qkv_stride = 3 * static_cast<size_t>(c);
  const T* q_src = static_cast<const T*>(a.qkv) +
                   static_cast<size_t>(b) * n * qkv_stride +
                   static_cast<size_t>(h) * D;
  const T* k_src = q_src + c;
  const T* v_src = q_src + 2 * c;
  const T* do_src = static_cast<const T*>(a.dout) +
                    static_cast<size_t>(b) * n * c + static_cast<size_t>(h) * D;
  const float* ds = a.ds == nullptr ? nullptr : a.ds + static_cast<size_t>(b) * n;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kTile;

  load_rows<T, D>(qs, q_src, qkv_stride, q0, n);
  load_rows<T, D>(dos, do_src, c, q0, n);

  // pass 1: running row max and denominator over the valid keys
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < kv; k0 += kTile) {
    __syncthreads();
    load_rows<T, D>(ks, k_src, qkv_stride, k0, n);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(qs, ks, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < kv) mt = fmaxf(mt, s[i][j] * a.scale);
      const float m_new = fmaxf(m[i], row_max(mt));  // key 0 is valid
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < kv) sum += expf(s[i][j] * a.scale - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum(sum);
      m[i] = m_new;
    }
  }
  float inv[4];
  bool srow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    inv[i] = 1.f / l[i];
    srow[i] = ds != nullptr &&
              score_row(q0 + ty + 16 * i, a.mode, a.extra, kv);
  }

  // pass 2: delta = sum_k dp p per row
  float delta[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < kv; k0 += kTile) {
    __syncthreads();
    load_rows<T, D>(ks, k_src, qkv_stride, k0, n);
    load_rows<T, D>(vs, v_src, qkv_stride, k0, n);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(qs, ks, tx, ty, s);
    tile_dot<D>(dos, vs, tx, ty, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      if (key >= kv) continue;
      const float dsk = ds == nullptr ? 0.f : ds[key];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[i][j] * a.scale - m[i]) * inv[i];
        delta[i] = fmaf(srow[i] ? dp[i][j] + dsk : dp[i][j], p, delta[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) delta[i] = row_sum(delta[i]);

  // pass 3: the dlog tile and dq
  float acc[4][kDj];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDj; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < kv; k0 += kTile) {
    __syncthreads();
    load_rows<T, D>(ks, k_src, qkv_stride, k0, n);
    load_rows<T, D>(vs, v_src, qkv_stride, k0, n);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(qs, ks, tx, ty, s);
    tile_dot<D>(dos, vs, tx, ty, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const float dsk = ds == nullptr || key >= kv ? 0.f : ds[key];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float g = 0.f;
        if (key < kv) {
          const float p = expf(s[i][j] * a.scale - m[i]) * inv[i];
          const float dpv = srow[i] ? dp[i][j] + dsk : dp[i][j];
          g = Io<T>::round(p * (dpv - delta[i]));
        }
        ps[(ty + 16 * i) * S::kPLd + tx + 16 * j] = g;
      }
    }
    __syncthreads();
    const int kn = min(kTile, kv - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float g[4], kd[kDj];
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = ps[(ty + 16 * i) * S::kPLd + kk];
#pragma unroll
      for (int j = 0; j < kDj; ++j) kd[j] = ks[kk * S::kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDj; ++j) acc[i][j] = fmaf(g[i], kd[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    T* dst = static_cast<T*>(a.dqkv) + static_cast<size_t>(b) * n * qkv_stride +
             static_cast<size_t>(row) * qkv_stride + static_cast<size_t>(h) * D;
#pragma unroll
    for (int j = 0; j < kDj; ++j)
      Io<T>::store(dst + tx + 16 * j, acc[i][j] * a.scale);
    if (tx == 0) {
      float* st = a.stats + (static_cast<size_t>(b) * a.num_heads + h) * 3 * n;
      st[row] = m[i];
      st[n + row] = inv[i];
      st[2 * n + row] = delta[i];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    qkv_attention_bwd_cols_kernel(const Args a) {
  using S = Smem<D>;
  constexpr int kDj = D / 16;
  extern __shared__ float smem[];
  float* ks = smem + S::kA;
  float* vs = smem + S::kB;
  float* qs = smem + S::kC;
  float* dos = smem + S::kD;
  float* gs = smem + S::kP;   // dlog, [query][key]
  float* pr = smem + S::kP2;  // p rounded to the working type, [query][key]
  float* vec = smem + S::kVec;  // m | 1/l | delta | score-row flag, per query

  const int n = a.n;
  const int kv = a.kv_valid;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = a.num_heads * D;
  const size_t qkv_stride = 3 * static_cast<size_t>(c);
  const T* q_src = static_cast<const T*>(a.qkv) +
                   static_cast<size_t>(b) * n * qkv_stride +
                   static_cast<size_t>(h) * D;
  const T* k_src = q_src + c;
  const T* v_src = q_src + 2 * c;
  const T* do_src = static_cast<const T*>(a.dout) +
                    static_cast<size_t>(b) * n * c + static_cast<size_t>(h) * D;
  const float* ds = a.ds == nullptr ? nullptr : a.ds + static_cast<size_t>(b) * n;
  const float* st = a.stats + (static_cast<size_t>(b) * a.num_heads + h) * 3 * n;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * kTile;

  float dk[4][kDj], dv[4][kDj];  // keys k0 + ty + 16i, dims tx + 16j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDj; ++j) dk[i][j] = dv[i][j] = 0.f;

  if (k0 < kv) {  // a key tile wholly past kv_valid has zero gradients
    load_rows<T, D>(ks, k_src, qkv_stride, k0, n);
    load_rows<T, D>(vs, v_src, qkv_stride, k0, n);
    float dsk[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      dsk[j] = ds == nullptr || key >= kv ? 0.f : ds[key];
    }
    for (int q0 = 0; q0 < n; q0 += kTile) {
      __syncthreads();  // previous tiles consumed
      load_rows<T, D>(qs, q_src, qkv_stride, q0, n);
      load_rows<T, D>(dos, do_src, c, q0, n);
      if (tid < kTile) {
        const int row = q0 + tid;
        const bool ok = row < n;
        vec[tid] = ok ? st[row] : 0.f;
        vec[kTile + tid] = ok ? st[n + row] : 0.f;
        vec[2 * kTile + tid] = ok ? st[2 * n + row] : 0.f;
        vec[3 * kTile + tid] =
            ds != nullptr && ok && score_row(row, a.mode, a.extra, kv) ? 1.f
                                                                        : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dot<D>(qs, ks, tx, ty, s);
      tile_dot<D>(dos, vs, tx, ty, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const bool row_ok = q0 + r < n;
        const float m = vec[r];
        const float inv = vec[kTile + r];
        const float delta = vec[2 * kTile + r];
        const bool srow = vec[3 * kTile + r] != 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float g = 0.f, p = 0.f;
          if (row_ok && k0 + tx + 16 * j < kv) {
            p = expf(s[i][j] * a.scale - m) * inv;
            const float dpv = srow ? dp[i][j] + dsk[j] : dp[i][j];
            g = Io<T>::round(p * (dpv - delta));
          }
          gs[r * S::kPLd + tx + 16 * j] = g;
          pr[r * S::kPLd + tx + 16 * j] = Io<T>::round(p);
        }
      }
      __syncthreads();
      const int qn = min(kTile, n - q0);
      for (int r = 0; r < qn; ++r) {
        float g[4], p[4], qd[kDj], od[kDj];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          g[i] = gs[r * S::kPLd + ty + 16 * i];
          p[i] = pr[r * S::kPLd + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < kDj; ++j) {
          qd[j] = qs[r * S::kLd + tx + 16 * j];
          od[j] = dos[r * S::kLd + tx + 16 * j];
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
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= n) continue;
    T* dst = static_cast<T*>(a.dqkv) + static_cast<size_t>(b) * n * qkv_stride +
             static_cast<size_t>(key) * qkv_stride + static_cast<size_t>(h) * D;
#pragma unroll
    for (int j = 0; j < kDj; ++j) {
      Io<T>::store(dst + c + tx + 16 * j, dk[i][j] * a.scale);
      Io<T>::store(dst + 2 * c + tx + 16 * j, dv[i][j]);
    }
  }
}

// Shared memory of the bf16 kernels, in bytes: six padded tiles (rows: Q,
// dO, two K, two V; cols: K, V, two Q, two dO) and, for the cols kernel, two
// buffers of the per-query [m | 1/l | delta | score-row flag].
template <int D>
struct SmemBf16 {
  static constexpr int kElems = mma::Tile<D>::kElems;
  static constexpr size_t kTiles = 6 * mma::Tile<D>::kBytes;
  static constexpr size_t kVec = 2 * 4 * mma::kRows * sizeof(float);
  static constexpr size_t kRowsBytes = kTiles;
  static constexpr size_t kColsBytes = kTiles + kVec;
};

template <int D>
__global__ void __launch_bounds__(mma::kThreads)
    qkv_attention_bwd_rows_bf16_kernel(const Args a) {
  using mma::bf16;
  constexpr int kElems = SmemBf16<D>::kElems;
  constexpr int kR = mma::kRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kElems;
  bf16* ks = dos + kElems;     // two buffers
  bf16* vs = ks + 2 * kElems;  // two buffers

  const int n = a.n;
  const int kv = a.kv_valid;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = a.num_heads * D;
  const size_t stride = 3 * static_cast<size_t>(c);
  const bf16* q_src = static_cast<const bf16*>(a.qkv) +
                      static_cast<size_t>(b) * n * stride +
                      static_cast<size_t>(h) * D;
  const bf16* k_src = q_src + c;
  const bf16* v_src = q_src + 2 * c;
  const bf16* do_src = static_cast<const bf16*>(a.dout) +
                       static_cast<size_t>(b) * n * c +
                       static_cast<size_t>(h) * D;
  const float* ds =
      a.ds == nullptr ? nullptr : a.ds + static_cast<size_t>(b) * n;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t2 = (lane & 3) * 2;
  const int q0 = blockIdx.x * kR;
  const int row0 = q0 + warp * 16 + (lane >> 2);  // and row0 + 8
  const int nkt = (kv + kR - 1) / kR;
  const int stages = 2 * nkt;  // two sweeps over the valid key tiles

  mma::load_tile<D>(qs, q_src, stride, q0, n);
  mma::load_tile<D>(dos, do_src, c, q0, n);
  mma::load_tile<D>(ks, k_src, stride, 0, n);
  mma::load_tile<D>(vs, v_src, stride, 0, n);
  mma::cp_async_commit();

  bool srow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    srow[i] = ds != nullptr && score_row(row0 + 8 * i, a.mode, a.extra, kv);
  uint32_t qa[D / 16][4], da[D / 16][4];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float d_run[2] = {0.f, 0.f};
  float inv[2] = {0.f, 0.f};
  float delta[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int st = 0; st < stages; ++st) {
    const int next = st + 1;
    if (next < stages) {
      const int kt = (next < nkt ? next : next - nkt) * kR;
      mma::load_tile<D>(ks + (next & 1) * kElems, k_src, stride, kt, n);
      mma::load_tile<D>(vs + (next & 1) * kElems, v_src, stride, kt, n);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    if (st == 0) {
      mma::load_a<D>(qa, qs, warp * 16, lane);
      mma::load_a<D>(da, dos, warp * 16, lane);
    }
    const bool sweep2 = st >= nkt;
    const int k0 = (sweep2 ? st - nkt : st) * kR;
    const bf16* kt_s = ks + (st & 1) * kElems;
    const bf16* vt_s = vs + (st & 1) * kElems;
    if (st == nkt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float l_row = mma::quad_sum(l[i]);
        inv[i] = 1.f / l_row;
        delta[i] = mma::quad_sum(d_run[i]) / l_row;
      }
    }
#pragma unroll
    for (int ch = 0; ch < kR / 16; ++ch) {
      const int kb = k0 + ch * 16;
      if (kb >= kv) break;  // the rest of the tile is masked
      float s[2][4], dp[2][4];
      mma::product_nt<D>(s, qa, kt_s, ch * 16, lane);
      mma::product_nt<D>(dp, da, vt_s, ch * 16, lane);
      bool valid[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kb + 8 * j + t2 + e;
          valid[j][e] = key < kv;
          const float dsk = ds != nullptr && valid[j][e] ? ds[key] : 0.f;
          s[j][e] *= a.scale;
          s[j][2 + e] *= a.scale;
          if (srow[0]) dp[j][e] += dsk;
          if (srow[1]) dp[j][2 + e] += dsk;
        }
      if (!sweep2) {
        float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (valid[j][e]) {
              mt[0] = fmaxf(mt[0], s[j][e]);
              mt[1] = fmaxf(mt[1], s[j][2 + e]);
            }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m_new = fmaxf(m[i], mma::quad_max(mt[i]));  // key 0 valid
          const float alpha = expf(m[i] - m_new);
          l[i] *= alpha;
          d_run[i] *= alpha;
          m[i] = m_new;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (valid[j][e]) {
              const float e0 = expf(s[j][e] - m[0]);
              const float e1 = expf(s[j][2 + e] - m[1]);
              l[0] += e0;
              l[1] += e1;
              d_run[0] = fmaf(e0, dp[j][e], d_run[0]);
              d_run[1] = fmaf(e1, dp[j][2 + e], d_run[1]);
            }
        continue;
      }
      // sweep 2: dlog = p (dp - delta), then dq += dlog . k
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int at = 2 * i + e;
            s[j][at] = valid[j][e] ? expf(s[j][at] - m[i]) * inv[i] *
                                         (dp[j][at] - delta[i])
                                   : 0.f;
          }
        }
      uint32_t ga[4];
      mma::to_a(ga, s);
      mma::product_nn<D>(acc, ga, kt_s, ch * 16, lane);
    }
    __syncthreads();  // buffers st & 1 consumed
  }

  mma::store_rows<D>(static_cast<bf16*>(a.dqkv) +
                         static_cast<size_t>(b) * n * stride +
                         static_cast<size_t>(h) * D,
                     stride, acc, q0 + warp * 16, n, a.scale, lane);
  if ((lane & 3) == 0) {
    float* stats = a.stats + (static_cast<size_t>(b) * a.num_heads + h) * 3 * n;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= n) continue;
      stats[row] = m[i];
      stats[n + row] = inv[i];
      stats[2 * n + row] = delta[i];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(mma::kThreads)
    qkv_attention_bwd_cols_bf16_kernel(const Args a) {
  using mma::bf16;
  constexpr int kElems = SmemBf16<D>::kElems;
  constexpr int kR = mma::kRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kElems;
  bf16* qs = vs + kElems;       // two buffers
  bf16* dos = qs + 2 * kElems;  // two buffers
  // per query of a tile: m | 1/l | delta | score-row flag; two buffers
  float* vec = reinterpret_cast<float*>(smem_raw + SmemBf16<D>::kTiles);

  const int n = a.n;
  const int kv = a.kv_valid;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = a.num_heads * D;
  const size_t stride = 3 * static_cast<size_t>(c);
  const bf16* q_src = static_cast<const bf16*>(a.qkv) +
                      static_cast<size_t>(b) * n * stride +
                      static_cast<size_t>(h) * D;
  const bf16* k_src = q_src + c;
  const bf16* v_src = q_src + 2 * c;
  const bf16* do_src = static_cast<const bf16*>(a.dout) +
                       static_cast<size_t>(b) * n * c +
                       static_cast<size_t>(h) * D;
  const float* ds =
      a.ds == nullptr ? nullptr : a.ds + static_cast<size_t>(b) * n;
  const float* stats =
      a.stats + (static_cast<size_t>(b) * a.num_heads + h) * 3 * n;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t2 = (lane & 3) * 2;
  const int k0 = blockIdx.x * kR;
  const int key0 = k0 + warp * 16 + (lane >> 2);  // and key0 + 8

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  if (k0 < kv) {  // a key tile wholly past kv_valid has zero gradients
    auto load_vec = [&](float* dst, int qb) {
      if (tid < kR) {
        const int q = qb + tid;
        const bool ok = q < n;
        dst[tid] = ok ? stats[q] : 0.f;
        dst[kR + tid] = ok ? stats[n + q] : 0.f;
        dst[2 * kR + tid] = ok ? stats[2 * n + q] : 0.f;
        dst[3 * kR + tid] =
            ds != nullptr && ok && score_row(q, a.mode, a.extra, kv) ? 1.f
                                                                     : 0.f;
      }
    };
    mma::load_tile<D>(ks, k_src, stride, k0, n);
    mma::load_tile<D>(vs, v_src, stride, k0, n);
    mma::load_tile<D>(qs, q_src, stride, 0, n);
    mma::load_tile<D>(dos, do_src, c, 0, n);
    mma::cp_async_commit();
    load_vec(vec, 0);

    bool kvalid[2];
    float dsk[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + 8 * i;
      kvalid[i] = key < kv;
      dsk[i] = ds != nullptr && kvalid[i] ? ds[key] : 0.f;
    }
    const int nqt = (n + kR - 1) / kR;
    for (int t = 0; t < nqt; ++t) {
      if (t + 1 < nqt) {
        const int buf = (t + 1) & 1;
        mma::load_tile<D>(qs + buf * kElems, q_src, stride, (t + 1) * kR, n);
        mma::load_tile<D>(dos + buf * kElems, do_src, c, (t + 1) * kR, n);
        load_vec(vec + buf * 4 * kR, (t + 1) * kR);
      }
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
      __syncthreads();
      const int qb = t * kR;
      const bf16* qt_s = qs + (t & 1) * kElems;
      const bf16* dot_s = dos + (t & 1) * kElems;
      const float* vc = vec + (t & 1) * 4 * kR;
#pragma unroll
      for (int ch = 0; ch < kR / 16; ++ch) {
        const int ql0 = ch * 16;
        if (qb + ql0 >= n) break;
        uint32_t frag[D / 16][4];
        float s[2][4], dp[2][4];
        mma::load_a<D>(frag, ks, warp * 16, lane);
        mma::product_nt<D>(s, frag, qt_s, ql0, lane);  // s^T = k . q^T
        mma::load_a<D>(frag, vs, warp * 16, lane);
        mma::product_nt<D>(dp, frag, dot_s, ql0, lane);  // dp^T = v . dO^T
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ql = ql0 + 8 * j + t2 + e;
            const bool qvalid = qb + ql < n;
            const float mq = vc[ql];
            const float iq = vc[kR + ql];
            const float dq = vc[2 * kR + ql];
            const bool sr = vc[3 * kR + ql] != 0.f;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int at = 2 * i + e;
              const bool ok = kvalid[i] && qvalid;
              const float p = ok ? expf(s[j][at] * a.scale - mq) * iq : 0.f;
              const float dpv = sr ? dp[j][at] + dsk[i] : dp[j][at];
              dp[j][at] = ok ? p * (dpv - dq) : 0.f;  // dlog^T
              s[j][at] = p;
            }
          }
        uint32_t pa[4], ga[4];
        mma::to_a(pa, s);
        mma::to_a(ga, dp);
        mma::product_nn<D>(dv, pa, dot_s, ql0, lane);
        mma::product_nn<D>(dk, ga, qt_s, ql0, lane);
      }
      __syncthreads();  // buffers t & 1 consumed
    }
  }

  bf16* dst = static_cast<bf16*>(a.dqkv) + static_cast<size_t>(b) * n * stride +
              static_cast<size_t>(h) * D;
  mma::store_rows<D>(dst + c, stride, dk, k0 + warp * 16, n, a.scale, lane);
  mma::store_rows<D>(dst + 2 * c, stride, dv, k0 + warp * 16, n, 1.f, lane);
}

template <int D>
cudaError_t launch_bf16(bool rows, const Args& a, int batch,
                        cudaStream_t stream) {
  auto kernel = rows ? qkv_attention_bwd_rows_bf16_kernel<D>
                     : qkv_attention_bwd_cols_bf16_kernel<D>;
  const size_t smem =
      rows ? SmemBf16<D>::kRowsBytes : SmemBf16<D>::kColsBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + mma::kRows - 1) / mma::kRows, a.num_heads, batch);
  kernel<<<grid, mma::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(bool rows, const Args& a, int batch, cudaStream_t stream) {
  auto kernel = rows ? qkv_attention_bwd_rows_kernel<T, D>
                     : qkv_attention_bwd_cols_kernel<T, D>;
  constexpr size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kTile - 1) / kTile, a.num_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

int dispatch(bool rows, const void* qkv, const void* dout, const void* ds,
             void* dqkv, void* stats, int batch, int n, int num_heads,
             int head_dim, int dtype, int mode, int extra, int kv_valid,
             float scale, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || num_heads < 1 ||
      num_heads > 65535 || mode < kModeNone || mode > kModeCls || extra < 0 ||
      kv_valid <= extra || kv_valid > n || (mode != kModeNone) != (ds != nullptr) ||
      qkv == nullptr || dout == nullptr || dqkv == nullptr || stats == nullptr) {
    return cudaErrorInvalidValue;
  }
  const Args a{qkv, dout, static_cast<const float*>(ds), dqkv,
               static_cast<float*>(stats), n, num_heads, mode, extra,
               kv_valid, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(rows, a, batch, s);
  if (dtype == 0 && head_dim == 80) return launch<float, 80>(rows, a, batch, s);
  if (dtype == 1 && head_dim == 64) return launch_bf16<64>(rows, a, batch, s);
  if (dtype == 1 && head_dim == 80) return launch_bf16<80>(rows, a, batch, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  mode: 0 = none (ds == nullptr),
// 1 = patch_mean, 2 = cls (ds: (batch, n) f32, pre-scaled, zero on the
// extras).  dout: (batch, n, C) contiguous; dqkv: (batch, n, 3C) in qkv's
// dtype; stats: (batch, num_heads, 3, n) f32 scratch.  kv_valid in
// (extra, n].  The rows kernel writes dq and stats; the cols kernel, launched
// after it on the same stream, reads stats and writes dk and dv.  Each
// returns the CUDA error of its launch (0 on success).
extern "C" int tpat_qkv_attention_bwd_rows(
    const void* qkv, const void* dout, const void* ds, void* dqkv, void* stats,
    int batch, int n, int num_heads, int head_dim, int dtype, int mode,
    int extra, int kv_valid, float scale, void* stream) {
  return dispatch(true, qkv, dout, ds, dqkv, stats, batch, n, num_heads,
                  head_dim, dtype, mode, extra, kv_valid, scale, stream);
}

extern "C" int tpat_qkv_attention_bwd_cols(
    const void* qkv, const void* dout, const void* ds, void* dqkv, void* stats,
    int batch, int n, int num_heads, int head_dim, int dtype, int mode,
    int extra, int kv_valid, float scale, void* stream) {
  return dispatch(false, qkv, dout, ds, dqkv, stats, batch, n, num_heads,
                  head_dim, dtype, mode, extra, kv_valid, scale, stream);
}
