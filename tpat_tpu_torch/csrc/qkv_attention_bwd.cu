// Backward of the fused packed-qkv attention, for Hopper (sm_90a).
//
// Replaces tpat_tpu/ops/pallas_attention.py::_qkv_bwd_kernel, the TPU
// kernel the custom VJPs of fused_qkv_attention and
// fused_qkv_attention_prefix run in every block of every train step.
//
// What it computes, per (batch b, head h), from the packed (B, N, 3C) qkv,
// the output cotangent dO (B, N, C) and an optional score cotangent ds
// (B, N) f32, already pre-scaled and zero on the extra tokens by the wrapper:
//   p     = softmax(q . k^T * D^-1/2) in f32 over the keys [0, kv_valid)
//           (keys past kv_valid: p = 0);
//   dp    = dO . v^T in f32 from the working-type operands, plus ds[key] on
//           the rows the score reads ('patch_mean': [extra, kv_valid);
//           'cls': row 0);
//   dlog  = p (dp - delta), delta = sum_k dp p, in f32, rounded to the
//           working type;
//   dq    = (dlog . k) * D^-1/2, dk = (dlog^T . q) * D^-1/2, accumulated in
//           f32 and rounded once;
//   dv    = (p rounded to the working type)^T . dO;
// written into the packed (B, N, 3C) layout [dq | dk | dv], as the TPU kernel
// writes them.
//
// What is different on Hopper.  dk and dv are sums over every query row; on
// the TPU one grid step holds the whole (N, N) tile of a head, but CTAs on
// the card run in no order.  So, with no atomics and nothing (B, H, N, N) in
// HBM, two kernels run in turn on the stream:
//   1. rows: one CTA per (b, h, 64-row query tile); it writes dq and the
//      per-row statistics into the f32 (B, H, 3, N) scratch [m | 1/l |
//      delta] (the wgmma body only delta);
//   2. cols: one CTA per (b, h, 64-key tile); it holds its K and V tiles,
//      walks every query tile, rebuilds p and dlog, and accumulates dk and
//      dv in registers; it writes them once.  Key tiles wholly past
//      kv_valid write zeros.
// Deterministic: every sum has one owner and a fixed order.
//
// Three bodies, chosen by dtype and head_dim (a dispatch, not a fallback):
//
// bf16 at head_dim 64 and 32: the wgmma bodies
// (qkv_attention_bwd_rows_wgmma_kernel, qkv_attention_bwd_cols_wgmma_kernel,
// on attention_wgmma.cuh).  What bounds it on an H100 (NVIDIA H100 80GB
// HBM3, 700 W): bytes at D 64 (0.98 ms per b128 hybrid-0.8 step against ~10
// N^2 D FLOPs that the tensor cores do in a fraction of it), and at D 32
// (N = 513) FLOPs and the exps of p, which the two kernels take twice (once
// each).  The earlier mma.sync body swept the keys twice in the rows kernel
// (m, l and delta online; then dlog) and recomputed s and dp a third time in
// the cols kernel.  This body takes the forward's row log-sum-exp L
// (qkv_attention.cu writes it when the call is recorded for autograd) and
// the forward's bf16 output O:
//   - p = 2^(s c - L log2 e), c = D^-1/2 log2 e folded into one FMA: no
//     online max or sum and no division in either kernel;
//   - delta = rowsum(dO * O) from the saved output, in the rows kernel's
//     prologue (dO . O equals sum_k p_k dp_k up to O's rounding, held to
//     the unchanged limit of 2e-2 of the largest gradient); with a score
//     cotangent, the rows the score reads add sum_k p_k ds_k, which costs
//     one extra q.k^T sweep over the keys (no dO.v^T) in the CTAs that hold
//     such a row;
//   - rows: ONE sweep over the keys: s = q.k^T and dp = dO.v^T as wgmma
//     m64n64k16 (Q, dO and the K, V tiles K-major from shared memory), dlog
//     on the accumulator registers, rounded to bf16 as the A operand of
//     dq += dlog.k (m64nDk16, the K tile MN-major); it writes delta for the
//     cols kernel;
//   - cols: s^T = k.q^T and dp^T = v.dO^T with the key tile as the A
//     operand, so p^T and dlog^T come out in the accumulator layout of the
//     warpgroup's 64 keys and, rounded to bf16, are the register A operands
//     of dv += p^T.dO and dk += dlog^T.q (dO and q MN-major).  Each logit is
//     the same exact bf16 products, accumulated in f32 over the same k16
//     steps as in the rows kernel (the one product_nt code with the
//     operands' roles swapped).  Whether wgmma sums the 16 products inside a
//     step in the same order with the roles swapped is not documented and
//     not checked, so the two kernels' p may differ in the last bits; the
//     gradients need no more than the limit they are held to;
//   - tiles by TMA (tensor maps over the packed (3C, N, B) qkv and the (C,
//     N, B) dO, boxes of one head's D columns x 64 rows of one sample, the
//     128-byte swizzle at D 64 and the 64-byte one at D 32); a producer warp
//     loads the CTA's own tiles once and streams the other side's through a
//     ring of two stages (K and V in rows, Q and dO in cols) under full /
//     empty mbarriers; one consumer warpgroup of 64 rows (keys in cols), 160
//     threads, 48 KB (D 64) or 24 KB (D 32) of shared memory, so that two or
//     more CTAs share an SM and overlap each other's softmax, products and
//     loads.
//   The rounding points: dlog and p rounded to bf16 before their products,
//   as the JAX kernel; delta is taken from the bf16 O instead of the sum of
//   p dp.
//
// bf16 at head_dim 80 (in the chip checks' grids, on no model path): the
// earlier mma.sync body (qkv_attention_bwd_rows_mma_kernel, _cols_mma_),
// kept because its 160-byte row fits neither TMA swizzle span as one box
// (two boxes a row, or no swizzle, would fit: a follow-up in ROADMAP); its
// forward writes no L, so its rows kernel sweeps the keys twice (s and dp
// with m, l and the unnormalised delta online, rescaled as l is; then dlog
// and dq),
// and the cols kernel rebuilds p from m and 1/l.  mma.sync m16n8k16 with f32
// accumulation on bf16 tiles staged by 16-byte cp.async into padded rows,
// the streamed tiles double-buffered (attention_mma.cuh); four warps, each
// owning 16 rows of the CTA's tile.
// f32 (the parity checks, held to plain at 1e-4 of the largest gradient):
// tensor-core f32 would be TF32, so it stays on exact FMA loops with 4 x 4
// register micro-tiles over f32 tiles in shared memory; its rows kernel
// sweeps the keys three times (m and l; delta; dlog and dq).  Neither of
// these two bodies reads O or L.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "attention_mma.cuh"
#include "attention_wgmma.cuh"

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

using bf16 = __nv_bfloat16;

struct Args {
  const void* qkv;
  const void* dout;
  const float* ds;
  void* dqkv;
  float* stats;
  const void* out;   // the forward's output (the wgmma bodies only)
  const float* lse;  // the forward's row log-sum-exp (the wgmma bodies only)
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

// ---- bf16 at head_dim 80: the mma.sync bodies ----------------------------

// Shared memory of the mma.sync kernels, in bytes: six padded tiles (rows: Q,
// dO, two K, two V; cols: K, V, two Q, two dO) and, for the cols kernel, two
// buffers of the per-query [m | 1/l | delta | score-row flag].
template <int D>
struct SmemMma {
  static constexpr int kElems = mma::Tile<D>::kElems;
  static constexpr size_t kTiles = 6 * mma::Tile<D>::kBytes;
  static constexpr size_t kVec = 2 * 4 * mma::kRows * sizeof(float);
  static constexpr size_t kRowsBytes = kTiles;
  static constexpr size_t kColsBytes = kTiles + kVec;
};

template <int D>
__global__ void __launch_bounds__(mma::kThreads)
    qkv_attention_bwd_rows_mma_kernel(const Args a) {
  using mma::bf16;
  constexpr int kElems = SmemMma<D>::kElems;
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
    qkv_attention_bwd_cols_mma_kernel(const Args a) {
  using mma::bf16;
  constexpr int kElems = SmemMma<D>::kElems;
  constexpr int kR = mma::kRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kElems;
  bf16* qs = vs + kElems;       // two buffers
  bf16* dos = qs + 2 * kElems;  // two buffers
  // per query of a tile: m | 1/l | delta | score-row flag; two buffers
  float* vec = reinterpret_cast<float*>(smem_raw + SmemMma<D>::kTiles);

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
cudaError_t launch_mma(bool rows, const Args& a, int batch,
                        cudaStream_t stream) {
  auto kernel = rows ? qkv_attention_bwd_rows_mma_kernel<D>
                     : qkv_attention_bwd_cols_mma_kernel<D>;
  const size_t smem =
      rows ? SmemMma<D>::kRowsBytes : SmemMma<D>::kColsBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + mma::kRows - 1) / mma::kRows, a.num_heads, batch);
  kernel<<<grid, mma::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---- bf16 at head_dim 32 and 64: wgmma, TMA, p from the saved L ----------

// Shared memory of the wgmma bodies past their 1024-byte aligned base: the
// CTA's own two tiles (rows: Q, dO; cols: K, V), then the ring's stages of
// the streamed pair (rows: K, V; cols: Q, dO), then the per-token f32
// vectors of the sample and head, each ceil(n / 64) * 64 long (rows: ds, if
// given; cols: L log2 e and delta), staged once per CTA: read from device
// memory inside the loop they cost the cols kernel 0.27 of 0.62 ms at b128,
// N 257 (NVIDIA H100 80GB HBM3, 700 W).
template <int D>
struct SmemWgmma {
  static constexpr uint32_t kTile = wgmma::Tile<D>::kBytes;
  static constexpr uint32_t kOwn = 0;          // + kTile: the second one
  static constexpr uint32_t kStage0 = 2 * kTile;  // stage s at + 2 s kTile
  static constexpr uint32_t kVec = kStage0 + wgmma::kStages * 2 * kTile;
  // with `vectors` vectors of n tokens, + the alignment
  static size_t bytes(int n, int vectors) {
    return kVec + static_cast<size_t>(vectors) * padded(n) * sizeof(float) +
           1024;
  }
  static __host__ __device__ int padded(int n) {
    return (n + wgmma::kRows - 1) / wgmma::kRows * wgmma::kRows;
  }
};

constexpr float kLog2e = 1.4426950408889634f;

// Sets up the barriers of a wgmma backward CTA (thread 0), then syncs.
__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty,
                                              uint64_t* own) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < wgmma::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], wgmma::kConsumers / 32);
    }
    hopper::mbar_init(own, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
}

// The producer thread: the CTA's own two tiles (map0 and map1 at columns
// col0 and col1, rows r0) on `own`, then per step st of `steps` the
// streamed pair (columns scol0 and scol1, rows (st % wrap) * 64; the second
// tile only where `both(st)`) into the ring.
template <int D, typename Both>
__device__ __forceinline__ void produce(unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, uint64_t* own,
                                        const CUtensorMap* map0, int col0,
                                        const CUtensorMap* map1, int col1,
                                        int r0, const CUtensorMap* smap0,
                                        int scol0, const CUtensorMap* smap1,
                                        int scol1, int steps, int wrap,
                                        Both both, int b) {
  constexpr uint32_t kT = SmemWgmma<D>::kTile;
  hopper::mbar_arrive_expect_tx(own, 2 * kT);
  wgmma::tma_load_3d(smem + SmemWgmma<D>::kOwn, map0, own, col0, r0, b);
  wgmma::tma_load_3d(smem + SmemWgmma<D>::kOwn + kT, map1, own, col1, r0, b);
  for (int st = 0; st < steps; ++st) {
    const int s = st % wgmma::kStages;
    hopper::mbar_wait(&empty[s], ((st / wgmma::kStages) & 1) ^ 1);
    const bool two = both(st);
    const int row = (st % wrap) * wgmma::kRows;
    unsigned char* dst = smem + SmemWgmma<D>::kStage0 + s * 2 * kT;
    hopper::mbar_arrive_expect_tx(&full[s], two ? 2 * kT : kT);
    wgmma::tma_load_3d(dst, smap0, &full[s], scol0, row, b);
    if (two) wgmma::tma_load_3d(dst + kT, smap1, &full[s], scol1, row, b);
  }
}

// A consumer warp hands stage s back.
__device__ __forceinline__ void release(uint64_t* empty, int s) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(&empty[s]);
}

template <int D>
__global__ void __launch_bounds__(wgmma::kThreads)
    qkv_attention_bwd_rows_wgmma_kernel(
        const __grid_constant__ CUtensorMap qkv_map,
        const __grid_constant__ CUtensorMap do_map, const Args a) {
  using S = SmemWgmma<D>;
  constexpr uint32_t kT = S::kTile;
  constexpr int kR = wgmma::kRows;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[wgmma::kStages], empty[wgmma::kStages], own;
  const uint32_t raw = hopper::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t base = hopper::smem_addr(smem);

  const int n = a.n;
  const int kv = a.kv_valid;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = a.num_heads * D;
  const int q0 = blockIdx.x * kR;
  const int nkt = (kv + kR - 1) / kR;
  const float* ds =
      a.ds == nullptr ? nullptr : a.ds + static_cast<size_t>(b) * n;
  // the extra q.k^T sweep for sum_k p ds: only where a row reads the score
  const bool ds_sweep =
      ds != nullptr && (a.mode == kModePatchMean
                            ? q0 + kR > a.extra && q0 < kv
                            : q0 == 0);
  const int steps = ds_sweep ? 2 * nkt : nkt;
  init_barriers(full, empty, &own);

  if (threadIdx.x >= wgmma::kConsumers) {  // the producer warp
    if (threadIdx.x == wgmma::kConsumers)
      produce<D>(smem, full, empty, &own, &qkv_map, h * D, &do_map, h * D, q0,
                 &qkv_map, c + h * D, &qkv_map, 2 * c + h * D, steps, nkt,
                 [&](int st) { return !(ds_sweep && st < nkt); }, b);
    return;
  }

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int t2 = 2 * (lane & 3);
  const int row0 = q0 + (tid >> 5) * 16 + (lane >> 2);  // and row0 + 8
  const float c2 = a.scale * kLog2e;
  const size_t bh = static_cast<size_t>(b) * a.num_heads + h;
  // the sample's score cotangent, one f32 per key (zero past n)
  float* dsv = reinterpret_cast<float*>(smem + S::kVec);
  if (ds != nullptr) {
    for (int i = tid; i < S::padded(n); i += wgmma::kConsumers)
      dsv[i] = i < n ? ds[i] : 0.f;
    hopper::named_barrier_sync(1, wgmma::kConsumers);
  }
  float l2[2], delta[2];
  bool srow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const bool ok = row < n;
    // rows past n (zeros from TMA) get p = 0 and are never written
    l2[i] = ok ? a.lse[bh * n + row] * kLog2e : INFINITY;
    srow[i] = ds != nullptr && score_row(row, a.mode, a.extra, kv);
    // delta = rowsum(dO * O): the lane's quarter of the row, then the quad
    float acc = 0.f;
    if (ok) {
      const size_t at = (static_cast<size_t>(b) * n + row) * c +
                        static_cast<size_t>(h) * D + (lane & 3) * (D / 4);
      const uint4* op =
          reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.out) + at);
      const uint4* dp =
          reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.dout) + at);
#pragma unroll
      for (int v = 0; v < D / 32; ++v) {
        const uint4 ov = op[v], dv = dp[v];
        const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
        const uint32_t dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 of = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&ow[w]));
          const float2 df = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&dw[w]));
          acc = fmaf(of.x, df.x, acc);
          acc = fmaf(of.y, df.y, acc);
        }
      }
    }
    delta[i] = wgmma::quad_sum(acc);
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  hopper::mbar_wait(&own, 0);
  for (int st = 0; st < steps; ++st) {
    const int s = st % wgmma::kStages;
    const bool sweep1 = ds_sweep && st < nkt;
    const int k0 = (st % nkt) * kR;
    const uint32_t ks = base + S::kStage0 + s * 2 * kT;
    hopper::mbar_wait(&full[s], (st / wgmma::kStages) & 1);
    if (sweep1) {
      // sum_k p_k ds_k for the rows the score reads
      float sc[32];
      hopper::wgmma_fence();
      wgmma::product_nt<D>(sc, base + S::kOwn, ks);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      wgmma::fence_acc(sc);
      release(empty, s);
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + t2 + e;
          if (key < kv) {
            const float dsk = dsv[key];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              part[i] = fmaf(
                  wgmma::ex2(fmaf(sc[4 * j + 2 * i + e], c2, -l2[i])), dsk,
                  part[i]);
          }
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float sum = wgmma::quad_sum(part[i]);
        if (srow[i]) delta[i] += sum;
      }
      continue;
    }
    float sc[32], dp[32];
    hopper::wgmma_fence();
    wgmma::product_nt<D>(sc, base + S::kOwn, ks);            // q.k^T
    wgmma::product_nt<D>(dp, base + S::kOwn + kT, ks + kT);  // dO.v^T
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    wgmma::fence_acc(sc);
    wgmma::fence_acc(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + t2 + e;
        const bool valid = key < kv;
        const float dsk = ds != nullptr ? dsv[key] : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int at = 4 * j + 2 * i + e;
          const float p = valid ? wgmma::ex2(fmaf(sc[at], c2, -l2[i])) : 0.f;
          const float dpv = srow[i] ? dp[at] + dsk : dp[at];
          sc[at] = p * (dpv - delta[i]);  // dlog
        }
      }
    uint32_t ga[4][4];
    wgmma::to_a(ga, sc);
    hopper::wgmma_fence();
    wgmma::product_nn<D>(dq, ga, ks);  // dq += dlog . k
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    wgmma::fence_acc(dq);
    release(empty, s);
  }

  wgmma::store_tile<D>(static_cast<bf16*>(a.dqkv) +
                           static_cast<size_t>(b) * n * 3 * c +
                           static_cast<size_t>(h) * D,
                       3 * static_cast<size_t>(c), dq, q0, n, a.scale);
  if ((lane & 3) == 0) {
    float* stats = a.stats + bh * 3 * n;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row < n) stats[2 * n + row] = delta[i];
    }
  }
}

template <int D>
__device__ __forceinline__ void bwd_cols_wgmma(const CUtensorMap* qkv_map,
                                               const CUtensorMap* do_map,
                                               const Args& a) {
  using S = SmemWgmma<D>;
  constexpr uint32_t kT = S::kTile;
  constexpr int kR = wgmma::kRows;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[wgmma::kStages], empty[wgmma::kStages], own;
  const uint32_t raw = hopper::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t base = hopper::smem_addr(smem);

  const int n = a.n;
  const int kv = a.kv_valid;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = a.num_heads * D;
  const int k0 = blockIdx.x * kR;
  const int nqt = (n + kR - 1) / kR;
  const bool live = k0 < kv;  // a key tile wholly past kv_valid: zeros
  init_barriers(full, empty, &own);

  if (threadIdx.x >= wgmma::kConsumers) {  // the producer warp
    if (threadIdx.x == wgmma::kConsumers && live)
      produce<D>(smem, full, empty, &own, qkv_map, c + h * D, qkv_map,
                 2 * c + h * D, k0, qkv_map, h * D, do_map, h * D, nqt, nqt,
                 [](int) { return true; }, b);
    return;
  }

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int t2 = 2 * (lane & 3);
  const int key0 = k0 + (tid >> 5) * 16 + (lane >> 2);  // and key0 + 8
  const float c2 = a.scale * kLog2e;
  const size_t bh = static_cast<size_t>(b) * a.num_heads + h;
  const float* ds =
      a.ds == nullptr ? nullptr : a.ds + static_cast<size_t>(b) * n;
  // per query: L log2 e (+inf past n, so p = 0 there) and delta
  float* lv = reinterpret_cast<float*>(smem + S::kVec);
  float* dlv = lv + S::padded(n);
  if (live) {
    const float* lse = a.lse + bh * n;
    const float* delta = a.stats + bh * 3 * n + 2 * n;
    for (int i = tid; i < S::padded(n); i += wgmma::kConsumers) {
      const bool ok = i < n;
      lv[i] = ok ? lse[i] * kLog2e : INFINITY;
      dlv[i] = ok ? delta[i] : 0.f;
    }
    hopper::named_barrier_sync(1, wgmma::kConsumers);
  }
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  if (live) {
    bool kvalid[2];
    float dsk[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + 8 * i;
      kvalid[i] = key < kv;
      dsk[i] = ds != nullptr && kvalid[i] ? ds[key] : 0.f;
    }
    hopper::mbar_wait(&own, 0);
    for (int t = 0; t < nqt; ++t) {
      const int s = t % wgmma::kStages;
      const int qb = t * kR;
      const uint32_t qs = base + S::kStage0 + s * 2 * kT;
      hopper::mbar_wait(&full[s], (t / wgmma::kStages) & 1);
      float sc[32], dp[32];
      hopper::wgmma_fence();
      wgmma::product_nt<D>(sc, base + S::kOwn, qs);            // k.q^T
      wgmma::product_nt<D>(dp, base + S::kOwn + kT, qs + kT);  // v.dO^T
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      wgmma::fence_acc(sc);
      wgmma::fence_acc(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int q = qb + 8 * j + t2;  // and q + 1
        const float2 lq = *reinterpret_cast<const float2*>(lv + q);
        const float2 dq = *reinterpret_cast<const float2*>(dlv + q);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool sr = ds != nullptr && q + e < n &&
                          score_row(q + e, a.mode, a.extra, kv);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int at = 4 * j + 2 * i + e;
            const float p = kvalid[i] ? wgmma::ex2(fmaf(
                                            sc[at], c2, e ? -lq.y : -lq.x))
                                      : 0.f;
            const float dpv = sr ? dp[at] + dsk[i] : dp[at];
            dp[at] = p * (dpv - (e ? dq.y : dq.x));  // dlog^T
            sc[at] = p;
          }
        }
      }
      // dv's products run while dlog^T is packed for dk's
      uint32_t pa[4][4], ga[4][4];
      wgmma::to_a(pa, sc);
      hopper::wgmma_fence();
      wgmma::product_nn<D>(dv, pa, qs + kT);  // dv += p^T . dO
      wgmma::to_a(ga, dp);
      hopper::wgmma_fence();
      wgmma::product_nn<D>(dk, ga, qs);       // dk += dlog^T . q
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      wgmma::fence_acc(dv);
      wgmma::fence_acc(dk);
      release(empty, s);
    }
  }

  bf16* dst = static_cast<bf16*>(a.dqkv) + static_cast<size_t>(b) * n * 3 * c +
              static_cast<size_t>(h) * D;
  const size_t stride = 3 * static_cast<size_t>(c);
  wgmma::store_tile<D>(dst + c, stride, dk, k0, n, a.scale);
  wgmma::store_tile<D>(dst + 2 * c, stride, dv, k0, n, 1.f);
}

template <int D>
__global__ void __launch_bounds__(wgmma::kThreads)
    qkv_attention_bwd_cols_wgmma_kernel(
        const __grid_constant__ CUtensorMap qkv_map,
        const __grid_constant__ CUtensorMap do_map, const Args a) {
  bwd_cols_wgmma<D>(&qkv_map, &do_map, a);
}

// At D 32, three CTAs per SM (at most 136 registers, a few bytes of spill)
// take 15% less time per b32 call at N = 513 than the 146 registers that
// fit two.  At D 64 the same bound spills 504 bytes and doubles the time,
// and even a bound of one CTA per SM made ptxas take 180 registers and
// 0.37 ms where the unbounded kernel takes 168 and 0.24 (b128, N = 257), so
// only D 32 is bounded (NVIDIA H100 80GB HBM3, 700 W).
template <>
__global__ void __launch_bounds__(wgmma::kThreads, 3)
    qkv_attention_bwd_cols_wgmma_kernel<32>(
        const __grid_constant__ CUtensorMap qkv_map,
        const __grid_constant__ CUtensorMap do_map, const Args a) {
  bwd_cols_wgmma<32>(&qkv_map, &do_map, a);
}

template <int D>
cudaError_t launch_wgmma(bool rows, const Args& a, int batch,
                         cudaStream_t stream) {
  const int c = a.num_heads * D;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if ((3 * c) % 8 != 0 || !aligned(a.qkv) || !aligned(a.dout) ||
      !aligned(a.out) || !aligned(a.dqkv))
    return cudaErrorInvalidValue;  // TMA and 16-byte loads
  CUtensorMap qkv_map, do_map;
  cudaError_t err = wgmma::head_tile_map<D>(&qkv_map, a.qkv, batch, a.n, 3 * c);
  if (err == cudaSuccess)
    err = wgmma::head_tile_map<D>(&do_map, a.dout, batch, a.n, c);
  if (err != cudaSuccess) return err;
  auto kernel = rows ? qkv_attention_bwd_rows_wgmma_kernel<D>
                     : qkv_attention_bwd_cols_wgmma_kernel<D>;
  const size_t smem = SmemWgmma<D>::bytes(
      a.n, rows ? (a.ds != nullptr ? 1 : 0) : 2);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + wgmma::kRows - 1) / wgmma::kRows, a.num_heads, batch);
  kernel<<<grid, wgmma::kThreads, smem, stream>>>(qkv_map, do_map, a);
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
             void* dqkv, void* stats, const void* out, const void* lse,
             int batch, int n, int num_heads, int head_dim, int dtype,
             int mode, int extra, int kv_valid, float scale, void* stream) {
  // the wgmma bodies read the forward's output and L; the others neither
  const bool saved = wgmma::takes(dtype, head_dim);
  if (batch < 1 || batch > 65535 || n < 1 || num_heads < 1 ||
      num_heads > 65535 || mode < kModeNone || mode > kModeCls || extra < 0 ||
      kv_valid <= extra || kv_valid > n || (mode != kModeNone) != (ds != nullptr) ||
      qkv == nullptr || dout == nullptr || dqkv == nullptr || stats == nullptr ||
      (out != nullptr) != saved || (lse != nullptr) != saved) {
    return cudaErrorInvalidValue;
  }
  const Args a{qkv, dout, static_cast<const float*>(ds), dqkv,
               static_cast<float*>(stats), out, static_cast<const float*>(lse),
               n, num_heads, mode, extra, kv_valid, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 32) return launch<float, 32>(rows, a, batch, s);
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(rows, a, batch, s);
  if (dtype == 0 && head_dim == 80) return launch<float, 80>(rows, a, batch, s);
  if (dtype == 1 && head_dim == 32) return launch_wgmma<32>(rows, a, batch, s);
  if (dtype == 1 && head_dim == 64) return launch_wgmma<64>(rows, a, batch, s);
  if (dtype == 1 && head_dim == 80) return launch_mma<80>(rows, a, batch, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  mode: 0 = none (ds == nullptr),
// 1 = patch_mean, 2 = cls (ds: (batch, n) f32, pre-scaled, zero on the
// extras).  dout: (batch, n, C) contiguous; dqkv: (batch, n, 3C) in qkv's
// dtype; stats: (batch, num_heads, 3, n) f32 scratch.  out: the forward's
// (batch, n, C) output and lse: its (batch, num_heads, n) f32 row
// log-sum-exp, both given exactly for bf16 at head_dim 32 and 64 (that
// body also needs 16-byte aligned qkv, dout, out and dqkv and 3C a
// multiple of 8), else both null.  kv_valid in (extra, n].  The rows kernel
// writes dq and stats; the cols kernel, launched after it on the same
// stream, reads stats and writes dk and dv.  Each returns the CUDA error of
// its launch (0 on success).
extern "C" int tpat_qkv_attention_bwd_rows(
    const void* qkv, const void* dout, const void* ds, void* dqkv, void* stats,
    const void* out, const void* lse, int batch, int n, int num_heads,
    int head_dim, int dtype, int mode, int extra, int kv_valid, float scale,
    void* stream) {
  return dispatch(true, qkv, dout, ds, dqkv, stats, out, lse, batch, n,
                  num_heads, head_dim, dtype, mode, extra, kv_valid, scale,
                  stream);
}

extern "C" int tpat_qkv_attention_bwd_cols(
    const void* qkv, const void* dout, const void* ds, void* dqkv, void* stats,
    const void* out, const void* lse, int batch, int n, int num_heads,
    int head_dim, int dtype, int mode, int extra, int kv_valid, float scale,
    void* stream) {
  return dispatch(false, qkv, dout, ds, dqkv, stats, out, lse, batch, n,
                  num_heads, head_dim, dtype, mode, extra, kv_valid, scale,
                  stream);
}
