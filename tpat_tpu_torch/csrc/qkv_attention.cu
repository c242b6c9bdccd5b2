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
//         (keys at or past kv_valid get p = 0, as the TPU kernel's -1e30
//         logit gives them; kv_valid = N: all keys);
//   out = p . v, accumulated in f32, written in the input dtype;
//   'patch_mean': column sums of the normalised f32 p over query rows in
//                 [extra, kv_valid) (the AudioMAE importance signal);
//   'cls':        the row-0 probabilities (the AST importance signal);
//   none:         no score output and no score work;
//   lse (optional, bf16 at head_dim 32 and 64): each row's log-sum-exp
//         L = max + log(sum), f32 (B, H, N), which the backward
//         (qkv_attention_bwd.cu) rebuilds p from.  The wrapper asks for it
//         only when the call is recorded for autograd.
// The logits are the f32 sum of the products times D^-1/2 (the scale after
// the product, q is never pre-scaled).  q, k and v are read straight out of
// the packed (B, N, 3C) projection output (sections at column offsets 0, C
// and 2C, head h at h*D) and out is written as (B, N, C): no permute on
// either side.  One CTA = one (b, h, tile of 64 query rows) in every body.
// Column sums go to an f32 partial buffer (B, H, n_qtiles, N) that the
// wrapper sums over q-tiles: no atomics, so scores are deterministic.  Rows
// at or past kv_valid are still computed and written, as on the TPU; key
// tiles wholly past kv_valid are not visited.
//
// Three bodies, chosen by dtype and head_dim (a dispatch, not a fallback):
//
// bf16 at head_dim 64 (ViT-B: serving, finetuning, AST) and 32 (the MAE's
// plain decoder): qkv_attention_fwd_wgmma_kernel, on attention_wgmma.cuh.
//   What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W): at D 64 bytes
//   (one b128 call at N = 257 moves ~200 MB, ~60 us at 3.35 TB/s, against
//   ~26 GFLOP, ~26 us at 989 TFLOP/s, and 101 M exps, ~24 us at 16 a clock
//   per SM); at D 32 (N = 513, H = 16, b32) the exps: 135 M of them take
//   ~32 us, more than its ~67 MB of bytes (~20 us) or its
//   ~17 GFLOP (~17 us).
//   The earlier mma.sync body swept the keys twice and took expf twice per
//   logit, so the design cuts the exps and the passes first:
//   - Mode none (9 of the 12 calls of a serving forward, every decoder-0
//     call): ONE sweep over the keys with online rescaling.  Per 64-key tile
//     s = q.k^T, the row max m grows, l and the O accumulator are multiplied
//     by 2^(m_old - m_new), and p~ = 2^(s c - m) (c = D^-1/2 log2 e folded
//     into one FMA) is added to l and, rounded to bf16, is the A operand of
//     O += p~.v; O is multiplied by 1/l once at the end.  The rounding point
//     moves: the JAX kernel rounds the normalised p, this body rounds p~
//     (<= 1) and normalises the f32 sum after the product (held to the same
//     limits: kernel vs plain within 2e-2, model logits within 5e-2 of the
//     largest).
//   - 'patch_mean' and 'cls' need the final m and l before the first score:
//     pass 1 streams K alone for m and l, pass 2 streams K and V, forms the
//     normalised f32 p, its column sums (a reduce-scatter over the warp's
//     quads, then the 4 warps through shared memory) and round(p).v.
//   - exp2 on the special-function unit everywhere (ex2.approx), log2 e
//     folded into the scale.
//   - Products on wgmma: one consumer warpgroup owns the 64 query rows;
//     s = q.k^T as D/16 wgmma m64n64k16 with Q and the K tile from shared
//     memory (both K-major), O += p~.v as four m64nDk16 with p~ from the
//     accumulator registers and the V tile MN-major (imm-trans-b).
//   - Tiles by TMA: one 3-D tensor map over the packed (3C, N, B) input
//     whose box is one head's D columns x 64 rows of one sample (the
//     section picked by the column coordinate sec*C + h*D), so rows past N
//     of a sample read as zeros and never the next sample's; the 128-byte
//     swizzle at D 64, the 64-byte one at D 32, matching the descriptors'
//     layout type.  A producer warp (one thread issuing) loads Q once and
//     streams K (and V) tiles through a ring of two stages under full/empty
//     mbarriers; the consumers hand a stage back once its products are done.
//   - Design choices: one consumer warpgroup per CTA (160 threads, 20 KB
//     (D 32) or 40 KB (D 64) of shared memory, registers bounded so that
//     four CTAs share an SM), and one CTA's softmax overlaps another's
//     products and loads; this
//     keeps 64-row tiles (a 257-row input wastes one 64-row tile, 128-row
//     CTAs would waste a third); no software pipelining inside the
//     warpgroup: the overlap across resident CTAs does that job at these
//     short key loops (5 tiles at N = 257, 9 at 513), and a version that
//     kept the next tile's s product in flight during this tile's softmax
//     (two score accumulators, two p~ fragments) measured 0.151 against
//     0.136 ms per b128 call at N = 257, its registers leaving room for
//     three CTAs per SM, not four; a ring of two stages, since the producer
//     keeps one stage ahead (three measured no faster).  L (m + log2 l,
//     times ln 2) is written by the lanes holding each row when asked.
//   TMA needs the 3C x 2-byte row stride to be a multiple of 16 bytes and a
//   16-byte aligned base (the wrapper checks both; this file refuses them).
//
// bf16 at head_dim 80 (ViT-H; in the chip checks' grids, on no model path):
// qkv_attention_fwd_mma_kernel, the earlier tensor-core body, kept because a
// 160-byte row fits neither TMA swizzle span as one box (two boxes a row,
// or no swizzle, would fit: a follow-up in ROADMAP): four warps of 16 query
// rows, mma.sync m16n8k16 fed by ldmatrix from cp.async double-buffered
// padded tiles (attention_mma.cuh), two sweeps over the keys (m and l, then the
// normalised p, rounded, as the A operand of p.v), expf.  It writes no L;
// its backward rebuilds the statistics itself.
//
// f32 (the parity checks, which hold it to plain at 1e-5 and need equal
// pruning indices): tensor-core f32 would be TF32, so it stays on exact FMA
// loops with the Q tile in shared memory as f32, K (and V) streamed, each
// thread owning a 4 x 4 register micro-tile (rows ty + 16i, keys or head
// dims tx + 16j) over shared rows padded by one float; two sweeps over the
// keys, as the mma.sync body.  It writes no L.

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "attention_mma.cuh"
#include "attention_wgmma.cuh"
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

// ---- bf16 at head_dim 80: the mma.sync body ------------------------------

// Shared memory of the mma.sync body, in bytes: the Q tile, two K and two V
// tiles, and the 4 warps' column sums of one key tile.
template <int D>
struct SmemMma {
  static constexpr size_t kTile = mma::Tile<D>::kBytes;
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + kTile;
  static constexpr size_t kV = kK + 2 * kTile;
  static constexpr size_t kRed = kV + 2 * kTile;
  static constexpr size_t kBytes =
      kRed + mma::kWarps * mma::kRows * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(mma::kThreads)
    qkv_attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                                  __nv_bfloat16* __restrict__ out,
                                  float* __restrict__ colsum, int n,
                                  int num_heads, int mode, int extra,
                                  int kv_valid, float scale) {
  using mma::bf16;
  using S = SmemMma<D>;
  constexpr int kElems = mma::Tile<D>::kElems;
  constexpr int kR = mma::kRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw + S::kQ);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw + S::kK);
  bf16* vs = reinterpret_cast<bf16*>(smem_raw + S::kV);
  float* red = reinterpret_cast<float*>(smem_raw + S::kRed);

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = num_heads * D;
  const size_t stride = 3 * static_cast<size_t>(c);
  const bf16* q_src =
      qkv + static_cast<size_t>(b) * n * stride + static_cast<size_t>(h) * D;
  const bf16* k_src = q_src + c;
  const bf16* v_src = q_src + 2 * c;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t2 = (lane & 3) * 2;
  const int q0 = qt * kR;
  const int row0 = q0 + warp * 16 + (lane >> 2);  // and row0 + 8
  const int nkt = (kv_valid + kR - 1) / kR;  // key tiles with a valid key
  const int stages = 2 * nkt;  // pass 1 streams K, pass 2 K and V
  const size_t score_at =
      mode == kModePatchMean
          ? ((static_cast<size_t>(b) * num_heads + h) * gridDim.x + qt) * n
          : (static_cast<size_t>(b) * num_heads + h) * n;
  const bool writes_scores =
      mode == kModePatchMean || (mode == kModeCls && qt == 0);

  mma::load_tile<D>(qs, q_src, stride, q0, n);
  mma::load_tile<D>(ks, k_src, stride, 0, n);
  mma::cp_async_commit();

  bool score_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    score_row[i] = row >= extra && row < kv_valid;
  }
  uint32_t qa[D / 16][4];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float inv[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int st = 0; st < stages; ++st) {
    const int next = st + 1;
    if (next < stages) {
      const int kt = next < nkt ? next : next - nkt;
      mma::load_tile<D>(ks + (next & 1) * kElems, k_src, stride, kt * kR, n);
      if (next >= nkt)
        mma::load_tile<D>(vs + (next & 1) * kElems, v_src, stride, kt * kR,
                          n);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // stage st (and Q) landed
    __syncthreads();
    if (st == 0) mma::load_a<D>(qa, qs, warp * 16, lane);
    const bool pass2 = st >= nkt;
    const int k0 = (pass2 ? st - nkt : st) * kR;
    const bf16* kt_s = ks + (st & 1) * kElems;
    const bf16* vt_s = vs + (st & 1) * kElems;
    if (st == nkt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) inv[i] = 1.f / mma::quad_sum(l[i]);
    }
#pragma unroll
    for (int ch = 0; ch < kR / 16; ++ch) {
      const int kb = k0 + ch * 16;
      if (kb >= kv_valid) break;  // the rest of the tile is masked
      float s[2][4];
      mma::product_nt<D>(s, qa, kt_s, ch * 16, lane);
      bool valid[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          valid[j][e] = kb + 8 * j + t2 + e < kv_valid;
          s[j][e] *= scale;
          s[j][2 + e] *= scale;
        }
      if (!pass2) {
        // running max and (per-lane partial) denominator of both rows
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
          // key 0 is valid, so m is finite from the first chunk on
          const float m_new = fmaxf(m[i], mma::quad_max(mt[i]));
          l[i] *= expf(m[i] - m_new);
          m[i] = m_new;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (valid[j][e]) {
              l[0] += expf(s[j][e] - m[0]);
              l[1] += expf(s[j][2 + e] - m[1]);
            }
        continue;
      }
      // pass 2: normalised p, its score sums, p.v
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][e] = valid[j][e] ? expf(s[j][e] - m[0]) * inv[0] : 0.f;
          s[j][2 + e] = valid[j][e] ? expf(s[j][2 + e] - m[1]) * inv[1] : 0.f;
        }
      if (mode == kModePatchMean) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[2 * j + e] = (score_row[0] ? s[j][e] : 0.f) +
                           (score_row[1] ? s[j][2 + e] : 0.f);
        const float sum = mma::column_sums4(v, lane);
        if ((lane & 4) == 0)
          red[warp * kR + ch * 16 + 8 * ((lane >> 4) & 1) + t2 +
              ((lane >> 3) & 1)] = sum;
      } else if (mode == kModeCls && qt == 0 && warp == 0 && lane < 4) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            red[ch * 16 + 8 * j + t2 + e] = s[j][e];  // query row 0
      }
      uint32_t pa[4];
      mma::to_a(pa, s);
      mma::product_nn<D>(o, pa, vt_s, ch * 16, lane);
    }
    __syncthreads();  // buffers st & 1 and the column sums are complete
    if (pass2 && writes_scores && tid < kR) {
      const int key = k0 + tid;
      if (key < n) {
        float v = 0.f;  // keys at or past kv_valid have p = 0
        if (key < kv_valid)
          v = mode == kModePatchMean ? red[tid] + red[kR + tid] +
                                           red[2 * kR + tid] + red[3 * kR + tid]
                                     : red[tid];
        colsum[score_at + key] = v;
      }
    }
  }
  if (writes_scores)
    for (int key = nkt * kR + tid; key < n; key += mma::kThreads)
      colsum[score_at + key] = 0.f;

  mma::store_rows<D>(out + static_cast<size_t>(b) * n * c +
                         static_cast<size_t>(h) * D,
                     c, o, q0 + warp * 16, n, 1.f, lane);
}

template <int D>
cudaError_t launch_mma(const void* qkv, void* out, void* colsum, int batch,
                        int n, int num_heads, int mode, int extra,
                        int kv_valid, float scale, cudaStream_t stream) {
  auto kernel = qkv_attention_fwd_mma_kernel<D>;
  constexpr size_t smem = SmemMma<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + mma::kRows - 1) / mma::kRows, num_heads, batch);
  kernel<<<grid, mma::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(colsum), n, num_heads, mode, extra, kv_valid, scale);
  return cudaGetLastError();
}

// ---- bf16 at head_dim 32 and 64: wgmma, TMA, one sweep without scores ----

// Shared memory of the wgmma body past its 1024-byte aligned base: the Q
// tile, the ring's stages of (K tile, V tile), and the 4 warps' column sums
// of one key tile.
template <int D>
struct SmemWgmma {
  static constexpr uint32_t kTile = wgmma::Tile<D>::kBytes;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kStage0 = kTile;  // stage s: K at + 2 s kTile
  static constexpr uint32_t kRed = kStage0 + wgmma::kStages * 2 * kTile;
  static constexpr size_t kBytes =
      kRed + 4 * wgmma::kRows * sizeof(float) + 1024;  // + the alignment
};

// At least four CTAs per SM (at most 102 registers a thread, no spills at
// D 32 or 64): 11% less time per b128 call at N = 257 than the 105
// registers ptxas takes unbounded, which fit three (NVIDIA H100 80GB HBM3,
// 700 W).
template <int D>
__global__ void __launch_bounds__(wgmma::kThreads, 4)
    qkv_attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map,
                                   __nv_bfloat16* __restrict__ out,
                                   float* __restrict__ colsum,
                                   float* __restrict__ lse, int n,
                                   int num_heads, int mode, int extra,
                                   int kv_valid, float scale_log2) {
  using S = SmemWgmma<D>;
  constexpr uint32_t kT = S::kTile;
  constexpr int kR = wgmma::kRows;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[wgmma::kStages], empty[wgmma::kStages], qbar;
  const uint32_t raw = hopper::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t base = hopper::smem_addr(smem);
  float* red = reinterpret_cast<float*>(smem + S::kRed);

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = num_heads * D;
  const int q0 = qt * kR;
  const int nkt = (kv_valid + kR - 1) / kR;  // key tiles with a valid key
  const bool two_pass = mode != kModeNone;
  const int stages = two_pass ? 2 * nkt : nkt;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < wgmma::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], wgmma::kConsumers / 32);
    }
    hopper::mbar_init(&qbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= wgmma::kConsumers) {  // the producer warp
    if (threadIdx.x == wgmma::kConsumers) {
      hopper::mbar_arrive_expect_tx(&qbar, kT);
      wgmma::tma_load_3d(smem + S::kQ, &map, &qbar, h * D, q0, b);
      for (int st = 0; st < stages; ++st) {
        const int s = st % wgmma::kStages;
        hopper::mbar_wait(&empty[s], ((st / wgmma::kStages) & 1) ^ 1);
        const bool pass2 = two_pass && st >= nkt;
        const bool with_v = !two_pass || pass2;
        const int k0 = (pass2 ? st - nkt : st) * kR;
        unsigned char* ks = smem + S::kStage0 + s * 2 * kT;
        hopper::mbar_arrive_expect_tx(&full[s], with_v ? 2 * kT : kT);
        wgmma::tma_load_3d(ks, &map, &full[s], c + h * D, k0, b);
        if (with_v)
          wgmma::tma_load_3d(ks + kT, &map, &full[s], 2 * c + h * D, k0, b);
      }
    }
    return;
  }

  // the consumer warpgroup: warp w holds rows q0 + 16 w + g and + 8
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t2 = 2 * (lane & 3);
  const int row0 = q0 + warp * 16 + (lane >> 2);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // m: the running row max of s c; l: this lane's share of the row sum
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float sc[32];
  auto stage_k = [&](int st) {
    return base + S::kStage0 + (st % wgmma::kStages) * 2 * kT;
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st % wgmma::kStages]);
  };
  // s = q . k^T of the key tile in stage st, issued (not waited for)
  auto issue_s = [&](int st) {
    hopper::mbar_wait(&full[st % wgmma::kStages], (st / wgmma::kStages) & 1);
    hopper::wgmma_fence();
    wgmma::product_nt<D>(sc, base + S::kQ, stage_k(st));
    hopper::wgmma_commit();
  };
  // keys at or past kv_valid in the tile at k0 get s = -inf (p = 0)
  auto mask = [&](int k0) {
    if (k0 + kR > kv_valid) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + 8 * j + t2 + e >= kv_valid)
            sc[4 * j + e] = sc[4 * j + 2 + e] = -INFINITY;
    }
  };
  // the online statistics of the tile in sc: m grows, l and (returned)
  // the factor 2^(m_old - m_new) that rescales the output, p~ = 2^(s c - m)
  // into sc
  auto online = [&](float (&alpha)[2]) {
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mt[0] = fmaxf(mt[0], sc[4 * j + e]);
        mt[1] = fmaxf(mt[1], sc[4 * j + 2 + e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // every visited tile holds a valid key, so the max is finite
      const float m_new = fmaxf(m[i], wgmma::quad_max(mt[i]) * scale_log2);
      alpha[i] = wgmma::ex2(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float p =
              wgmma::ex2(fmaf(sc[4 * j + 2 * i + e], scale_log2, -m[i]));
          l[i] += p;
          sc[4 * j + 2 * i + e] = p;
        }
  };

  hopper::mbar_wait(&qbar, 0);
  if (!two_pass) {
    // ONE sweep: per key tile s, the statistics, the output rescaled, then
    // p~.v
    for (int st = 0; st < nkt; ++st) {
      issue_s(st);
      hopper::wgmma_wait<0>();
      wgmma::fence_acc(sc);
      mask(st * kR);
      float alpha[2];
      online(alpha);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      uint32_t pa[4][4];
      wgmma::to_a(pa, sc);
      hopper::wgmma_fence();
      wgmma::product_nn<D>(o, pa, stage_k(st) + kT);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      wgmma::fence_acc(o);
      release(st);
    }
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = wgmma::quad_sum(l[i]);
      inv[i] = 1.f / l[i];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= inv[0];
      o[4 * j + 1] *= inv[0];
      o[4 * j + 2] *= inv[1];
      o[4 * j + 3] *= inv[1];
    }
  } else {
    // two sweeps: m and l from the K tiles alone, then the normalised p,
    // its score sums and round(p).v
    const size_t score_at =
        mode == kModePatchMean
            ? ((static_cast<size_t>(b) * num_heads + h) * gridDim.x + qt) * n
            : (static_cast<size_t>(b) * num_heads + h) * n;
    const bool writes_scores = mode == kModePatchMean || qt == 0;
    bool score_row[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      score_row[i] = row >= extra && row < kv_valid;
    }
    float alpha[2];
    for (int st = 0; st < nkt; ++st) {
      issue_s(st);
      hopper::wgmma_wait<0>();
      wgmma::fence_acc(sc);
      release(st);
      mask(st * kR);
      online(alpha);
    }
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = wgmma::quad_sum(l[i]);
      inv[i] = 1.f / l[i];
    }
    for (int st = nkt; st < stages; ++st) {
      const int k0 = (st - nkt) * kR;
      issue_s(st);
      hopper::wgmma_wait<0>();
      wgmma::fence_acc(sc);
      mask(k0);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            sc[4 * j + 2 * i + e] =
                wgmma::ex2(fmaf(sc[4 * j + 2 * i + e], scale_log2, -m[i])) *
                inv[i];
      if (mode == kModePatchMean) {
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          float v[4];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int at = 4 * (2 * ch + jj) + e;
              v[2 * jj + e] = (score_row[0] ? sc[at] : 0.f) +
                              (score_row[1] ? sc[at + 2] : 0.f);
            }
          const float sum = mma::column_sums4(v, lane);
          if ((lane & 4) == 0)
            red[warp * kR + ch * 16 + 8 * ((lane >> 4) & 1) + t2 +
                ((lane >> 3) & 1)] = sum;
        }
      } else if (writes_scores && warp == 0 && lane < 4) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            red[8 * j + t2 + e] = sc[4 * j + e];  // query row 0
      }
      uint32_t pa[4][4];
      wgmma::to_a(pa, sc);
      hopper::wgmma_fence();
      wgmma::product_nn<D>(o, pa, stage_k(st) + kT);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      wgmma::fence_acc(o);
      release(st);
      if (writes_scores) {
        hopper::named_barrier_sync(1, wgmma::kConsumers);  // red complete
        if (tid < kR && k0 + tid < n) {
          float v = 0.f;  // keys at or past kv_valid have p = 0
          if (k0 + tid < kv_valid)
            v = mode == kModePatchMean
                    ? red[tid] + red[kR + tid] + red[2 * kR + tid] +
                          red[3 * kR + tid]
                    : red[tid];
          colsum[score_at + k0 + tid] = v;
        }
        hopper::named_barrier_sync(1, wgmma::kConsumers);  // red read
      }
    }
    if (writes_scores)
      for (int key = nkt * kR + tid; key < n; key += wgmma::kConsumers)
        colsum[score_at + key] = 0.f;
  }

  wgmma::store_tile<D>(out + static_cast<size_t>(b) * n * c +
                           static_cast<size_t>(h) * D,
                       c, o, q0, n, 1.f);
  if (lse != nullptr && (lane & 3) == 0) {
    float* dst = lse + (static_cast<size_t>(b) * num_heads + h) * n;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row < n) dst[row] = (m[i] + log2f(l[i])) * 0.69314718055994531f;
    }
  }
}

template <int D>
cudaError_t launch_wgmma(const void* qkv, void* out, void* colsum, void* lse,
                         int batch, int n, int num_heads, int mode, int extra,
                         int kv_valid, float scale, cudaStream_t stream) {
  const int c = num_heads * D;
  if ((3 * c) % 8 != 0 || reinterpret_cast<uintptr_t>(qkv) % 16 != 0)
    return cudaErrorInvalidValue;  // TMA: 16-byte row stride and base
  CUtensorMap map;
  cudaError_t err = wgmma::head_tile_map<D>(&map, qkv, batch, n, 3 * c);
  if (err != cudaSuccess) return err;
  auto kernel = qkv_attention_fwd_wgmma_kernel<D>;
  constexpr size_t smem = SmemWgmma<D>::kBytes;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + wgmma::kRows - 1) / wgmma::kRows, num_heads, batch);
  kernel<<<grid, wgmma::kThreads, smem, stream>>>(
      map, static_cast<__nv_bfloat16*>(out), static_cast<float*>(colsum),
      static_cast<float*>(lse), n, num_heads, mode, extra, kv_valid,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
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

// Query rows per CTA (64 in every body): the patch_mean partial buffer
// holds ceil(n / this) q-tiles, so the wrapper sizes it from here and
// nowhere else.
static_assert(kBQ == mma::kRows && kBQ == wgmma::kRows,
              "every body tiles 64 query rows");
extern "C" int tpat_qkv_attention_qtile() { return kBQ; }

// 1 where the forward writes, and the backward reads, the row log-sum-exp
// and the output (wgmma::takes), else 0.
extern "C" int tpat_qkv_attention_reads_lse(int dtype, int head_dim) {
  return wgmma::takes(dtype, head_dim) ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16.  mode: 0 = none, 1 = patch_mean,
// 2 = cls.  colsum: (batch, num_heads, n_qtiles, n) f32 for patch_mean, with
// n_qtiles = ceil(n / tpat_qkv_attention_qtile()),
// (batch, num_heads, 1, n) for cls, unused for none.  lse: (batch,
// num_heads, n) f32 or null; only the body that writes it (bf16 at
// head_dim 32 and 64) takes one.  kv_valid in (extra, n]: keys
// [0, kv_valid) are valid (n for the plain form).  The bf16 body at
// head_dim 32 and 64 also needs qkv 16-byte aligned and 3 * num_heads *
// head_dim a multiple of 8 (TMA).  Returns the CUDA error of the launch (0
// on success).
extern "C" int tpat_qkv_attention_fwd(const void* qkv, void* out, void* colsum,
                                      void* lse, int batch, int n,
                                      int num_heads, int head_dim, int dtype,
                                      int mode, int extra, int kv_valid,
                                      float scale, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || num_heads < 1 ||
      num_heads > 65535 || mode < kModeNone || mode > kModeCls || extra < 0 ||
      kv_valid <= extra || kv_valid > n ||
      (mode != kModeNone && colsum == nullptr) ||
      (lse != nullptr && !wgmma::takes(dtype, head_dim))) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 32)
    return launch<float, 32>(qkv, out, colsum, batch, n, num_heads, mode,
                             extra, kv_valid, scale, s);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(qkv, out, colsum, batch, n, num_heads, mode,
                             extra, kv_valid, scale, s);
  if (dtype == 0 && head_dim == 80)
    return launch<float, 80>(qkv, out, colsum, batch, n, num_heads, mode,
                             extra, kv_valid, scale, s);
  if (dtype == 1 && head_dim == 32)
    return launch_wgmma<32>(qkv, out, colsum, lse, batch, n, num_heads, mode,
                            extra, kv_valid, scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch_wgmma<64>(qkv, out, colsum, lse, batch, n, num_heads, mode,
                            extra, kv_valid, scale, s);
  if (dtype == 1 && head_dim == 80)
    return launch_mma<80>(qkv, out, colsum, batch, n, num_heads, mode, extra,
                          kv_valid, scale, s);
  return cudaErrorInvalidValue;
}
