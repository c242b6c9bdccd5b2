// Attention probe kernels for Hopper (sm_90a): the counterparts of the two
// Pallas probes of the fused attention forward,
//   scripts/probe_attn_softmax.py::_variant_kernel  (P1: six softmax variants)
//   scripts/probe_attn_grouping.py::_kernel         (P2: CTA geometry)
// built on the body of the B1 forward (csrc/qkv_attention.cu) without its
// prefix and 'cls' forms, with the softmax variant, the query-tile height and
// the heads per CTA as template parameters.
//
// What it computes, per (batch b, head h), from packed qkv (B, N, 3C), C = H
// D, D = 64: logits = q . k^T * scale in f32 (scale = D^-1/2, times log2(e)
// for exp2), then p by variant
//   full, noscore  softmax: exp(logits - rowmax), times 1 / rowsum
//   exp2           exp2(logits - rowmax), times 1 / rowsum (the same values)
//   noexp          logits - rowmax, not normalised (wrong math: a cost bound)
//   nomax          exp(logits), times 1 / rowsum (no max: a cost bound)
//   mmonly         logits (no softmax at all: the product floor)
// and out = cast_to_input_dtype(p) . v, accumulated in f32, written in the
// input dtype as (B, N, C).  'full' also writes the column sums of the f32 p
// over the query rows 1..N-1 (the probe's unnormalised importance) into an
// f32 partial buffer (B, H, n_qtiles, N) that the wrapper sums over q-tiles:
// no atomics.
//
// bf16 (P1 and P2): B1's tensor-core kernel, so that the probes take apart
// the kernel the model runs.  What bounds it at the probe's shapes (B = 128,
// N = 257 or 181, H = 12) is bytes: one call moves ~200 MB of q, k, v and
// out and does ~26 GFLOP on the tensor cores.  One CTA = one (b, group of
// HPB heads, tile of ROWS query rows), one warp per 16 query rows (ROWS =
// 64: B1's four warps).  Q, K and V are staged in shared memory as bf16 by
// 16-byte cp.async copies into padded rows (attention_mma.cuh), K and V in
// 64-key tiles, double-buffered so that the copy of one tile overlaps the
// products of the one before.  q.k^T and p.v run as mma.sync m16n8k16 with
// f32 accumulation, fed by ldmatrix; the Q fragments stay in registers.  A
// head takes B1's two sweeps over its key tiles: the first keeps each row's
// running max and (per-lane) denominator on the accumulator fragments, or
// only what the variant needs; the second recomputes the same logits, turns
// them into p, sums the 'full' columns (a reduce-scatter over the warp's
// quads, then the warps through shared memory) and rounds p into the A
// operand of p.v.  'mmonly' has no first sweep and streams K and V once.
// The heads of a CTA run one after the other, and the copy of the next
// head's Q tile and first K tile is issued while this head's last tile is
// consumed, so that more heads per CTA (HPB) means fewer, longer CTAs with
// one pipeline, as the TPU probe's batch group meant fewer, longer programs.
// A row's logits, max, denominator and p.v come from the same code in the
// same order whatever ROWS and HPB are, and 'full' and 'noscore' are B1's
// arithmetic: the nine P2 geometries give the same bits, and P1's 'full'
// and 'noscore' the same out bits as B1.
//
// f32 (P1 only, the exactness checks): tensor-core f32 would be TF32, so it
// keeps B1's FMA kernel (qkv_attention_common.cuh): the Q tile in shared
// memory as f32, K (and V) streamed, each thread owning a 4 x 4 register
// micro-tile (rows ty + 16 i, keys or head dims tx + 16 j).

#include <cmath>
#include <cstddef>

#include "attention_mma.cuh"
#include "qkv_attention_common.cuh"

namespace {

constexpr int kD = 64;   // head dim of the probe (C = 768, H = 12)
constexpr int kBK = 64;  // keys per streamed tile
constexpr int kVariantRows = 64;  // P1's query tile: the B1 kernel's

enum Variant { kFull = 0, kNoScore, kExp2, kNoExp, kNoMax, kMmOnly };

template <int V>
__device__ __forceinline__ float expo(float v) {
  return V == kExp2 ? exp2f(v) : expf(v);
}

// Whether a variant keeps the row max, and whether it normalises by the row
// sum (and so keeps the denominator).
template <int V>
struct Softmax {
  static constexpr bool kMax =
      V == kFull || V == kNoScore || V == kExp2 || V == kNoExp;
  static constexpr bool kNorm =
      V == kFull || V == kNoScore || V == kExp2 || V == kNoMax;
};

// p of one logit by variant, given the row's max m (0 without one) and
// 1 / rowsum inv (1 without one).
template <int V>
__device__ __forceinline__ float prob(float s, float m, float inv) {
  if (V == kNoExp) return s - m;
  if (V == kMmOnly) return s;
  return expo<V>(s - m) * inv;
}

// ---------------------------------------------------------------------------
// f32: the FMA body at 64-row query tiles, one head per CTA

// Shared-memory layout in floats.
struct Smem {
  static constexpr int kLd = kD + 1;    // padded Q/K rows
  static constexpr int kPLd = kBK + 1;  // padded p rows
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kVariantRows * kLd;
  static constexpr int kV = kK + kBK * kLd;
  static constexpr int kP = kV + kBK * kD;
  static constexpr int kRed = kP + kVariantRows * kPLd;
  static constexpr int kFloats = kRed + 4 * kBK;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <int V>
__global__ void __launch_bounds__(kThreads)
    attn_probe_f32_kernel(const float* __restrict__ qkv,
                          float* __restrict__ out, float* __restrict__ colsum,
                          int n, int num_heads, float scale) {
  constexpr int RI = kVariantRows / 16;
  constexpr int kDj = kD / 16;
  constexpr bool kMax = Softmax<V>::kMax;
  constexpr bool kNorm = Softmax<V>::kNorm;
  using S = Smem;
  extern __shared__ float smem[];
  float* qs = smem + S::kQ;
  float* ks = smem + S::kK;
  float* vs = smem + S::kV;
  float* ps = smem + S::kP;
  float* red = smem + S::kRed;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = num_heads * kD;
  const size_t row_stride = 3 * static_cast<size_t>(c);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = qt * kVariantRows;
  const float* q_src = qkv + static_cast<size_t>(b) * n * row_stride +
                       static_cast<size_t>(h) * kD;
  const float* k_src = q_src + c;
  const float* v_src = q_src + 2 * c;
  load_rows<float, kD>(qs, S::kLd, q_src, row_stride, q0, kVariantRows, n);

  // pass 1: running row max (nomax: 0) and denominator
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kMax ? -INFINITY : 0.f;
    l[i] = 0.f;
  }
  if (kMax || kNorm) {
    for (int k0 = 0; k0 < n; k0 += kBK) {
      __syncthreads();  // previous tile fully consumed (and Q loaded)
      load_rows<float, kD>(ks, S::kLd, k_src, row_stride, k0, kBK, n);
      __syncthreads();
      float s[RI][4];
      tile_logits<kD, RI>(qs, ks, tx, ty, scale, s);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        float m_new = m[i];
        if (kMax) {
          float mt = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (k0 + tx + 16 * j < n) mt = fmaxf(mt, s[i][j]);
          m_new = fmaxf(m[i], row_max(mt));  // key 0 exists: finite
        }
        if (kNorm) {
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (k0 + tx + 16 * j < n) sum += expo<V>(s[i][j] - m_new);
          l[i] = (kMax ? l[i] * expo<V>(m[i] - m_new) : l[i]) + row_sum(sum);
        }
        m[i] = m_new;
      }
    }
  }

  // pass 2: p by variant, p.v and (full) the column sums
  float inv[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) inv[i] = kNorm ? 1.f / l[i] : 1.f;
  float o[RI][kDj];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < kDj; ++j) o[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBK) {
    __syncthreads();
    load_rows<float, kD>(ks, S::kLd, k_src, row_stride, k0, kBK, n);
    load_rows<float, kD>(vs, kD, v_src, row_stride, k0, kBK, n);
    __syncthreads();
    float s[RI][4];
    tile_logits<kD, RI>(qs, ks, tx, ty, scale, s);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * S::kPLd + tx + 16 * j] =
            k0 + tx + 16 * j < n ? prob<V>(s[i][j], m[i], inv[i]) : 0.f;
    __syncthreads();

    const int kn = min(kBK, n - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float p[RI], v[kDj];
#pragma unroll
      for (int i = 0; i < RI; ++i) p[i] = ps[(ty + 16 * i) * S::kPLd + kk];
#pragma unroll
      for (int j = 0; j < kDj; ++j) v[j] = vs[kk * kD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kDj; ++j) o[i][j] = fmaf(p[i], v[j], o[i][j]);
    }

    if (V == kFull) {
      // four partial sums of 16 rows per key column, then one per column;
      // query row 0 is left out
      const int col = tid & (kBK - 1);
      const int part = tid / kBK;
      float acc = 0.f;
      for (int r = part * 16; r < part * 16 + 16; ++r) {
        const int row = q0 + r;
        if (row >= 1 && row < n) acc += ps[r * S::kPLd + col];
      }
      red[part * kBK + col] = acc;
      __syncthreads();
      if (tid < kBK && k0 + tid < n) {
        const size_t at =
            ((static_cast<size_t>(b) * num_heads + h) * gridDim.x + qt) * n;
        colsum[at + k0 + tid] = red[tid] + red[kBK + tid] +
                                red[2 * kBK + tid] + red[3 * kBK + tid];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < n) {
      float* dst = out + (static_cast<size_t>(b) * n + row) * c +
                   static_cast<size_t>(h) * kD;
#pragma unroll
      for (int j = 0; j < kDj; ++j) dst[tx + 16 * j] = o[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: B1's tensor-core body at ROWS query rows and HPB heads per CTA

// Shared memory in bytes: the Q tile of ROWS rows, two K and two V tiles of
// 64 keys, and for 'full' the warps' column sums of one key tile.
template <int ROWS, int V>
struct SmemTc {
  static constexpr size_t kQ = 0;
  static constexpr size_t kK =
      kQ + ROWS * mma::Tile<kD>::kLd * sizeof(mma::bf16);
  static constexpr size_t kV = kK + 2 * mma::Tile<kD>::kBytes;
  static constexpr size_t kRed = kV + 2 * mma::Tile<kD>::kBytes;
  static constexpr size_t kBytes =
      kRed + (V == kFull ? ROWS / 16 * kBK * sizeof(float) : 0);
};

template <int ROWS, int HPB, int V>
__global__ void __launch_bounds__(32 * (ROWS / 16))
    attn_probe_bf16_kernel(const __nv_bfloat16* __restrict__ qkv,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ colsum, int n, int num_heads,
                           float scale) {
  using mma::bf16;
  using S = SmemTc<ROWS, V>;
  constexpr int kWarps = ROWS / 16;
  constexpr int kCta = 32 * kWarps;  // threads
  constexpr int kElems = mma::Tile<kD>::kElems;  // one K or V tile
  constexpr bool kMax = Softmax<V>::kMax;
  constexpr bool kNorm = Softmax<V>::kNorm;
  constexpr bool kSweep1 = kMax || kNorm;  // mmonly has no first sweep
  static_assert(ROWS % 16 == 0 && kBK == mma::kRows, "tile geometry");
  // the next head's Q tile lands while this head's last tile is consumed,
  // which must not be the tile whose stage reads Q into registers
  static_assert(HPB == 1 || kSweep1, "heads per CTA need two sweeps a head");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw + S::kQ);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw + S::kK);
  bf16* vs = reinterpret_cast<bf16*>(smem_raw + S::kV);
  float* red = reinterpret_cast<float*>(smem_raw + S::kRed);

  const int qt = blockIdx.x;
  const int b = blockIdx.z;
  const int c = num_heads * kD;
  const size_t stride = 3 * static_cast<size_t>(c);
  // head h0 + hh's q at base + hh * kD, its k at + c, its v at + 2 c
  const int h0 = blockIdx.y * HPB;
  const bf16* base = qkv + static_cast<size_t>(b) * n * stride +
                     static_cast<size_t>(h0) * kD;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t2 = (lane & 3) * 2;
  const int q0 = qt * ROWS;
  const int row0 = q0 + warp * 16 + (lane >> 2);  // and row0 + 8
  const int nkt = (n + kBK - 1) / kBK;
  const int sweep2 = kSweep1 ? nkt : 0;  // a head's first stage of sweep 2
  const int per_head = sweep2 + nkt;
  const int stages = HPB * per_head;

  mma::load_tile_rows<kD, ROWS, kCta>(qs, base, stride, q0, n);
  mma::load_tile_rows<kD, kBK, kCta>(ks, base + c, stride, 0, n);
  if (!kSweep1)  // stage 0 is already sweep 2's
    mma::load_tile_rows<kD, kBK, kCta>(vs, base + 2 * c, stride, 0, n);
  mma::cp_async_commit();

  bool score_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    score_row[i] = row >= 1 && row < n;
  }
  uint32_t qa[kD / 16][4];
  float m[2], l[2], inv[2];
  float o[kD / 8][4];

  for (int st = 0; st < stages; ++st) {
    const int next = st + 1;
    if (next < stages) {
      const int hn = next / per_head;
      const int ln = next - hn * per_head;
      const bf16* q_src = base + hn * kD;
      const int kt = ln < sweep2 ? ln : ln - sweep2;
      if (ln == 0)  // the next head: its Q tile with its first K tile
        mma::load_tile_rows<kD, ROWS, kCta>(qs, q_src, stride, q0, n);
      mma::load_tile_rows<kD, kBK, kCta>(ks + (next & 1) * kElems, q_src + c,
                                         stride, kt * kBK, n);
      if (ln >= sweep2)
        mma::load_tile_rows<kD, kBK, kCta>(vs + (next & 1) * kElems,
                                           q_src + 2 * c, stride, kt * kBK,
                                           n);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // stage st (and its Q) landed
    __syncthreads();
    const int hh = st / per_head;
    const int ls = st - hh * per_head;
    if (ls == 0) {
      mma::load_a<kD>(qa, qs, warp * 16, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[i] = kMax ? -INFINITY : 0.f;
        l[i] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    }
    const bool pass2 = ls >= sweep2;
    const int k0 = (pass2 ? ls - sweep2 : ls) * kBK;
    const bf16* kt_s = ks + (st & 1) * kElems;
    const bf16* vt_s = vs + (st & 1) * kElems;
    if (ls == sweep2) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        inv[i] = kNorm ? 1.f / mma::quad_sum(l[i]) : 1.f;
    }
#pragma unroll
    for (int ch = 0; ch < kBK / 16; ++ch) {
      const int kb = k0 + ch * 16;
      if (kb >= n) break;  // the rest of the tile is past the last key
      float s[2][4];
      mma::product_nt<kD>(s, qa, kt_s, ch * 16, lane);
      bool valid[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          valid[j][e] = kb + 8 * j + t2 + e < n;
          s[j][e] *= scale;
          s[j][2 + e] *= scale;
        }
      if (!pass2) {
        // running max and (per-lane partial) denominator of both rows
        if (kMax) {
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
            // key 0 exists, so m is finite from the first chunk on
            const float m_new = fmaxf(m[i], mma::quad_max(mt[i]));
            if (kNorm) l[i] *= expo<V>(m[i] - m_new);
            m[i] = m_new;
          }
        }
        if (kNorm) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (valid[j][e]) {
                l[0] += expo<V>(s[j][e] - m[0]);
                l[1] += expo<V>(s[j][2 + e] - m[1]);
              }
        }
        continue;
      }
      // sweep 2: p by variant, its column sums ('full'), p.v
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][e] = valid[j][e] ? prob<V>(s[j][e], m[0], inv[0]) : 0.f;
          s[j][2 + e] = valid[j][e] ? prob<V>(s[j][2 + e], m[1], inv[1]) : 0.f;
        }
      if (V == kFull) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[2 * j + e] = (score_row[0] ? s[j][e] : 0.f) +
                           (score_row[1] ? s[j][2 + e] : 0.f);
        const float sum = mma::column_sums4(v, lane);
        if ((lane & 4) == 0)
          red[warp * kBK + ch * 16 + 8 * ((lane >> 4) & 1) + t2 +
              ((lane >> 3) & 1)] = sum;
      }
      uint32_t pa[4];
      mma::to_a(pa, s);
      mma::product_nn<kD>(o, pa, vt_s, ch * 16, lane);
    }
    __syncthreads();  // buffers st & 1 and the column sums are complete
    if (V == kFull && pass2 && tid < kBK && k0 + tid < n) {
      float v = red[tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += red[w * kBK + tid];
      colsum[((static_cast<size_t>(b) * num_heads + h0 + hh) * gridDim.x +
              qt) * n + k0 + tid] = v;
    }
    if (ls == per_head - 1)
      mma::store_rows<kD>(out + static_cast<size_t>(b) * n * c +
                              static_cast<size_t>(h0 + hh) * kD,
                          c, o, q0 + warp * 16, n, 1.f, lane);
  }
}

template <int V>
cudaError_t launch_f32(const void* qkv, void* out, void* colsum, int batch,
                       int n, int num_heads, float scale,
                       cudaStream_t stream) {
  auto kernel = attn_probe_f32_kernel<V>;
  constexpr size_t smem = Smem::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kVariantRows - 1) / kVariantRows, num_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out),
      static_cast<float*>(colsum), n, num_heads, scale);
  return cudaGetLastError();
}

template <int ROWS, int HPB, int V>
cudaError_t launch_bf16(const void* qkv, void* out, void* colsum, int batch,
                        int n, int num_heads, float scale,
                        cudaStream_t stream) {
  auto kernel = attn_probe_bf16_kernel<ROWS, HPB, V>;
  constexpr size_t smem = SmemTc<ROWS, V>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + ROWS - 1) / ROWS, num_heads / HPB, batch);
  kernel<<<grid, 32 * (ROWS / 16), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(colsum), n,
      num_heads, scale);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_variant(int dtype, const void* qkv, void* out,
                           void* colsum, int batch, int n, int num_heads,
                           float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch_f32<V>(qkv, out, colsum, batch, n, num_heads, scale, s);
  return launch_bf16<kVariantRows, 1, V>(qkv, out, colsum, batch, n,
                                         num_heads, scale, s);
}

template <int ROWS>
cudaError_t launch_grouped(int heads, const void* qkv, void* out, int batch,
                           int n, int num_heads, float scale, cudaStream_t s) {
  switch (heads) {
    case 1:
      return launch_bf16<ROWS, 1, kNoScore>(qkv, out, nullptr, batch, n, num_heads, scale, s);
    case 2:
      return launch_bf16<ROWS, 2, kNoScore>(qkv, out, nullptr, batch, n, num_heads, scale, s);
    case 4:
      return launch_bf16<ROWS, 4, kNoScore>(qkv, out, nullptr, batch, n, num_heads, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory of a P2 CTA (bf16, no column sums) with query tiles
// of `rows` (0 for a height the source has no instantiation of).
extern "C" long long tpat_attn_probe_smem(int rows) {
  switch (rows) {
    case 32: return SmemTc<32, kNoScore>::kBytes;
    case 64: return SmemTc<64, kNoScore>::kBytes;
    case 128: return SmemTc<128, kNoScore>::kBytes;
    default: return 0;
  }
}

// Query rows per CTA of the variant kernels: the 'full' partial buffer holds
// ceil(n / this) q-tiles, so the wrapper sizes it from here and nowhere else.
extern "C" int tpat_attn_probe_variant_rows() { return kVariantRows; }

// P1: the six variants at kVariantRows-row query tiles, one head per CTA.  dtype:
// 0 = float32 (FMA), 1 = bfloat16 (tensor cores); variant: 0 full, 1 noscore,
// 2 exp2, 3 noexp, 4 nomax, 5 mmonly.  colsum: (batch, num_heads, n_qtiles, n)
// f32 for 'full' (n_qtiles = ceil(n / tpat_attn_probe_variant_rows())),
// unused otherwise.  scale: the logit scale (D^-1/2, times log2(e) for
// exp2).  bf16 qkv starts on a 16-byte boundary.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int tpat_attn_probe_variant(const void* qkv, void* out,
                                       void* colsum, int batch, int n,
                                       int num_heads, int dtype, int variant,
                                       float scale, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || num_heads < 1 ||
      num_heads > 65535 || (dtype != 0 && dtype != 1) ||
      (variant == kFull && colsum == nullptr))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kFull:
      return launch_variant<kFull>(dtype, qkv, out, colsum, batch, n, num_heads, scale, s);
    case kNoScore:
      return launch_variant<kNoScore>(dtype, qkv, out, colsum, batch, n, num_heads, scale, s);
    case kExp2:
      return launch_variant<kExp2>(dtype, qkv, out, colsum, batch, n, num_heads, scale, s);
    case kNoExp:
      return launch_variant<kNoExp>(dtype, qkv, out, colsum, batch, n, num_heads, scale, s);
    case kNoMax:
      return launch_variant<kNoMax>(dtype, qkv, out, colsum, batch, n, num_heads, scale, s);
    case kMmOnly:
      return launch_variant<kMmOnly>(dtype, qkv, out, colsum, batch, n, num_heads, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// P2: softmax attention without scores (the noscore body), bf16, at query
// tiles of `rows` in {32, 64, 128} and `heads` in {1, 2, 4} heads per CTA
// (num_heads a multiple of it); qkv starts on a 16-byte boundary.
extern "C" int tpat_attn_probe_grouped(const void* qkv, void* out, int batch,
                                       int n, int num_heads, int rows,
                                       int heads, float scale, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || heads < 1 || num_heads < 1 ||
      num_heads % heads || num_heads / heads > 65535)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 32: return launch_grouped<32>(heads, qkv, out, batch, n, num_heads, scale, s);
    case 64: return launch_grouped<64>(heads, qkv, out, batch, n, num_heads, scale, s);
    case 128: return launch_grouped<128>(heads, qkv, out, batch, n, num_heads, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
