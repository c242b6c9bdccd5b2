// Attention probe kernels for Hopper (sm_90a): the counterparts of the two
// Pallas probes of the fused attention forward,
//   scripts/probe_attn_softmax.py::_variant_kernel  (P1: six softmax variants)
//   scripts/probe_attn_grouping.py::_kernel         (P2: CTA geometry)
// built on the body of the B1 forward (qkv_attention.cu,
// qkv_attention_fwd_wgmma_kernel at D = 64) without its prefix and 'cls'
// forms, with the softmax variant, the query rows and the heads per CTA as
// template parameters, so that each variant and geometry takes apart the
// kernel the model runs.
//
// What it computes, per (batch b, head h), from packed qkv (B, N, 3C), C = H
// D, D = 64: logits = q . k^T * scale in f32 (scale = D^-1/2, times log2(e)
// for exp2), then p by variant
//   full, noscore  softmax: exp(logits - rowmax), times 1 / rowsum
//   exp2           exp2(logits - rowmax), times 1 / rowsum (the same values)
//   noexp          logits - rowmax, not normalised (wrong math: a cost bound)
//   nomax          exp(logits), times 1 / rowsum (no max: a cost bound)
//   mmonly         logits (no softmax at all: the product floor)
// and out = p . v with p rounded to the input dtype, accumulated in f32,
// written in the input dtype as (B, N, C).  'full' also writes the column
// sums of the f32 p over the query rows 1..N-1 (the probe's unnormalised
// importance) into an f32 partial buffer (B, H, n_qtiles, N) that the
// wrapper sums over q-tiles: no atomics.
//
// bf16 (P1 and P2): B1's wgmma/TMA body.  What bounds it at the probe's
// shapes (B = 128, N = 257 or 181, H = 12) is bytes: one call moves ~200 MB
// of q, k, v and out (~60 us at 3.35 TB/s) against ~26 GFLOP on the tensor
// cores (~26 us) and ~100 M exps (~24 us).  So, as in B1, the design cuts
// the passes over the keys and the exps, and keeps the products on wgmma:
//   - A CTA is one (sample, group of HPB heads, tile of ROWS query rows): a
//     producer warp whose one thread issues TMA loads of one head's 64-row
//     tiles straight out of the packed input (head_tile_map: rows past N
//     read as zeros), the K (and V) tiles through a ring of two stages under
//     full/empty mbarriers; consumer warpgroups that run s = q.k^T as wgmma
//     m64n64k16 (Q and K from shared memory, K-major) and p.v as m64n64k16
//     (p from registers, V MN-major), and hand a stage back once its
//     products are done.
//   - The variants keep or drop parts of that body:
//       noscore  B1's mode-none body: ONE sweep, per 64-key tile the running
//                max m of s c (c = D^-1/2 log2 e, computed in float as B1's
//                launcher does), l and O times 2^(m_old - m_new), p~ =
//                2^(s c - m) (one FMA and one ex2.approx) added to l and,
//                rounded to bf16, the A operand of p~.v; O / l at the end;
//       exp2     the same sweep with the scale as the wrapper passes it,
//                log2 e already folded in: at D = 64 the same c, so B1's
//                arithmetic and bits (the row stays because the script has
//                it);
//       full     B1's 'patch_mean' body at extra = 1, kv_valid = N: K alone
//                for the final m and l, then K and V for the normalised f32
//                p, its column sums (mma::column_sums4, the reduce-scatter
//                over the quads that B1 takes from attention_mma.cuh, then
//                the four warps through shared memory) and round(p).v;
//       nomax    one sweep, p~ = 2^(s c) added to l, no max, no rescaling,
//                O / l at the end;
//       mmonly   one sweep of products only: p = s scale rounded, times v;
//       noexp    p = s scale - m with the final row max, not normalised.
//                It takes two sweeps (K alone for m, then K and V) and
//                rounds what the plain version rounds.  The one-sweep form
//                O = sum round(s scale) v - m sum v would round s scale,
//                whose error is relative to |s scale| and not to |s scale -
//                m|, and then cancels m sum v in f32 against a sum of the
//                same size: its error grows with m |sum v|, which the
//                limit for unnormalised outputs (a share of the largest
//                |entry|) does not bound.
//   - The geometries (P2, noscore): ROWS = 64 is B1's CTA, one consumer
//     warpgroup (160 threads); ROWS = 128 runs two consumer warpgroups on
//     their own Q tiles against the same K/V stage (288 threads, a stage's
//     empty barrier counting both warpgroups' 8 warps); ROWS = 32 runs the
//     m64 products on a 64-row Q box that starts at its first row and
//     stores only its own 32 rows (the cost of a half-filled tile, as B1's
//     last tile at N = 257 holds one row).  HPB heads run one after the
//     other with one stage counter across them: the producer loads the
//     next head's Q tile into a second Q buffer and streams its first K/V
//     tiles while the consumers finish the current head.  A row's logits,
//     max, denominator and p.v come from the same code in the same order
//     whatever ROWS and HPB are: the nine geometries give 'noscore''s bits,
//     and 'full' and 'noscore' B1's.
//   - Registers bounded to four CTAs per SM (two at 128 rows), as B1's.
//   TMA needs a 16-byte aligned base and a 3C x 2-byte row stride that is a
//   multiple of 16 bytes (the launcher refuses others).
//
// f32 (P1 only, the exactness checks): tensor-core f32 would be TF32, so it
// keeps B1's FMA kernel (qkv_attention_common.cuh): the Q tile in shared
// memory as f32, K (and V) streamed, each thread owning a 4 x 4 register
// micro-tile (rows ty + 16 i, keys or head dims tx + 16 j).

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "attention_mma.cuh"  // column_sums4 only, as B1's wgmma body
#include "attention_wgmma.cuh"
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
// bf16: B1's wgmma/TMA body at ROWS query rows and HPB heads per CTA

// The CTA's threads and its shared memory past the 1024-byte aligned base:
// the Q tiles (a second buffer for the next head when HPB > 1; one 64-row
// tile per consumer warpgroup), the ring's stages of (K tile, V tile), and
// for 'full' the 4 warps' column sums of one key tile.
template <int ROWS, int HPB, int V>
struct SmemTc {
  static_assert(ROWS == 32 || ROWS == 64 || ROWS == 128, "query rows");
  static constexpr int kGroups = ROWS == 128 ? 2 : 1;  // consumer warpgroups
  static constexpr int kConsumers = 128 * kGroups;
  static constexpr int kThreads = kConsumers + 32;  // + the producer warp
  static constexpr int kQBufs = HPB > 1 ? 2 : 1;
  static constexpr uint32_t kTile = wgmma::Tile<kD>::kBytes;
  static constexpr uint32_t kQ = 0;  // buffer q, warpgroup g: + (q G + g) kTile
  static constexpr uint32_t kStage0 = kQBufs * kGroups * kTile;
  static constexpr uint32_t kRed = kStage0 + wgmma::kStages * 2 * kTile;
  static constexpr size_t kBytes =
      kRed + (V == kFull ? 4 * kBK * sizeof(float) : 0) + 1024;
};

template <int ROWS, int HPB, int V>
__global__ void __launch_bounds__(SmemTc<ROWS, HPB, V>::kThreads,
                                  ROWS == 128 ? 2 : 4)
    attn_probe_bf16_kernel(const __grid_constant__ CUtensorMap map,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ colsum, int n, int num_heads,
                           float coef) {
  // coef: s's factor, c = D^-1/2 log2 e for the exp variants, D^-1/2 for
  // noexp and mmonly
  using S = SmemTc<ROWS, HPB, V>;
  constexpr uint32_t kT = S::kTile;
  constexpr int kR = wgmma::kRows;
  constexpr int kSt = wgmma::kStages;
  // the final row max (and sum) before the first p: K alone, then K and V
  constexpr bool kTwo = V == kFull || V == kNoExp;
  static_assert(V != kFull || ROWS == kR, "'full' sums one warpgroup's rows");
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kSt], empty[kSt], qfull[S::kQBufs],
      qempty[S::kQBufs];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t base = hopper::smem_addr(smem);
  float* red = reinterpret_cast<float*>(smem + S::kRed);

  const int qt = blockIdx.x;
  const int h0 = blockIdx.y * HPB;
  const int b = blockIdx.z;
  const int c = num_heads * kD;
  const int q0 = qt * ROWS;
  const int nkt = (n + kR - 1) / kR;
  const int per_head = kTwo ? 2 * nkt : nkt;  // a head's stages

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kSt; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], S::kConsumers / 32);
    }
#pragma unroll
    for (int q = 0; q < S::kQBufs; ++q) {
      hopper::mbar_init(&qfull[q], 1);
      hopper::mbar_init(&qempty[q], S::kConsumers / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= S::kConsumers) {  // the producer warp
    if (threadIdx.x == S::kConsumers) {
      int st = 0;  // one stage counter across the heads
      for (int hh = 0; hh < HPB; ++hh) {
        const int h = h0 + hh;
        const int qb = hh % S::kQBufs;
        if (hh >= S::kQBufs)  // head hh - kQBufs is done with the buffer
          hopper::mbar_wait(&qempty[qb], (hh / S::kQBufs - 1) & 1);
        hopper::mbar_arrive_expect_tx(&qfull[qb], S::kGroups * kT);
        for (int g = 0; g < S::kGroups; ++g)
          wgmma::tma_load_3d(smem + S::kQ + (qb * S::kGroups + g) * kT, &map,
                             &qfull[qb], h * kD, q0 + g * kR, b);
        for (int i = 0; i < per_head; ++i, ++st) {
          const int s = st % kSt;
          hopper::mbar_wait(&empty[s], ((st / kSt) & 1) ^ 1);
          const bool pass2 = kTwo && i >= nkt;
          const bool with_v = !kTwo || pass2;
          const int k0 = (pass2 ? i - nkt : i) * kR;
          unsigned char* ks = smem + S::kStage0 + s * 2 * kT;
          hopper::mbar_arrive_expect_tx(&full[s], with_v ? 2 * kT : kT);
          wgmma::tma_load_3d(ks, &map, &full[s], c + h * kD, k0, b);
          if (with_v)
            wgmma::tma_load_3d(ks + kT, &map, &full[s], 2 * c + h * kD, k0,
                               b);
        }
      }
    }
    return;
  }

  // the consumer warpgroups: warp w of warpgroup g holds rows q0 + 64 g +
  // 16 w + (lane / 4) and + 8
  const int tid = threadIdx.x;
  const int grp = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int t2 = 2 * (lane & 3);
  const int row0 = q0 + grp * kR + warp * 16 + (lane >> 2);
  const int stored = min(n, q0 + ROWS);  // rows past this are not the CTA's
  float o[kD / 2];
  // m: the running row max of s c (noexp: of s scale); l: this lane's share
  // of the row sum
  float m[2], l[2];
  float sc[32];
  auto stage_k = [&](int st) {
    return base + S::kStage0 + (st % kSt) * 2 * kT;
  };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bar);
  };
  // s = q . k^T of the key tile in stage st, issued and waited for
  auto product_s = [&](int st, uint32_t q_tile) {
    hopper::mbar_wait(&full[st % kSt], (st / kSt) & 1);
    hopper::wgmma_fence();
    wgmma::product_nt<kD>(sc, q_tile, stage_k(st));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    wgmma::fence_acc(sc);
  };
  // O += round(sc) . v of the V tile in stage st, then the stage goes back
  auto product_pv = [&](int st) {
    uint32_t pa[4][4];
    wgmma::to_a(pa, sc);
    hopper::wgmma_fence();
    wgmma::product_nn<kD>(o, pa, stage_k(st) + kT);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    wgmma::fence_acc(o);
    release(&empty[st % kSt]);
  };
  // keys at or past n in the tile at k0 get `fill`
  auto mask = [&](int k0, float fill) {
    if (k0 + kR > n) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + 8 * j + t2 + e >= n) sc[4 * j + e] = sc[4 * j + 2 + e] = fill;
    }
  };
  // the rows' maxima of the tile in sc, over the quad
  auto tile_max = [&](float (&mt)[2]) {
    mt[0] = mt[1] = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mt[0] = fmaxf(mt[0], sc[4 * j + e]);
        mt[1] = fmaxf(mt[1], sc[4 * j + 2 + e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) mt[i] = wgmma::quad_max(mt[i]);
  };
  // B1's online statistics of the tile in sc: m grows, l and (returned)
  // the factor 2^(m_old - m_new) that rescales the output, p~ = 2^(s c - m)
  // into sc
  auto online = [&](float (&alpha)[2]) {
    float mt[2];
    tile_max(mt);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // every tile holds a key, so the max is finite
      const float m_new = fmaxf(m[i], mt[i] * coef);
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
          const float p = wgmma::ex2(fmaf(sc[4 * j + 2 * i + e], coef, -m[i]));
          l[i] += p;
          sc[4 * j + 2 * i + e] = p;
        }
  };
  auto scale_rows = [&](const float (&f)[2]) {
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[4 * j] *= f[0];
      o[4 * j + 1] *= f[0];
      o[4 * j + 2] *= f[1];
      o[4 * j + 3] *= f[1];
    }
  };
  // 1 / the row sums, the lanes' shares summed over the quad
  auto inverse = [&](float (&inv)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = wgmma::quad_sum(l[i]);
      inv[i] = 1.f / l[i];
    }
  };

  int st = 0;
  for (int hh = 0; hh < HPB; ++hh) {
    const int h = h0 + hh;
    const int qb = hh % S::kQBufs;
    const uint32_t q_tile = base + S::kQ + (qb * S::kGroups + grp) * kT;
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
    hopper::mbar_wait(&qfull[qb], (hh / S::kQBufs) & 1);
    if constexpr (!kTwo) {
      // ONE sweep: per key tile s, p (and the statistics), then p.v
      for (int i = 0; i < nkt; ++i, ++st) {
        product_s(st, q_tile);
        if constexpr (V == kNoScore || V == kExp2) {  // B1's online body
          mask(i * kR, -INFINITY);
          float alpha[2];
          online(alpha);
          scale_rows(alpha);
        } else if constexpr (V == kNoMax) {
          mask(i * kR, -INFINITY);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const float p = wgmma::ex2(sc[4 * j + 2 * r + e] * coef);
                l[r] += p;
                sc[4 * j + 2 * r + e] = p;
              }
        } else {  // mmonly
#pragma unroll
          for (int j = 0; j < 32; ++j) sc[j] *= coef;
          mask(i * kR, 0.f);
        }
        product_pv(st);
      }
      if constexpr (V != kMmOnly) {
        float inv[2];
        inverse(inv);
        scale_rows(inv);
      }
    } else {
      // two sweeps: the final m (and l) from the K tiles alone, then p from
      // them and p.v
      for (int i = 0; i < nkt; ++i, ++st) {
        product_s(st, q_tile);
        release(&empty[st % kSt]);
        mask(i * kR, -INFINITY);
        if constexpr (V == kFull) {
          float alpha[2];
          online(alpha);
        } else {
          float mt[2];
          tile_max(mt);
#pragma unroll
          for (int r = 0; r < 2; ++r) m[r] = fmaxf(m[r], mt[r] * coef);
        }
      }
      float inv[2];
      if constexpr (V == kFull) inverse(inv);
      const size_t score_at =
          ((static_cast<size_t>(b) * num_heads + h) * gridDim.x + qt) * n;
      bool score_row[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        score_row[i] = row >= 1 && row < n;
      }
      for (int i = 0; i < nkt; ++i, ++st) {
        const int k0 = i * kR;
        product_s(st, q_tile);
        if constexpr (V == kFull) {
          mask(k0, -INFINITY);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int r = 0; r < 2; ++r)
                sc[4 * j + 2 * r + e] =
                    wgmma::ex2(fmaf(sc[4 * j + 2 * r + e], coef, -m[r])) *
                    inv[r];
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
        } else {  // noexp
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int r = 0; r < 2; ++r)
                sc[4 * j + 2 * r + e] = sc[4 * j + 2 * r + e] * coef - m[r];
          mask(k0, 0.f);
        }
        product_pv(st);
        if constexpr (V == kFull) {
          hopper::named_barrier_sync(1, S::kConsumers);  // red complete
          if (tid < kR && k0 + tid < n)
            colsum[score_at + k0 + tid] = red[tid] + red[kR + tid] +
                                          red[2 * kR + tid] + red[3 * kR + tid];
          hopper::named_barrier_sync(1, S::kConsumers);  // red read
        }
      }
    }
    if (hh + S::kQBufs < HPB) release(&qempty[qb]);  // head hh + 2's buffer
    wgmma::store_tile<kD>(out + static_cast<size_t>(b) * n * c +
                              static_cast<size_t>(h) * kD,
                          c, o, q0, stored, 1.f);
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
  using S = SmemTc<ROWS, HPB, V>;
  const int c = num_heads * kD;
  if ((3 * c) % 8 != 0 || reinterpret_cast<uintptr_t>(qkv) % 16 != 0)
    return cudaErrorInvalidValue;  // TMA: 16-byte row stride and base
  CUtensorMap map;
  cudaError_t err = wgmma::head_tile_map<kD>(&map, qkv, batch, n, 3 * c);
  if (err != cudaSuccess) return err;
  auto kernel = attn_probe_bf16_kernel<ROWS, HPB, V>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(S::kBytes));
  if (err != cudaSuccess) return err;
  // the exp variants take c = scale log2 e in float, as B1's launcher;
  // exp2's scale comes folded
  const bool fold = V == kFull || V == kNoScore || V == kNoMax;
  const dim3 grid((n + ROWS - 1) / ROWS, num_heads / HPB, batch);
  kernel<<<grid, S::kThreads, S::kBytes, stream>>>(
      map, static_cast<__nv_bfloat16*>(out), static_cast<float*>(colsum), n,
      num_heads, fold ? scale * 1.4426950408889634f : scale);
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
// of `rows`, at the most it takes (two Q buffers, as at 2 and 4 heads per
// CTA); 0 for a height the source has no instantiation of.
extern "C" long long tpat_attn_probe_smem(int rows) {
  switch (rows) {
    case 32: return SmemTc<32, 4, kNoScore>::kBytes;
    case 64: return SmemTc<64, 4, kNoScore>::kBytes;
    case 128: return SmemTc<128, 4, kNoScore>::kBytes;
    default: return 0;
  }
}

// Query rows per CTA of the variant kernels: the 'full' partial buffer holds
// ceil(n / this) q-tiles, so the wrapper sizes it from here and nowhere else.
extern "C" int tpat_attn_probe_variant_rows() { return kVariantRows; }

// P1: the six variants at kVariantRows-row query tiles, one head per CTA.  dtype:
// 0 = float32 (FMA), 1 = bfloat16 (wgmma, TMA); variant: 0 full, 1 noscore,
// 2 exp2, 3 noexp, 4 nomax, 5 mmonly.  colsum: (batch, num_heads, n_qtiles, n)
// f32 for 'full' (n_qtiles = ceil(n / tpat_attn_probe_variant_rows())),
// unused otherwise.  scale: the logit scale (D^-1/2, times log2(e) for
// exp2; the launcher folds log2(e) in for the other exp variants).  bf16
// qkv starts on a 16-byte boundary (TMA).  Returns the CUDA error of the
// launch (0 on success).
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
