// Fused swin_v2_cr window attention in its banded form, bf16, forward and
// backward, for Hopper (sm_90a): one launch per direction.
//
// Replaces tpat_tpu/ops/pallas_window_attention.py::_fwd_kernel as
// _banded_impl runs it and ::_banded_bwd_kernel (via _banded_bwd_impl): the
// TPU kernels that every decoder block of an MAE pretrain step at the
// AudioSet grid (N = 512, tokens in window-major order) runs.  The dense
// form in bf16 is window_attention_dense.cu's; f32 (either form) stays on
// the FMA kernels of window_attention.cu and window_attention_bwd.cu.  What
// the two Hopper sources share is window_attention_hopper.cuh's.
//
// What it computes, per (sample b, head h, 128-token chunk u), with q, k, v
// and dO one head's D = 32 values of the chunk's rows, the (H,) f32 scales
// and the f32 band (H, N, 128) (row i's template against its own chunk):
//   q^ = q * rsqrt(max(sum q^2, 1e-24)), k^ likewise, in f32;
//   logit = (q^ . k^) * scale[h] + band[h, i, :];  p = softmax(logit) in f32;
//   out = round(p) . v, accumulated in f32, cast to bf16;
// and, backward, p recomputed, dp = dO . v^T, dlog = p (dp - sum_j dp p) in
// f32, dq^ = dlog scale . k^, dk^ = (dlog scale)^T . q^, the F.normalize VJP
// of each, dv = round(p)^T . dO; d_scale[h] = sum over b, i, j of dlog cos
// and d_band[h] = sum over b of dlog, as the TPU kernel carries them in
// resident accumulators over its sequential batch axis.
//
// What bounds it.  At the AudioSet decoder (B = 32, H = 16, N = 512) a
// forward must read qkv (50.3 MB) and the band (4.2 MB) and write out (16.8
// MB): 71 MB, 21.3 us at 3.35 TB/s; a backward reads qkv, dO and the band
// and writes d_qkv and d_band: 126 MB, 37.6 us.  The useful products are
// tiny: window-major chunks hold whole 4 x 4 windows, so each 16-row block
// of a chunk has exactly one live 16-key block, its own window (8 of a
// chunk's 64 blocks), about 4 D FLOPs a live pair forward and 10 D backward,
// 0.3 and 0.7 GFLOP a call: under a us on the tensor cores.  wgmma is not
// used: its 64-row tiles over a 128-key chunk would compute eight times the
// live products, three times over for the split-bf16 cosine (about 13 GFLOP
// a call against a 21 us byte bound); mma.sync m16n8k16 on the live 16 x 16
// blocks computes only what the result needs.  What the card spends its
// time on is neither: each sample is a chain of dependent steps (the
// copy-out and split, barriers, mma.sync chains, exps, quad shuffles) of
// some thousands of cycles for 8 warps (probe_turns.py --phases counts them
// per step on the card), so what the design does is put independent
// samples side by side and shorten the chain.  Before it, the time went to
// launches (a live-map kernel before each direction, a template-sum kernel
// after the backward) and to a per-sample (B, H, N, 128) f32 dlog partial
// (134 MB at B = 32) written by one kernel and read back by the next.
//
// The design, per direction one kernel, one CTA per (chunk, head, batch
// slice) of two groups of 8 warps (512 threads): the batch is cut into
// `slices` runs of consecutive samples, as few as fill the card's SMs in
// whole waves, and group g of the CTA takes samples g, g + 2, ... of its
// run in batch order, one warp per 16-row block; a chunk's queries are its
// keys.
//   - The band slice (128 x 128 f32) is loaded once per CTA with 16-byte
//     loads into shared memory (rows padded to 132 floats, so the logits'
//     template reads spread over the banks), and each warp of group 0 builds
//     its query block's row of the 8 x 8 live map from it with warp ballots:
//     key block kb is live when one of its 16 x 16 entries is above -1e29,
//     or when one of the 16 rows has no such entry at all (its p is uniform
//     over the chunk, so the whole query block is kept).  A block that is
//     not live has p = 0 exactly and adds exact zeros to every sum, so it
//     is skipped, and its d_band entries are written 0.
//   - A sample's q, k and v (and dO) come as 128-row x 32-value boxes of one
//     head out of the packed (B, N, 3C) qkv and the (B, N, C) dO, through
//     3-D tensor maps with the 64-byte swizzle (16-byte chunk c of row r at
//     c ^ ((r / 2) % 4), so eight consecutive rows of one chunk sit in eight
//     bank groups), into a stage completed on the group's mbarrier.  Each
//     group copies its sample out of the stage into its own padded bf16
//     tiles (rows of 40 values), q and k normalised in f32 and split into
//     hi = bf16(x^) and lo = bf16(x^ - hi) on the way (window_attention_tc
//     .cuh's split_row), and at once loads the sample after next into the
//     freed stage: forward each group has a stage, backward the groups take
//     one stage in turns.  No producer warp: the group's first thread
//     starts the loads.
//   - The arithmetic is the TPU kernel's, typed as in window_attention.cu
//     and window_attention_bwd.cu: cos, dq^ and dk^ as three bf16 mma.sync
//     products hi.hi + hi.lo + lo.hi with f32 accumulation (split_nt,
//     split_nn), dp and dv single bf16 products; the row statistics online
//     over the live key blocks (online_block), one code for both kernels,
//     so the backward's m and l are the forward's bit for bit; p normalised
//     in f32 and rounded to bf16 before p.v and before dv.
//   - Forward: warp qb on query block qb: m and l online, then p and out =
//     round(p).v over the same blocks.  With one live key block (every
//     query block of the model's chunks) the stats sweep's exp(s - m) is
//     already p before the normalisation, the same bits a second sweep
//     would compute, so there is no second sweep.
//   - Backward, when every query block's one live block is its own (the
//     model's chunks): warp qb takes m, l and D_run = sum exp(s - m) dp
//     online (delta = D_run / l), then from the same fragments dlog = p
//     (dp - delta), dq^ += (dlog scale) . k^, and, transposed by movmatrix,
//     dv += round(p)^T . dO and dk^ += (dlog scale)^T . q^.  For any other
//     live map: the same rows sweep (logits and dp again for each live
//     block, dq^), then, the rows' m, 1/l and delta in shared memory, warp
//     kb on key block kb: cos^T = k^.q^T and dp^T = v.dO^T over its live
//     query blocks, dv and dk^.  The choice is the CTA's (its barriers
//     differ); the two loops are apart so that neither holds the other's
//     registers (together they spilled at the 128 a thread of 512).
//   - d_band and d_scale are summed by the CTA over its run in batch order:
//     each group adds its samples' dlog of the live blocks to its own slab
//     of the partial buffer (registers would take 64 a thread), read and
//     written back by the lane that owns the entries (L2-resident, 2 KB a
//     live block and sample against the sample's 56 KB of q, k, v, dO and
//     d_qkv), and its dlog cos to the lane's d_scale share.  Each CTA writes
//     one d_scale partial (its warps in order); an integer ticket per
//     (chunk, head) finds the last CTA, which sums the slabs in (slice,
//     group) order into d_band (0 on the dead blocks) and puts the ticket
//     back to 0.  No floating-point atomics: the same bits from run to run.
//     The wrapper sums the d_scale partials.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_mma.cuh"
#include "attention_wgmma.cuh"
#include "hopper_tma_wgmma.cuh"
#include "window_attention_common.cuh"
#include "window_attention_hopper.cuh"
#include "window_attention_tc.cuh"
#include "window_attention_tc_grad.cuh"

namespace {

using mma::bf16;
using namespace window_attention;

constexpr int kD = 32;          // head_dim: the MAE decoder's 512 / 16
constexpr int kW = kChunk;      // a chunk's rows, queries and keys
constexpr int kNb = kW / kBlk;  // 16-row blocks of a chunk
constexpr int kGroups = 2;      // groups of warps on alternate samples
constexpr int kGroup = 32 * kNb;              // a warp per 16-row block
constexpr int kThreadsB = kGroups * kGroup;   // 512
constexpr int kLd = TcSmem<kD>::kLd;          // padded tile row, bf16 values
constexpr int kTmLd = kW + 4;                 // band row in shared memory
constexpr uint32_t kBox = kW * kD * sizeof(bf16);  // one TMA box, 8 KB

// Shared memory past the 1024-byte aligned base: the stages (each the q, k,
// v and, backward, dO boxes of one sample), the band, and per group the
// padded tiles (q^ hi, q^ lo, k^ hi, k^ lo, v and, backward, dO) and,
// backward, the per-row m, 1/l, delta and q and k normalisation factors;
// then the live map and one d_scale sum per warp.  The forward gives each
// group a stage of its own; in the backward the two groups take one stage
// in turns (a stage each was slower on an H100 when this design was
// brought up), which leaves its larger tiles room.
template <bool kBwd>
struct Smem {
  static constexpr int kIn = kBwd ? 4 : 3;
  static constexpr int kStages = kBwd ? 1 : kGroups;
  static constexpr uint32_t kStage = kIn * kBox;
  static constexpr uint32_t kBand = kStages * kStage;
  static constexpr uint32_t kTile = kW * kLd * sizeof(bf16);
  static constexpr uint32_t kGroupBytes =
      (kBwd ? 6 : 5) * kTile + (kBwd ? 5 : 0) * kW * sizeof(float);
  static constexpr uint32_t kGroupBase = kBand + kW * kTmLd * sizeof(float);
  static constexpr uint32_t kLive = kGroupBase + kGroups * kGroupBytes;
  static constexpr uint32_t kRed = kLive + kNb;
  static constexpr size_t kBytes =
      kRed + (kGroups * kNb + 1) * sizeof(float) + 1024;
  static_assert(kBytes <= kMaxSmem, "the CTA's shared memory");
};

struct Args {
  const float* scale;
  const float* band;
  bf16* out;       // forward: (B, N, C); backward: d_qkv (B, N, 3C)
  float* dband;    // backward: (H, N, 128)
  float* part;     // backward: (slices x kGroups, H, N, 128) accumulators
  float* ds_part;  // backward: (H, units * slices)
  int* tickets;    // backward, slices > 1: (H, units), all 0 between calls
  int batch, n, num_heads, per_slice, slices;
};

// One group's padded tiles in shared memory.
struct Tiles {
  bf16 *qhi, *qlo, *khi, *klo, *vt, *dot;
  float *mrow, *irow, *drow, *qfac, *kfac;  // backward: 1 / l, delta
  __device__ Tiles(unsigned char* base, bool bwd) {
    qhi = reinterpret_cast<bf16*>(base);
    qlo = qhi + kW * kLd;
    khi = qlo + kW * kLd;
    klo = khi + kW * kLd;
    vt = klo + kW * kLd;
    dot = vt + kW * kLd;
    mrow = reinterpret_cast<float*>(bwd ? dot + kW * kLd : dot);
    irow = mrow + kW;
    drow = irow + kW;
    qfac = drow + kW;
    kfac = qfac + kW;
  }
};

// Sample b of the CTA's run into `stage`, completing on `bar`: one thread.
template <bool kBwd>
__device__ __forceinline__ void load_sample(const CUtensorMap* qkv_map,
                                            const CUtensorMap* do_map,
                                            unsigned char* stage,
                                            uint64_t* bar, int b, int row0,
                                            int h, int c) {
  load_boxes(stage, qkv_map, kBwd ? do_map : nullptr, bar, kBox, b, row0, h,
             c);
}

// Warp qb's 16 band rows into shared memory (row stride kTmLd), and its
// query block's row of the live map as 8 bits: key block kb is live when
// one of its entries is above kDead, or when one of the 16 rows has no such
// entry at all.  Lane l holds columns 4l .. 4l + 3, so key block kb is the
// lanes 4kb .. 4kb + 3 of each row's ballot.
__device__ __forceinline__ unsigned load_band(float* tm, const float* src,
                                              int qb, int lane) {
  const float4* s4 =
      reinterpret_cast<const float4*>(src + qb * kBlk * kW) + lane;
  float4 t[kBlk];
#pragma unroll
  for (int r = 0; r < kBlk; ++r) t[r] = __ldg(s4 + r * (kW / 4));
  unsigned any = 0;
  bool dead_row = false;
#pragma unroll
  for (int r = 0; r < kBlk; ++r) {
    *reinterpret_cast<float4*>(tm + (qb * kBlk + r) * kTmLd + 4 * lane) = t[r];
    const unsigned bal = row_ballot(t[r]);
    any |= bal;
    dead_row |= bal == 0;
  }
  return dead_row ? (1u << kNb) - 1 : span_blocks(any);
}

// The band slice of the CTA's (chunk, head) in shared memory, rows padded
// to kTmLd floats so that the logits' template reads spread over the banks.
struct Band {
  const float* tm;

  // Block (qb, kb)'s row 0, column 0 (rows kTmLd floats apart).
  __device__ const float* block(int qb, int kb) const {
    return tm + qb * kBlk * kTmLd + kb * kBlk;
  }
};

// Warp qb's 16 rows of the stage into its group's padded tiles: lane l < 16
// takes row qb 16 + l of q, lane l >= 16 that row of k (de-swizzled,
// normalised and split, backward its factor kept); v (and dO) copied.
template <bool kBwd>
__device__ __forceinline__ void unstage(const unsigned char* stage,
                                        const Tiles& t, int qb, int lane) {
  {
    const int r = qb * kBlk + (lane & 15);
    const bool is_k = lane >= 16;
    const unsigned char* src = stage + (is_k ? kBox : 0);
    bf16* hi = (is_k ? t.khi : t.qhi) + r * kLd;
    bf16* lo = (is_k ? t.klo : t.qlo) + r * kLd;
#pragma unroll
    for (int c = 0; c < kD / 8; ++c)
      reinterpret_cast<uint4*>(hi)[c] =
          *reinterpret_cast<const uint4*>(src + swizzle64(r, c));
    const float f = split_row<kD>(hi, lo);
    if (kBwd) (is_k ? t.kfac : t.qfac)[r] = f;
  }
#pragma unroll
  for (int k = 0; k < kBlk * kD / 8 / 32; ++k) {
    const int i = lane + 32 * k;
    const int r = qb * kBlk + i / (kD / 8);
    const int c = i % (kD / 8);
    reinterpret_cast<uint4*>(t.vt + r * kLd)[c] =
        *reinterpret_cast<const uint4*>(stage + 2 * kBox + swizzle64(r, c));
    if (kBwd)
      reinterpret_cast<uint4*>(t.dot + r * kLd)[c] =
          *reinterpret_cast<const uint4*>(stage + 3 * kBox + swizzle64(r, c));
  }
}

// cos = q^ . k^ of query block qb (the warp's hi and lo fragments) against
// key block kb (split_nt: hi.hi + hi.lo + lo.hi) and the logits cos * scale
// + template, both in the accumulator layout.
__device__ __forceinline__ void block_logits(float cs[2][4], float s[2][4],
                                             const uint32_t qh[kD / 16][4],
                                             const uint32_t ql[kD / 16][4],
                                             const Tiles& t, const Band& band,
                                             float scale, int qb, int kb,
                                             int lane) {
  split_nt<kD>(cs, qh, ql, t.khi, t.klo, kb * kBlk, lane);
  const float* tb = band.block(qb, kb) + (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* row = tb + ((lane >> 2) + 8 * i) * kTmLd;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(row + 8 * j);
      s[j][2 * i] = logit(cs[j][2 * i], scale, v.x);
      s[j][2 * i + 1] = logit(cs[j][2 * i + 1], scale, v.y);
    }
  }
}

// The stats sweep of query block qb over its live key blocks, the one code
// of the row statistics in both kernels: the row max m and the lane's share
// of the sum l online (online_block), and backward the lane's share of
// D_run = sum exp(s - m) dp, rescaled as l is.  The last live block's
// exp(s - m), cos and dp stay in e, cs and dp: with one live block, m is
// final, so e . (1 / l) is p, the very bits a second sweep would compute.
template <bool kBwd>
__device__ __forceinline__ void stats(float m[2], float l[2], float d_run[2],
                                      float e[2][4], float cs[2][4],
                                      float dp[2][4],
                                      const uint32_t qh[kD / 16][4],
                                      const uint32_t ql[kD / 16][4],
                                      const uint32_t da[kD / 16][4],
                                      const Tiles& t, const Band& band,
                                      float scale, int qb, unsigned qlive,
                                      int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = -INFINITY;
    l[i] = d_run[i] = 0.f;
  }
  for (int kb = 0; kb < kNb; ++kb) {
    if (!((qlive >> kb) & 1u)) continue;
    float alpha[2];
    block_logits(cs, e, qh, ql, t, band, scale, qb, kb, lane);
    if (kBwd) mma::product_nt<kD>(dp, da, t.vt, kb * kBlk, lane);
    online_block(e, m, l, alpha);  // e becomes exp(s - m)
    if (kBwd) {
#pragma unroll
      for (int i = 0; i < 2; ++i) d_run[i] *= alpha[i];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          d_run[k >> 1] = fmaf(e[j][k], dp[j][k], d_run[k >> 1]);
    }
  }
}

// dlog = p (dp - delta) of one live block in the accumulator layout: added
// to the slab's sum (old, read before: 0 for the group's first sample),
// dlog cos to the lane's d_scale share, and dlog scale split into the bf16
// hi and lo A fragments of the dq^ and dk^ products.
__device__ __forceinline__ void dlog_block(float* acc, const float2 old[2][2],
                                           const float p[2][4],
                                           const float dp[2][4],
                                           const float cs[2][4],
                                           const float delta[2], float scale,
                                           float& ds, uint32_t gha[4],
                                           uint32_t gla[4]) {
  float gh[2][4], gl[2][4], dl[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dl[j][e] = p[j][e] * (dp[j][e] - delta[e >> 1]);
      ds = fmaf(dl[j][e], cs[j][e], ds);
      const float dc = dl[j][e] * scale;
      gh[j][e] = dc;
      gl[j][e] = dc - __bfloat162float(__float2bfloat16(dc));
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      __stcg(reinterpret_cast<float2*>(acc + 8 * r * kW + 8 * j),
             make_float2(old[r][j].x + dl[j][2 * r],
                         old[r][j].y + dl[j][2 * r + 1]));
  mma::to_a(gha, gh);
  mma::to_a(gla, gl);
}

// The slab's sums so far at the lane's entries of one block (0 before the
// group's first sample), loaded ahead of the products that follow.
__device__ __forceinline__ void slab_load(float2 old[2][2], const float* acc,
                                          bool first) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      old[r][j] = first ? make_float2(0.f, 0.f)
                        : __ldcg(reinterpret_cast<const float2*>(
                              acc + 8 * r * kW + 8 * j));
}

// What both kernels share: the CTA's place, its shared memory, the band and
// live map (group 0's warps load it), the stages' barriers and first loads,
// and the group loop's bookkeeping: group g takes samples g, g + 2, ... of
// the run, in stage j % kStages; sample j completes on full[j % kGroups],
// so a group's barrier completes once per sample of its own; after taking
// sample i out of its stage, the group loads sample i + kStages there.
template <bool kBwd>
struct Cta {
  using S = Smem<kBwd>;
  unsigned char* smem;
  uint64_t* full;
  const CUtensorMap* qkv_map;
  const CUtensorMap* do_map;
  int unit, h, slice, b0, count, row0, c, warp, lane, group, qb;
  unsigned qlive;
  Band band;
  Tiles t;

  __device__ Cta(unsigned char* smem_raw, uint64_t* bars, const Args& a,
                 const CUtensorMap* qm, const CUtensorMap* dm)
      : smem(aligned_1024(smem_raw)),
        full(bars),
        qkv_map(qm),
        do_map(dm),
        t(smem + S::kGroupBase + (threadIdx.x / kGroup) * S::kGroupBytes,
          kBwd) {
    unit = blockIdx.x;
    h = blockIdx.y;
    slice = blockIdx.z;
    b0 = slice * a.per_slice;
    count = min(a.per_slice, a.batch - b0);
    row0 = unit * kW;
    c = a.num_heads * kD;
    warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    group = warp / kNb;
    qb = warp % kNb;
    unsigned char* live = smem + S::kLive;
    band = Band{reinterpret_cast<float*>(smem + S::kBand)};
    if (threadIdx.x == 0) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g) hopper::mbar_init(&full[g], 1);
      hopper::mbar_fence_init();
      for (int j = 0; j < S::kStages && j < count; ++j)
        load_sample<kBwd>(qkv_map, do_map, smem + j * S::kStage,
                          &full[j % kGroups], b0 + j, row0, h, c);
    }
    if (group == 0) {
      const unsigned bits = load_band(
          reinterpret_cast<float*>(smem + S::kBand),
          a.band + (static_cast<size_t>(h) * a.n + row0) * kW, qb, lane);
      if (lane == 0) live[qb] = static_cast<unsigned char>(bits);
    }
    __syncthreads();  // barriers, band and live map
    qlive = live[qb];
  }

  __device__ unsigned char* live_map() const { return smem + S::kLive; }

  // Wait for sample i (the group's k-th) and take it into the group's
  // tiles; then the stage takes sample i + kStages.
  __device__ void take(int i, int k) {
    const int st = i % S::kStages;
    if (k > 0) sync();  // the group is done with its tiles
    hopper::mbar_wait(&full[group], k & 1);
    unstage<kBwd>(smem + st * S::kStage, t, qb, lane);
    sync();
    const int next = i + S::kStages;
    if (threadIdx.x == group * kGroup && next < count)
      load_sample<kBwd>(qkv_map, do_map, smem + st * S::kStage,
                        &full[next % kGroups], b0 + next, row0, h, c);
  }

  // The group's named barrier.
  __device__ void sync() const {
    hopper::named_barrier_sync(1 + group, kGroup);
  }
};

// One CTA per (chunk, head, slice), two groups of 8 warps.
__global__ void __launch_bounds__(kThreadsB, 1)
    window_attention_banded_fwd_kernel(const __grid_constant__ CUtensorMap
                                           qkv_map,
                                       const Args a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kGroups];
  Cta<false> x(smem_raw, full, a, &qkv_map, nullptr);
  const int qb = x.qb;
  const int lane = x.lane;
  const Tiles& t = x.t;
  const float scale = a.scale[x.h];

  // one live key block (window-major chunks: every query block) takes one
  // sweep: the stats sweep's exp(s - m) is p before the normalisation
  const bool single = __popc(x.qlive) == 1;

  for (int i = x.group, k = 0; i < x.count; i += kGroups, ++k) {
    x.take(i, k);
    uint32_t qh[kD / 16][4], ql[kD / 16][4];
    mma::load_a<kD>(qh, t.qhi, qb * kBlk, lane);
    mma::load_a<kD>(ql, t.qlo, qb * kBlk, lane);
    // a. m and l, online over the live key blocks
    float m[2], l[2], unused[2], il[2], e[2][4], cs[2][4], dp[2][4];
    stats<false>(m, l, unused, e, cs, dp, qh, ql, nullptr, t, x.band, scale, qb,
                 x.qlive, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) il[r] = 1.f / mma::quad_sum(l[r]);
    // b. out = round(p) . v over the same blocks, p normalised first
    float acc[kD / 8][4];
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
    for (int kb = 0; kb < kNb; ++kb) {
      if (!((x.qlive >> kb) & 1u)) continue;
      if (!single) {
        float s_[2][4];
        block_logits(cs, s_, qh, ql, t, x.band, scale, qb, kb, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) e[j][r] = expf(s_[j][r] - m[r >> 1]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) e[j][r] *= il[r >> 1];
      uint32_t pa[4];
      mma::to_a(pa, e);
      mma::product_nn<kD>(acc, pa, t.vt, kb * kBlk, lane);
    }
    mma::store_rows<kD>(
        a.out + (static_cast<size_t>(x.b0 + i) * a.n + x.row0) * x.c +
            static_cast<size_t>(x.h) * kD,
        x.c, acc, qb * kBlk, kW, 1.f, lane);
  }
}

// What the backward's two loops share per (CTA, warp): the Cta, the warp's
// slab of `part` (its query block's rows of the (H, N, 128) layout) and
// the lane's d_scale share over the group's samples.
struct BwdWarp {
  Cta<true>& x;
  const Args& a;
  float* slab;
  float scale;
  size_t stride;
  int g, t2;
  float ds;

  // Sample i's d_qkv rows of this chunk and head.
  __device__ bf16* dst(int i) const {
    return a.out +
           (static_cast<size_t>(x.b0 + i) * a.n + x.row0) * stride +
           static_cast<size_t>(x.h) * kD;
  }

  // a. the stats sweep of query block qb: m, 1 / l and delta = D_run / l
  // of the lane's two rows, the last live block's values in e, cs and dp.
  __device__ void rows(float m[2], float il[2], float delta[2], float e[2][4],
                       float cs[2][4], float dp[2][4], uint32_t qh[kD / 16][4],
                       uint32_t ql[kD / 16][4], uint32_t da[kD / 16][4]) {
    const Tiles& t = x.t;
    mma::load_a<kD>(qh, t.qhi, x.qb * kBlk, x.lane);
    mma::load_a<kD>(ql, t.qlo, x.qb * kBlk, x.lane);
    mma::load_a<kD>(da, t.dot, x.qb * kBlk, x.lane);
    float l[2], d_run[2];
    stats<true>(m, l, d_run, e, cs, dp, qh, ql, da, t, x.band, scale, x.qb,
                x.qlive, x.lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l_row = mma::quad_sum(l[r]);
      il[r] = 1.f / l_row;
      delta[r] = mma::quad_sum(d_run[r]) / l_row;
    }
  }
};

// The backward when every query block's one live key block is its own (the
// window-major chunks the model runs): the warp of query block qb owns key
// block qb too, and takes everything from the stats sweep's fragments: p
// and dlog from its e, cos and dp, dq^ as in the general loop, dv and dk^
// from round(p) and dlog scale transposed (movmatrix).  No second sweep and
// no barrier between the rows and the keys.
__device__ __forceinline__ void backward_diagonal(BwdWarp& w) {
  Cta<true>& x = w.x;
  const Tiles& t = x.t;
  const int qb = x.qb;
  const int lane = x.lane;
  float* acc = w.slab + w.g * kW + qb * kBlk + w.t2;
  for (int i = x.group, k = 0; i < x.count; i += kGroups, ++k) {
    float2 old[2][2];  // the slab's sums, loaded ahead
    slab_load(old, acc, k == 0);
    x.take(i, k);
    bf16* dst = w.dst(i);
    uint32_t qh[kD / 16][4], ql[kD / 16][4], da[kD / 16][4];
    float m[2], il[2], delta[2], e[2][4], cs[2][4], dp[2][4], p[2][4];
    w.rows(m, il, delta, e, cs, dp, qh, ql, da);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) p[j][r] = e[j][r] * il[r >> 1];
    uint32_t gha[4], gla[4];
    dlog_block(acc, old, p, dp, cs, delta, w.scale, w.ds, gha, gla);
    float g3[kD / 8][4];  // dq^, then dk^
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) g3[j][r] = 0.f;
    split_nn<kD>(g3, gha, gla, t.khi, t.klo, qb * kBlk, lane);
    store_normalised<kD>(dst, w.stride, g3, t.qhi, t.qlo, t.qfac, qb * kBlk,
                         kW, lane);
    uint32_t pa[4], pt[4], tha[4], tla[4];
    mma::to_a(pa, p);
    mma::transpose_a(pt, pa);
    mma::transpose_a(tha, gha);
    mma::transpose_a(tla, gla);
    float dv[kD / 8][4];
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) g3[j][r] = dv[j][r] = 0.f;
    mma::product_nn<kD>(dv, pt, t.dot, qb * kBlk, lane);
    split_nn<kD>(g3, tha, tla, t.qhi, t.qlo, qb * kBlk, lane);
    store_normalised<kD>(dst + x.c, w.stride, g3, t.khi, t.klo, t.kfac,
                         qb * kBlk, kW, lane);
    mma::store_rows<kD>(dst + 2 * x.c, w.stride, dv, qb * kBlk, kW, 1.f,
                        lane);
  }
}

// The backward for any live map: a. the stats sweep, warp on query block
// qb; a2. dq^ += (dlog scale) . k^ over its live key blocks (logits and dp
// again), dlog into the slab; then, the rows' m, 1 / l and delta in shared
// memory, b. warp on key block kb: cos^T = k^.q^T and dp^T = v.dO^T over
// its live query blocks, dv += round(p)^T.dO, dk^ += (dlog scale)^T.q^.
__device__ __forceinline__ void backward_general(BwdWarp& w) {
  Cta<true>& x = w.x;
  const Tiles& t = x.t;
  const unsigned char* live = x.live_map();
  const int lane = x.lane;
  const int g = w.g;
  const int t2 = w.t2;
  for (int i = x.group, k = 0; i < x.count; i += kGroups, ++k) {
    x.take(i, k);
    bf16* dst = w.dst(i);
    {  // a, a2: warp on query block qb
      const int qb = x.qb;
      uint32_t qh[kD / 16][4], ql[kD / 16][4], da[kD / 16][4];
      float m[2], il[2], delta[2], e[2][4], cs[2][4], dp[2][4];
      w.rows(m, il, delta, e, cs, dp, qh, ql, da);
      if ((lane & 3) == 0)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = qb * kBlk + g + 8 * r;
          t.mrow[row] = m[r];
          t.irow[row] = il[r];
          t.drow[row] = delta[r];
        }
      float dq[kD / 8][4];
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) dq[j][r] = 0.f;
      for (int kb = 0; kb < kNb; ++kb) {
        if (!((x.qlive >> kb) & 1u)) continue;
        float* acc = w.slab + g * kW + kb * kBlk + t2;
        float2 old[2][2];
        slab_load(old, acc, k == 0);
        float s[2][4], p[2][4];
        block_logits(cs, s, qh, ql, t, x.band, w.scale, qb, kb, lane);
        mma::product_nt<kD>(dp, da, t.vt, kb * kBlk, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            p[j][r] = expf(s[j][r] - m[r >> 1]) * il[r >> 1];
        uint32_t gha[4], gla[4];
        dlog_block(acc, old, p, dp, cs, delta, w.scale, w.ds, gha, gla);
        split_nn<kD>(dq, gha, gla, t.khi, t.klo, kb * kBlk, lane);
      }
      store_normalised<kD>(dst, w.stride, dq, t.qhi, t.qlo, t.qfac, qb * kBlk,
                           kW, lane);
    }
    x.sync();  // every row's stats

    {  // b. warp on key block kb
      const int kb = x.qb;
      uint32_t kh[kD / 16][4], kl[kD / 16][4], va[kD / 16][4];
      mma::load_a<kD>(kh, t.khi, kb * kBlk, lane);
      mma::load_a<kD>(kl, t.klo, kb * kBlk, lane);
      mma::load_a<kD>(va, t.vt, kb * kBlk, lane);
      float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) dk[j][r] = dv[j][r] = 0.f;
      for (int qb = 0; qb < kNb; ++qb) {
        if (!((live[qb] >> kb) & 1u)) continue;
        float s[2][4], dp[2][4], p[2][4], gh[2][4], gl[2][4];
        const float* tb = x.band.block(qb, kb);
        split_nt<kD>(s, kh, kl, t.qhi, t.qlo, qb * kBlk, lane);  // cos^T
        mma::product_nt<kD>(dp, va, t.dot, qb * kBlk, lane);     // dp^T
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int key = kb * kBlk + g + 8 * (r >> 1);
            const int q = qb * kBlk + 8 * j + t2 + (r & 1);
            const float pv =
                expf(logit(s[j][r], w.scale,
                           tb[(q - qb * kBlk) * kTmLd + key - kb * kBlk]) -
                     t.mrow[q]) *
                t.irow[q];
            const float dc = pv * (dp[j][r] - t.drow[q]) * w.scale;
            p[j][r] = pv;
            gh[j][r] = dc;
            gl[j][r] = dc - __bfloat162float(__float2bfloat16(dc));
          }
        uint32_t pa[4], gha[4], gla[4];
        mma::to_a(pa, p);
        mma::to_a(gha, gh);
        mma::to_a(gla, gl);
        mma::product_nn<kD>(dv, pa, t.dot, qb * kBlk, lane);
        split_nn<kD>(dk, gha, gla, t.qhi, t.qlo, qb * kBlk, lane);
      }
      store_normalised<kD>(dst + x.c, w.stride, dk, t.khi, t.klo, t.kfac,
                           kb * kBlk, kW, lane);
      mma::store_rows<kD>(dst + 2 * x.c, w.stride, dv, kb * kBlk, kW, 1.f,
                          lane);
    }
  }
}

// One CTA per (chunk, head, slice), two groups of 8 warps.  The d_band
// accumulators are not kept in registers (64 a thread would halve the warps
// an SM holds) but in the group's slab of `part`, read and written back per
// sample by the lane that owns the entries (L2-resident: 2 KB a live block
// and sample against the sample's 56 KB of q, k, v, dO and d_qkv).
__global__ void __launch_bounds__(kThreadsB, 1)
    window_attention_banded_bwd_kernel(const __grid_constant__ CUtensorMap
                                           qkv_map,
                                       const __grid_constant__ CUtensorMap
                                           do_map,
                                       const Args a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kGroups];
  Cta<true> x(smem_raw, full, a, &qkv_map, &do_map);
  const int lane = x.lane;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  const unsigned char* live = x.live_map();
  const size_t plane = static_cast<size_t>(a.num_heads) * a.n * kW;
  const size_t rows = static_cast<size_t>(x.h) * a.n + x.row0 + x.qb * kBlk;
  BwdWarp w{x, a, a.part + (x.slice * kGroups + x.group) * plane + rows * kW,
            a.scale[x.h], 3 * static_cast<size_t>(x.c), g, t2, 0.f};
  bool diag = true;  // a CTA-wide choice: the loops' barriers differ
#pragma unroll
  for (int b = 0; b < kNb; ++b) diag &= live[b] == 1u << b;
  if (diag)
    backward_diagonal(w);
  else
    backward_general(w);
  float ds = w.ds;

  // d_scale: the CTA's partial, warps in order; then the ticket
  float* red = reinterpret_cast<float*>(x.smem + Smem<true>::kRed);
  int* flag = reinterpret_cast<int*>(red + kThreadsB / 32);
  ds = warp_sum(ds);
  if (lane == 0) red[x.warp] = ds;
  __syncthreads();
  const int units = a.n / kW;
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int v = 0; v < kThreadsB / 32; ++v) sum += red[v];
    a.ds_part[(static_cast<size_t>(x.h) * units + x.unit) * a.slices +
              x.slice] = sum;
  }
  if (!last_cta(a.tickets + x.h * units + x.unit, a.slices, flag)) return;
  // the last CTA of (chunk, head): d_band = the slabs summed in (slice,
  // group) order on the live blocks, 0 on the others; warp w takes query
  // block w % 8 and key blocks 4 (w / 8) .. + 3
  const int qb = x.warp % kNb;
  const unsigned qlive = live[qb];
  const size_t rows_qb = static_cast<size_t>(x.h) * a.n + x.row0 + qb * kBlk;
  const int slabs = a.slices * kGroups;
#pragma unroll
  for (int q = 0; q < kNb / kGroups; ++q) {
    const int kb = (x.warp / kNb) * (kNb / kGroups) + q;
    const bool is_live = (qlive >> kb) & 1u;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const size_t at = (rows_qb + g + 8 * r) * kW + kb * kBlk + 8 * j + t2;
        float2 sum = make_float2(0.f, 0.f);
        if (is_live)
          for (int sl = 0; sl < slabs; ++sl) {
            // a group with no sample of its slice wrote nothing
            const int s_ = sl / kGroups;
            const int count_s = min(a.per_slice, a.batch - s_ * a.per_slice);
            if (sl % kGroups >= count_s) continue;
            const float2 v =
                __ldcg(reinterpret_cast<const float2*>(a.part + sl * plane + at));
            sum.x += v.x;
            sum.y += v.y;
          }
        *reinterpret_cast<float2*>(a.dband + at) = sum;
      }
  }
}

// The tensor map of a bf16 (batch, n, cols) tensor in boxes of one head's
// 32 columns x one chunk's 128 rows of one sample.
cudaError_t chunk_map(CUtensorMap* map, const void* base, uint64_t batch,
                      uint64_t n, uint64_t cols) {
  return head_box_map(map, base, batch, n, cols, kW);
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The arguments both entry points take, checked; per_slice from slices.
cudaError_t check(Args* a, const void* qkv, const void* scale,
                  const void* band, void* out, int batch, int n,
                  int num_heads, int head_dim, int slices) {
  if (batch < 1 || n < kW || n % kW != 0 || num_heads < 1 ||
      num_heads > 65535 || n / kW > 65535 || head_dim != kD || slices < 1 ||
      slices > batch || slices > 65535 || qkv == nullptr ||
      scale == nullptr || band == nullptr || out == nullptr ||
      !aligned(qkv) || !aligned(band) || !aligned(out))
    return cudaErrorInvalidValue;
  a->per_slice = (batch + slices - 1) / slices;
  if ((slices - 1) * a->per_slice >= batch)  // an empty slice
    return cudaErrorInvalidValue;
  a->scale = static_cast<const float*>(scale);
  a->band = static_cast<const float*>(band);
  a->out = static_cast<bf16*>(out);
  a->batch = batch;
  a->n = n;
  a->num_heads = num_heads;
  a->slices = slices;
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// The batch slices a call at (batch, n, num_heads) takes: the count whose
// CTAs ((n / 128) x num_heads x slices) fill the current device's SMs in the
// fewest sample-times (waves x the samples a group of the CTA takes), the
// smaller on a tie, so the fewest d_band partials.  At B = 32, N = 512, H =
// 16 on 132 SMs: 2 (128 CTAs of 16 samples, 8 a group; 4 would take two
// waves of 4).  Negative on a CUDA error.
extern "C" int tpat_window_attention_banded_slices(int batch, int n,
                                                   int num_heads, int bwd) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    if (bwd) {
      err = prepare(window_attention_banded_bwd_kernel, Smem<true>::kBytes);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, window_attention_banded_bwd_kernel, kThreadsB,
            Smem<true>::kBytes);
    } else {
      err = prepare(window_attention_banded_fwd_kernel, Smem<false>::kBytes);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, window_attention_banded_fwd_kernel, kThreadsB,
            Smem<false>::kBytes);
    }
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (batch < 1 || n < kW || num_heads < 1 || per_sm < 1)
    return -static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = static_cast<long long>(n / kW) * num_heads;
  const long long slots = static_cast<long long>(sms) * per_sm;
  int best = 1;
  long long best_t = -1;
  for (int s = 1; s <= batch && s <= 65535; ++s) {
    const long long per = (batch + s - 1) / s;
    if ((s - 1) * per >= batch) continue;  // an empty slice
    const long long t =
        (pairs * s + slots - 1) / slots * ((per + kGroups - 1) / kGroups);
    if (best_t < 0 || t < best_t) {
      best = s;
      best_t = t;
    }
  }
  return best;
}

// The groups of warps of a CTA, each on alternate samples of its slice: the
// backward's accumulator slabs per slice.
extern "C" int tpat_window_attention_banded_groups() { return kGroups; }

// The dynamic shared memory of each kernel (bwd = 0: forward), for the
// record beside ptxas's report.
extern "C" long long tpat_window_attention_banded_smem(int bwd) {
  return static_cast<long long>(bwd ? Smem<true>::kBytes
                                    : Smem<false>::kBytes);
}

// qkv: (batch, n, 3 C) bf16 contiguous in window-major order, C =
// num_heads * 32; scale: (num_heads,) f32; band: (num_heads, n, 128) f32,
// n % 128 == 0; out: (batch, n, C) bf16; slices: 1 .. batch, no slice
// empty (tpat_window_attention_banded_slices).  qkv, band and out 16-byte
// aligned.  Launches one kernel on `stream`, synchronises nothing, returns
// the CUDA error (0 on success).
extern "C" int tpat_window_attention_banded_fwd(const void* qkv,
                                                const void* scale,
                                                const void* band, void* out,
                                                int batch, int n,
                                                int num_heads, int head_dim,
                                                int slices, void* stream) {
  Args a{};
  cudaError_t err = check(&a, qkv, scale, band, out, batch, n, num_heads,
                          head_dim, slices);
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  err = chunk_map(&map, qkv, batch, n, 3 * num_heads * kD);
  if (err != cudaSuccess) return err;
  err = prepare(window_attention_banded_fwd_kernel, Smem<false>::kBytes);
  if (err != cudaSuccess) return err;
  window_attention_banded_fwd_kernel<<<dim3(n / kW, num_heads, slices),
                                       kThreadsB, Smem<false>::kBytes,
                                       static_cast<cudaStream_t>(stream)>>>(
      map, a);
  return cudaGetLastError();
}

// As the forward, with dout: (batch, n, C) bf16, 16-byte aligned.  Writes
// dqkv (batch, n, 3 C) bf16, dband (num_heads, n, 128) f32 (summed over
// the batch) and ds_part (num_heads, (n / 128) * slices) f32, whose rows sum
// to d_scale.  part: (slices * tpat_window_attention_banded_groups(),
// num_heads, n, 128) f32, the groups' accumulators (its contents on entry
// do not matter); with slices > 1, tickets: (num_heads, n / 128) int32, all
// 0 (the kernel leaves them 0).
extern "C" int tpat_window_attention_banded_bwd(
    const void* qkv, const void* scale, const void* band, const void* dout,
    void* dqkv, void* dband, void* part, void* ds_part, void* tickets,
    int batch, int n, int num_heads, int head_dim, int slices, void* stream) {
  Args a{};
  cudaError_t err = check(&a, qkv, scale, band, dqkv, batch, n, num_heads,
                          head_dim, slices);
  if (err != cudaSuccess) return err;
  if (dout == nullptr || !aligned(dout) || dband == nullptr ||
      !aligned(dband) || ds_part == nullptr || part == nullptr ||
      (slices > 1 && tickets == nullptr))
    return cudaErrorInvalidValue;
  a.dband = static_cast<float*>(dband);
  a.part = static_cast<float*>(part);
  a.ds_part = static_cast<float*>(ds_part);
  a.tickets = static_cast<int*>(tickets);
  CUtensorMap qkv_map, do_map;
  err = chunk_map(&qkv_map, qkv, batch, n, 3 * num_heads * kD);
  if (err == cudaSuccess)
    err = chunk_map(&do_map, dout, batch, n, num_heads * kD);
  if (err != cudaSuccess) return err;
  err = prepare(window_attention_banded_bwd_kernel, Smem<true>::kBytes);
  if (err != cudaSuccess) return err;
  window_attention_banded_bwd_kernel<<<dim3(n / kW, num_heads, slices),
                                       kThreadsB, Smem<true>::kBytes,
                                       static_cast<cudaStream_t>(stream)>>>(
      qkv_map, do_map, a);
  return cudaGetLastError();
}
