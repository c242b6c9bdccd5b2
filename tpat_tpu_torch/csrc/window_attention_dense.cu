// Fused swin_v2_cr window attention in its dense form, bf16, forward and
// backward, for Hopper (sm_90a): one launch per direction.
//
// Replaces tpat_tpu/ops/pallas_window_attention.py::_fwd_kernel as
// _fused_impl runs it and ::_bwd_kernel (via _fused_bwd_impl): the TPU
// kernels that every decoder block of an MAE pretrain step at the ESC-50
// grid (32 x 8 tokens, N = 256, tokens in the grid's original order) and
// the SPC2 grid (8 x 8) runs.  The banded form in bf16 is
// window_attention_banded.cu's; f32 (either form) and bf16 over 256 tokens
// stay on the FMA kernels of window_attention.cu and window_attention_bwd.cu.
//
// What it computes, per (sample b, head h), with q, k, v and dO one head's
// D = 32 values of the grid's rows, the (H,) f32 scales and the f32 (H, N,
// N) template:
//   q^ = q * rsqrt(max(sum q^2, 1e-24)), k^ likewise, in f32;
//   logit = (q^ . k^) * scale[h] + template[h, i, j];  p = softmax in f32;
//   out = round(p) . v, accumulated in f32, cast to bf16;
// and, backward, p recomputed, dp = dO . v^T, dlog = p (dp - sum_j dp p) in
// f32, dq^ = dlog scale . k^, dk^ = (dlog scale)^T . q^, the F.normalize
// VJP of each, dv = round(p)^T . dO; d_scale[h] = sum over b, i, j of dlog
// cos and d_template[h] = sum over b of dlog, which the TPU kernel carries
// in resident accumulators over its sequential batch axis.
//
// What bounds it.  At the ESC-50 decoder (B = 32, H = 16, N = 256) a forward
// must read qkv (25.2 MB) and the template (4.2 MB) and write out (8.4 MB):
// 37.7 MB, 11.3 us at 3.35 TB/s; a backward reads qkv, dO and the template
// and writes d_qkv and d_template: 67.3 MB, 20.1 us.  The live products are
// few: the grid's 4 x 4 windows span two 16-token blocks of rows, so each
// query block has exactly 2 live key blocks of 16 under either shift (32 of
// a head's 256 blocks), about 4 D FLOPs a live pair forward and 10 D
// backward, under a us on the tensor cores even as split-bf16 products.
// What the card spends its time on is latency: each sample is a chain of
// dependent steps (TMA wait, copy-out and split, barriers, mma.sync chains,
// exps, quad shuffles), so the design puts the next sample's loads beside
// this sample's products and launches nothing but the one kernel.  Before
// it (PR 7/8's kernels) the time went to launches (a live-map kernel before
// each direction, a template-sum kernel after the backward), to a
// per-sample (B, H, N, N) f32 dlog partial (134 MB at B = 32) written by one
// kernel and read back by the next, and to staging one sample per CTA with
// nothing to overlap it.
//
// The design, per direction one kernel, one CTA per (head, batch slice) of
// a warp per 16-row block of the grid (512 threads at N = 256): the batch is
// cut into `slices` runs of consecutive samples, as few as fill the card's
// SMs in whole waves, and the CTA takes its run in batch order.  Queries
// and keys are the grid's rows, so every row statistic is the CTA's own.
//   - The live map from the template with warp ballots
//     (window_attention_hopper.cuh's rule): key block kb of query block qb
//     is live when one of its 16 x 16 entries is above -1e29, or when one
//     of qb's 16 rows has none at all (its p is uniform over the grid, so
//     the query block is kept whole).  A block that is not live has p = 0
//     exactly and adds exact zeros to every sum, so it is skipped, and its
//     d_template entries are written 0.  Every CTA of a head needs the
//     whole map, and reading the (N, N) template once per CTA cost more
//     than a sample's work (8 CTAs a head read 33.5 MB of L2 at B = 32, 7
//     us), so the head's CTAs run as a thread-block cluster (up to 8, as
//     many as the card holds in one wave) and scan it once: CTA r of the
//     cluster takes the query blocks qb with qb % cluster == r, and each
//     CTA reads the others' bits from their shared memory.  The live
//     blocks get compact slots in row-major order; the first kSlots (32, a
//     grid's worth at the model's map) hold their template entries in
//     shared memory in the accumulator layout (a lane's 8 entries
//     contiguous, conflict-free 16-byte reads); the others are read from
//     the template in global memory (L2).
//   - A sample's q, k and v (and dO) come as N-row x 32-value TMA boxes of
//     one head out of the packed (B, N, 3C) qkv and the (B, N, C) dO,
//     through 3-D tensor maps with the 64-byte swizzle, into one stage
//     completed on an mbarrier.  The warps copy it out into padded bf16
//     tiles (rows of 40 values), q and k normalised in f32 and split into
//     hi = bf16(x^) and lo = bf16(x^ - hi) on the way (split_row), and the
//     stage at once takes the next sample, whose loads then run under this
//     sample's products.  No producer warp: thread 0 starts the loads.
//   - The arithmetic is the TPU kernel's, typed as window_attention_banded
//     .cu types it: cos, dq^ and dk^ as three bf16 mma.sync products hi.hi +
//     hi.lo + lo.hi with f32 accumulation (split_nt, split_nn), dp and dv
//     single bf16 products; the row statistics online over the live key
//     blocks in ascending order (online_block), one code for both kernels,
//     so the backward's m and l are the forward's bit for bit; p normalised
//     in f32 and rounded to bf16 before p.v and before dv.
//   - Forward: warp qb on query block qb: m and l online, then p and out =
//     round(p).v over the same blocks.  Each sample is a chain of mma.sync
//     products whose latency, not their issue, sets the time, so the warp
//     takes its first two live blocks (every query block of the model's
//     grids has two) side by side: their product chains interleave, and
//     their logits stay in registers for p.v, the very bits a second sweep
//     would compute.  Further blocks are computed again.
//   - Backward: warp qb on query block qb takes m, l and D_run = sum exp(s -
//     m) dp online (delta = D_run / l), then over the same blocks (logits
//     and dp again) dlog = p (dp - delta) and dq^ += (dlog scale) . k^;
//     then, the rows' m, 1 / l and delta in shared memory, warp kb on key
//     block kb: cos^T = k^.q^T and dp^T = v.dO^T over its live query
//     blocks, dv += round(p)^T.dO and dk^ += (dlog scale)^T.q^.  (Keeping
//     the rows sweep's values for the key sweep, transposed by movmatrix,
//     or the d_template sums in registers, holds values across the sweep
//     in registers that spill at the 128 a thread of 512; in bring-up
//     trials neither was faster, so the sweeps compute again.)
//   - d_template and d_scale are summed by the CTA over its run in batch
//     order: the lane that owns a live block's entries adds its samples'
//     dlog to the block's slot in the CTA's slab of the partial buffer (its
//     slots compact, in the accumulator layout, L2-resident: 2 KB a live
//     block and sample read and written against the sample's 112 KB of q,
//     k, v, dO and d_qkv), and its dlog cos to the lane's d_scale share.
//     Each CTA writes one d_scale partial (its warps in order) and 0 on its
//     share of the dead blocks of d_template; an integer ticket per head
//     finds the last CTA, which sums the slabs of the live blocks in slice
//     order into d_template and puts the ticket back to 0.  No
//     floating-point atomics: the same bits from run to run.  The wrapper
//     sums the d_scale partials.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_mma.cuh"
#include "hopper_tma_wgmma.cuh"
#include "window_attention_common.cuh"
#include "window_attention_hopper.cuh"
#include "window_attention_tc.cuh"
#include "window_attention_tc_grad.cuh"

namespace {

using mma::bf16;
using namespace window_attention;

constexpr int kD = kHeadDim;
constexpr int kMaxN = 256;                 // the grid's tokens at most
constexpr int kMaxNb = kMaxN / kBlk;       // its 16-row blocks
constexpr int kMaxThreads = 32 * kMaxNb;   // a warp per block
constexpr int kLd = TcSmem<kD>::kLd;       // padded tile row, bf16 values
constexpr int kSlots = 32;                 // live template blocks in smem
constexpr int kBlockFloats = kBlk * kBlk;  // one 16 x 16 f32 block

// Shared memory past the 1024-byte aligned base for an n-token grid: the
// stage (q, k, v and, backward, dO boxes of one sample), the padded tiles
// (q^ hi, q^ lo, k^ hi, k^ lo, v and, backward, dO), backward the per-row
// m, 1 / l, delta and q and k normalisation factors, the live template
// slots, the live map and each query block's first slot, and one d_scale
// sum per warp with the last-CTA flag.
struct Layout {
  uint32_t box = 0, tiles = 0, tile = 0, stats = 0, slots = 0, live = 0,
           dead = 0, first = 0, red = 0, bytes = 0;
  constexpr __host__ __device__ Layout(int n, bool bwd) {
    box = n * kRowBytes;
    tiles = (bwd ? 4 : 3) * box;
    tile = n * kLd * sizeof(bf16);
    stats = tiles + (bwd ? 6 : 5) * tile;
    slots = stats + (bwd ? 5 * n * sizeof(float) : 0);
    live = slots + kSlots * kBlockFloats * sizeof(float);
    dead = live + kMaxNb * sizeof(unsigned);
    first = dead + kMaxNb * sizeof(unsigned);
    red = first + kMaxNb * sizeof(int);
    bytes = red + (kMaxNb + 1) * sizeof(float) + 1024;
  }
};
static_assert(Layout(kMaxN, true).bytes <= kMaxSmem, "the CTA's shared memory");

struct Args {
  const float* scale;
  const float* tmpl;  // (H, n, n)
  bf16* out;          // forward: (B, n, C); backward: d_qkv (B, n, 3C)
  float* dtmpl;       // backward: (H, n, n)
  float* part;        // backward: (slices, H, nb * nb, 256) slabs
  float* ds_part;     // backward: (H, slices)
  int* tickets;       // backward, slices > 1: (H,), all 0 between calls
  int batch, n, nb, num_heads, per_slice, slices;
};

// The padded tiles and, backward, the per-row vectors.
struct Tiles {
  bf16 *qhi, *qlo, *khi, *klo, *vt, *dot;
  float *mrow, *irow, *drow, *qfac, *kfac;
  __device__ Tiles(unsigned char* smem, const Layout& s, int n) {
    qhi = reinterpret_cast<bf16*>(smem + s.tiles);
    qlo = qhi + n * kLd;
    khi = qlo + n * kLd;
    klo = khi + n * kLd;
    vt = klo + n * kLd;
    dot = vt + n * kLd;
    mrow = reinterpret_cast<float*>(smem + s.stats);
    irow = mrow + n;
    drow = irow + n;
    qfac = drow + n;
    kfac = qfac + n;
  }
};

// Entry (r, c) of a 16 x 16 block in the accumulator layout: lane 4 (r % 8)
// + (c % 8) / 2 holds it as its v[c / 8][2 (r / 8) + c % 2], 8 floats a
// lane, contiguous.
__device__ __forceinline__ int frag_index(int r, int c) {
  return ((r & 7) * 4 + ((c & 7) >> 1)) * 8 + (c >> 3) * 4 + (r >> 3) * 2 +
         (c & 1);
}

// The head's template: the live map, the live blocks' compact slots, the
// first kSlots of them in shared memory, the rest in global memory.
struct Tmpl {
  const float* slots;     // shared, kSlots blocks in the accumulator layout
  const float* glob;      // the head's (n, n), row-major
  const unsigned* live;   // shared, per query block: its live key blocks
  const int* first;       // shared, per query block: its first slot
  int n;

  __device__ int slot(int qb, int kb) const {
    return first[qb] + __popc(live[qb] & ((1u << kb) - 1u));
  }

  // The lane's 8 entries of block (qb, kb), slot sl, in the accumulator
  // layout: v[j][2i + e] = (row g + 8i, column 8j + 2t + e).
  __device__ void frag(float v[2][4], int sl, int qb, int kb,
                       int lane) const {
    if (sl < kSlots) {
      const float4* p =
          reinterpret_cast<const float4*>(slots + sl * kBlockFloats + lane * 8);
      const float4 x = p[0], y = p[1];
      v[0][0] = x.x, v[0][1] = x.y, v[0][2] = x.z, v[0][3] = x.w;
      v[1][0] = y.x, v[1][1] = y.y, v[1][2] = y.z, v[1][3] = y.w;
      return;
    }
    const float* r = glob + static_cast<size_t>(qb * kBlk + (lane >> 2)) * n +
                     kb * kBlk + (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 x = __ldg(
            reinterpret_cast<const float2*>(r + static_cast<size_t>(8 * i) * n +
                                            8 * j));
        v[j][2 * i] = x.x;
        v[j][2 * i + 1] = x.y;
      }
  }

  // Entry (r, c) of block (qb, kb), slot sl.
  __device__ float at(int sl, int qb, int kb, int r, int c) const {
    return sl < kSlots
               ? slots[sl * kBlockFloats + frag_index(r, c)]
               : __ldg(glob + static_cast<size_t>(qb * kBlk + r) * n +
                       kb * kBlk + c);
  }
};

// The CTA's place in its cluster (the CTAs of one head, on consecutive
// slices), a barrier over the cluster's threads, and a u32 of a peer's
// shared memory (the same offset as `local` in CTA `rank`).
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ uint32_t peer_u32(const void* local,
                                             uint32_t rank) {
  uint32_t remote, v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(hopper::smem_addr(local)), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n"
               : "=r"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// The head's live map, scanned once by the CTAs of the cluster together:
// CTA r of the cluster's cs takes the query blocks qb with qb % cs == r,
// each warp a run of consecutive rows of them, 8 rows in flight, each
// row's 128-column spans by ballots (lane l holds columns 4l .. 4l + 3 of a
// span: window_attention_hopper.cuh's rule); a run's bits and dead rows
// gather in registers and go to shared memory once per query block it
// touches (live[], dead[], zeroed before).  Then every CTA reads each query
// block's bits from the CTA that scanned it.
__device__ __forceinline__ void scan_live(unsigned* live, unsigned* dead,
                                          const float* tm, int n, int nb,
                                          int warp, int lane) {
  constexpr int kRows = 8;
  const int rank = static_cast<int>(cluster_rank());
  const int cs = static_cast<int>(cluster_size());
  const int rows = (nb - rank + cs - 1) / cs * kBlk;  // the CTA's rows
  const int per = (rows + nb - 1) / nb;               // a warp's run
  const int end = min(rows, (warp + 1) * per);
  int cur = -1;  // the query block whose bits `bits` and `dead_row` hold
  unsigned bits = 0;
  bool dead_row = false;
  for (int base = warp * per; base < end; base += kRows) {
    float4 t[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = base + r;
      const int row = (rank + cs * (j / kBlk)) * kBlk + j % kBlk;
#pragma unroll
      for (int sp = 0; sp < 2; ++sp) {
        const int col = sp * 128 + 4 * lane;
        t[r][sp] = j < end && col < n
                       ? __ldg(reinterpret_cast<const float4*>(
                             tm + static_cast<size_t>(row) * n + col))
                       : make_float4(-INFINITY, -INFINITY, -INFINITY,
                                     -INFINITY);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = base + r;
      if (j >= end) break;
      const int qb = rank + cs * (j / kBlk);
      if (qb != cur) {
        if (cur >= 0 && lane == 0) {
          atomicOr(live + cur, bits);
          if (dead_row) dead[cur] = 1;
        }
        cur = qb;
        bits = 0;
        dead_row = false;
      }
      unsigned any = 0;
#pragma unroll
      for (int sp = 0; sp < 2; ++sp) {
        const unsigned bal = row_ballot(t[r][sp]);
        bits |= span_blocks(bal) << (8 * sp);
        any |= bal;
      }
      dead_row |= any == 0;
    }
  }
  if (cur >= 0 && lane == 0) {
    atomicOr(live + cur, bits);
    if (dead_row) dead[cur] = 1;
  }
  __syncthreads();
  if (threadIdx.x < nb && static_cast<int>(threadIdx.x) % cs == rank &&
      dead[threadIdx.x] != 0)
    live[threadIdx.x] = (1u << nb) - 1u;  // a row with no live entry
  cluster_sync();  // every query block's bits
  const int owner = warp % cs;
  if (lane == 0 && owner != rank) live[warp] = peer_u32(live + warp, owner);
  cluster_sync();  // no CTA leaves while a peer reads its bits
}

// Warp qb's 16 rows of the stage into the padded tiles: lane l < 16 takes
// row qb 16 + l of q, lane l >= 16 that row of k (de-swizzled, normalised
// and split, backward its factor kept); v (and dO) copied.
template <bool kBwd>
__device__ __forceinline__ void unstage(const unsigned char* stage,
                                        uint32_t box, const Tiles& t, int qb,
                                        int lane) {
  {
    const int r = qb * kBlk + (lane & 15);
    const bool is_k = lane >= 16;
    const unsigned char* src = stage + (is_k ? box : 0);
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
        *reinterpret_cast<const uint4*>(stage + 2 * box + swizzle64(r, c));
    if (kBwd)
      reinterpret_cast<uint4*>(t.dot + r * kLd)[c] =
          *reinterpret_cast<const uint4*>(stage + 3 * box + swizzle64(r, c));
  }
}

// cos = q^ . k^ of query block qb (the warp's hi and lo fragments) against
// key block kb, slot sl (split_nt: hi.hi + hi.lo + lo.hi), and the logits
// cos * scale + template, both in the accumulator layout.
__device__ __forceinline__ void block_logits(float cs[2][4], float s[2][4],
                                             const uint32_t qh[kD / 16][4],
                                             const uint32_t ql[kD / 16][4],
                                             const Tiles& t, const Tmpl& tm,
                                             float scale, int sl, int qb,
                                             int kb, int lane) {
  split_nt<kD>(cs, qh, ql, t.khi, t.klo, kb * kBlk, lane);
  float v[2][4];
  tm.frag(v, sl, qb, kb, lane);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = logit(cs[j][e], scale, v[j][e]);
}

// The first two set bits of `bits` (the second = the first when there is
// one) and the bits past them.
__device__ __forceinline__ void split_pair(unsigned bits, int* first,
                                           int* second, bool* two,
                                           unsigned* rest) {
  *first = bits != 0 ? __ffs(bits) - 1 : 0;
  const unsigned r = bits & (bits - 1);
  *two = r != 0;
  *second = *two ? __ffs(r) - 1 : *first;
  *rest = r & (r - 1);
}

// The kernels' exponential: __expf (ex2.approx of x log2 e, a few f32 ulps
// from expf, which window_attention_banded.cu takes): the exps sit on each
// sample's dependent chain, and ex2.approx is a fraction of expf's
// instructions.
__device__ __forceinline__ float exp_f32(float x) { return __expf(x); }

// p = exp(s - m) / l of the lane's two rows in f32, normalised before it is
// rounded: the A fragment of p . v.
__device__ __forceinline__ void p_frag(uint32_t pa[4], const float s[2][4],
                                       const float m[2], const float il[2]) {
  float p[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[j][r] = exp_f32(s[j][r] - m[r >> 1]) * il[r >> 1];
  mma::to_a(pa, p);
}

// One key block into the online row statistics of the lane's two rows
// (g, g + 8), from its logits s: m <- max(m, the block's row max), l <- l
// alpha + sum exp(s - m), alpha = exp(m_old - m) (1 while m is -inf), l the
// lane's share (the row's sum is the quad's); backward also D_run = sum
// exp(s - m) dp, rescaled as l: window_attention_tc.cuh's online_block
// with exp_f32, one code that gives both directions their m and l.
template <bool kBwd>
__device__ __forceinline__ void online(const float s[2][4],
                                       const float dp[2][4], float m[2],
                                       float l[2], float d_run[2]) {
  float mt[2] = {-INFINITY, -INFINITY}, e[2][4], alpha[2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) mt[r >> 1] = fmaxf(mt[r >> 1], s[j][r]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], mma::quad_max(mt[i]));
    alpha[i] = m_new == -INFINITY ? 1.f : exp_f32(m[i] - m_new);
    l[i] *= alpha[i];
    m[i] = m_new;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      e[j][r] = s[j][r] == -INFINITY ? 0.f : exp_f32(s[j][r] - m[r >> 1]);
      l[r >> 1] += e[j][r];
    }
  if (kBwd) {
#pragma unroll
    for (int i = 0; i < 2; ++i) d_run[i] *= alpha[i];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        d_run[r >> 1] = fmaf(e[j][r], dp[j][r], d_run[r >> 1]);
  }
}

// What both kernels share: the CTA's place, its shared memory, the live map
// and template slots, the stage's barrier and first load, and the sample
// loop's bookkeeping: sample i of the run completes phase i of `full`;
// after the warps take it out of the stage, thread 0 loads sample i + 1.
template <bool kBwd>
struct Cta {
  unsigned char* smem;
  uint64_t* full;
  const CUtensorMap* qkv_map;
  const CUtensorMap* do_map;
  Layout s;
  Tiles t;
  Tmpl tm;
  int h, slice, b0, count, c, n, nb, warp, lane, qb;
  // the warp's query block's live key blocks: the first two (kb1 = kb0
  // when there is one), and the rest; its key block's live query blocks
  // (kcol = 0: no query block reads it)
  unsigned qlive, rest, kcol;
  int kb0, kb1;
  bool two;

  __device__ Cta(unsigned char* smem_raw, uint64_t* bar, const Args& a,
                 const CUtensorMap* qm, const CUtensorMap* dm)
      : smem(aligned_1024(smem_raw)),
        full(bar),
        qkv_map(qm),
        do_map(dm),
        s(a.n, kBwd),
        t(smem, s, a.n) {
    h = blockIdx.x;
    slice = blockIdx.y;
    b0 = slice * a.per_slice;
    count = min(a.per_slice, a.batch - b0);
    n = a.n;
    nb = a.nb;
    c = a.num_heads * kD;
    warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    qb = warp;
    unsigned* live = reinterpret_cast<unsigned*>(smem + s.live);
    unsigned* dead = reinterpret_cast<unsigned*>(smem + s.dead);
    int* first = reinterpret_cast<int*>(smem + s.first);
    float* slots = reinterpret_cast<float*>(smem + s.slots);
    tm = Tmpl{slots, a.tmpl + static_cast<size_t>(h) * n * n, live, first, n};
    if (threadIdx.x == 0) {
      hopper::mbar_init(full, 1);
      hopper::mbar_fence_init();
      load_boxes(smem, qkv_map, do_map, full, s.box, b0, 0, h, c);
    }
    if (threadIdx.x < kMaxNb) live[threadIdx.x] = dead[threadIdx.x] = 0;
    __syncthreads();
    scan_live(live, dead, tm.glob, n, nb, warp, lane);
    __syncthreads();  // the live map
    const unsigned bits = live[qb];
    int pre = 0;  // the query block's first slot: live blocks in row order
    kcol = 0;
    for (int q = 0; q < nb; ++q) {
      if (q < qb) pre += __popc(live[q]);
      kcol |= ((live[q] >> qb) & 1u) << q;
    }
    if (lane == 0) first[qb] = pre;
    qlive = bits;
    split_pair(qlive, &kb0, &kb1, &two, &rest);
    // the query block's live blocks with a slot under kSlots into shared
    // memory, each lane its 8 entries of the accumulator layout
    int sl = pre;
    for (unsigned b = bits; b != 0 && sl < kSlots; b &= b - 1, ++sl) {
      float v[2][4];
      tm.frag(v, kSlots, qb, __ffs(b) - 1, lane);  // from global
      float4* dst = reinterpret_cast<float4*>(slots + sl * kBlockFloats +
                                              lane * 8);
      dst[0] = make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
      dst[1] = make_float4(v[1][0], v[1][1], v[1][2], v[1][3]);
    }
    __syncthreads();  // slots and first slots
  }

  // Wait for sample i and take it into the tiles; then the stage takes
  // sample i + 1.
  __device__ void take(int i) {
    if (i > 0) __syncthreads();  // every warp is done with the tiles
    hopper::mbar_wait(full, i & 1);
    unstage<kBwd>(smem, s.box, t, qb, lane);
    __syncthreads();  // the tiles written, the stage read
    if (threadIdx.x == 0 && i + 1 < count)
      load_boxes(smem, qkv_map, do_map, full, s.box, b0 + i + 1, 0, h, c);
  }
};

// One CTA per (head, slice), a warp per 16-row block.
__global__ void __launch_bounds__(kMaxThreads, 1)
    window_attention_dense_fwd_kernel(const __grid_constant__ CUtensorMap
                                          qkv_map,
                                      const Args a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full;
  Cta<false> x(smem_raw, &full, a, &qkv_map, nullptr);
  const int qb = x.qb;
  const int lane = x.lane;
  const Tiles& t = x.t;
  const Tmpl& tm = x.tm;
  const float scale = a.scale[x.h];
  const int first = tm.first[qb];

  for (int i = 0; i < x.count; ++i) {
    x.take(i);
    uint32_t qh[kD / 16][4], ql[kD / 16][4];
    mma::load_a<kD>(qh, t.qhi, qb * kBlk, lane);
    mma::load_a<kD>(ql, t.qlo, qb * kBlk, lane);
    // a. the logits of the first two live blocks, their product chains side
    // by side (kept for b); m and l online over every live block in order
    float cs[2][4], s0[2][4], s1[2][4], unused[2];
    block_logits(cs, s0, qh, ql, t, tm, scale, first, qb, x.kb0, lane);
    block_logits(cs, s1, qh, ql, t, tm, scale, first + x.two, qb, x.kb1,
                 lane);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    online<false>(s0, s0, m, l, unused);
    if (x.two) online<false>(s1, s1, m, l, unused);
    int k = 2;
    for (unsigned b = x.rest; b != 0; b &= b - 1, ++k) {
      float e[2][4];
      block_logits(cs, e, qh, ql, t, tm, scale, first + k, qb, __ffs(b) - 1,
                   lane);
      online<false>(e, e, m, l, unused);
    }
    float il[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) il[r] = 1.f / mma::quad_sum(l[r]);
    // b. out = round(p) . v over the same blocks, p normalised first
    float acc[kD / 8][4];
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
    uint32_t pa[4], pb[4];
    p_frag(pa, s0, m, il);
    p_frag(pb, s1, m, il);
    mma::product_nn<kD>(acc, pa, t.vt, x.kb0 * kBlk, lane);
    if (x.two) mma::product_nn<kD>(acc, pb, t.vt, x.kb1 * kBlk, lane);
    k = 2;
    for (unsigned b = x.rest; b != 0; b &= b - 1, ++k) {
      const int kb = __ffs(b) - 1;
      float e[2][4];
      block_logits(cs, e, qh, ql, t, tm, scale, first + k, qb, kb, lane);
      p_frag(pa, e, m, il);
      mma::product_nn<kD>(acc, pa, t.vt, kb * kBlk, lane);
    }
    mma::store_rows<kD>(
        a.out + static_cast<size_t>(x.b0 + i) * x.n * x.c +
            static_cast<size_t>(x.h) * kD,
        x.c, acc, qb * kBlk, x.n, 1.f, lane);
  }
}

// The backward's dlog of live block (qb, kb), slot sl, from its logits s,
// cos and dp in the accumulator layout: added to the slab's sums (read
// before unless the CTA's first sample), dlog cos to the lane's d_scale
// share, and dq^ += (dlog scale) . k^ (split_nn).
__device__ __forceinline__ void dlog_block(float dq[kD / 8][4], float& ds,
                                           float* slab, bool first_sample,
                                           const float s[2][4],
                                           const float cs[2][4],
                                           const float dp[2][4],
                                           const float m[2], const float il[2],
                                           const float delta[2], float scale,
                                           const Tiles& t, int sl, int kb,
                                           int lane) {
  float4* acc =
      reinterpret_cast<float4*>(slab + static_cast<size_t>(sl) * kBlockFloats);
  float4 old[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                   make_float4(0.f, 0.f, 0.f, 0.f)};
  if (!first_sample) {  // the slab's sums so far
    old[0] = __ldcg(acc);
    old[1] = __ldcg(acc + 1);
  }
  float gh[2][4], gl[2][4], dl[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float p = exp_f32(s[j][r] - m[r >> 1]) * il[r >> 1];
      dl[j][r] = p * (dp[j][r] - delta[r >> 1]);
      ds = fmaf(dl[j][r], cs[j][r], ds);
      const float dc = dl[j][r] * scale;
      gh[j][r] = dc;
      gl[j][r] = dc - __bfloat162float(__float2bfloat16(dc));
    }
  __stcg(acc, make_float4(old[0].x + dl[0][0], old[0].y + dl[0][1],
                          old[0].z + dl[0][2], old[0].w + dl[0][3]));
  __stcg(acc + 1, make_float4(old[1].x + dl[1][0], old[1].y + dl[1][1],
                              old[1].z + dl[1][2], old[1].w + dl[1][3]));
  uint32_t gha[4], gla[4];
  mma::to_a(gha, gh);
  mma::to_a(gla, gl);
  split_nn<kD>(dq, gha, gla, t.khi, t.klo, kb * kBlk, lane);
}

// The key sweep's step on live block (qb, kb), slot sl, from cos^T and dp^T
// of the warp's key block against query block qb (keys the rows): p^T from
// the rows' m and 1 / l, dlog^T from their delta; dv += round(p)^T . dO and
// dk^ += (dlog scale)^T . q^.
__device__ __forceinline__ void key_block(float dk[kD / 8][4],
                                          float dv[kD / 8][4],
                                          const float s[2][4],
                                          const float dp[2][4],
                                          const Tiles& t, const Tmpl& tm,
                                          float scale, int sl, int qb, int kb,
                                          int lane) {
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  float p[2][4], gh[2][4], gl[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int key = g + 8 * (r >> 1);
      const int q = 8 * j + t2 + (r & 1);
      const int row = qb * kBlk + q;
      const float pv =
          exp_f32(logit(s[j][r], scale, tm.at(sl, qb, kb, q, key)) -
                  t.mrow[row]) *
          t.irow[row];
      const float dc = pv * (dp[j][r] - t.drow[row]) * scale;
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

// One CTA per (head, slice), a warp per 16-row block.  The d_template
// accumulators are not kept in registers (8 a live block and lane, 128 for
// a query block kept whole) but in the CTA's slab of `part`, read and
// written back per sample by the lane that owns the entries.
__global__ void __launch_bounds__(kMaxThreads, 1)
    window_attention_dense_bwd_kernel(const __grid_constant__ CUtensorMap
                                          qkv_map,
                                      const __grid_constant__ CUtensorMap
                                          do_map,
                                      const Args a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full;
  Cta<true> x(smem_raw, &full, a, &qkv_map, &do_map);
  const int lane = x.lane;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  const int n = x.n;
  const int nb = x.nb;
  const Tiles& t = x.t;
  const Tmpl& tm = x.tm;
  const float scale = a.scale[x.h];
  const size_t stride = 3 * static_cast<size_t>(x.c);
  const size_t plane = static_cast<size_t>(nb) * nb * kBlockFloats;
  float* slab = a.part + (static_cast<size_t>(x.slice) * a.num_heads + x.h) *
                             plane + lane * 8;
  float* dtm = a.dtmpl + static_cast<size_t>(x.h) * n * n;
  const unsigned* live = tm.live;

  // this CTA's share of the dead blocks of d_template: 0
  for (int f = x.slice * blockDim.x + threadIdx.x; f < n * n / 4;
       f += a.slices * blockDim.x) {
    const int row = f / (n / 4);
    const int col = (f % (n / 4)) * 4;
    if (!((live[row / kBlk] >> (col / kBlk)) & 1u))
      *reinterpret_cast<float4*>(dtm + static_cast<size_t>(row) * n + col) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float ds = 0.f;
  for (int i = 0; i < x.count; ++i) {
    x.take(i);
    bf16* dst = a.out + static_cast<size_t>(x.b0 + i) * n * stride +
                static_cast<size_t>(x.h) * kD;
    {  // a. warp on query block qb: the stats, then dlog and dq^
      const int qb = x.qb;
      const int first = tm.first[qb];
      uint32_t qh[kD / 16][4], ql[kD / 16][4], da[kD / 16][4];
      mma::load_a<kD>(qh, t.qhi, qb * kBlk, lane);
      mma::load_a<kD>(ql, t.qlo, qb * kBlk, lane);
      mma::load_a<kD>(da, t.dot, qb * kBlk, lane);
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      float d_run[2] = {0.f, 0.f}, il[2], delta[2];
      int k = 0;
      for (unsigned b = x.qlive; b != 0; b &= b - 1, ++k) {
        const int kb = __ffs(b) - 1;
        float cs[2][4], e[2][4], dp[2][4];
        block_logits(cs, e, qh, ql, t, tm, scale, first + k, qb, kb, lane);
        mma::product_nt<kD>(dp, da, t.vt, kb * kBlk, lane);
        online<true>(e, dp, m, l, d_run);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float l_row = mma::quad_sum(l[r]);
        il[r] = 1.f / l_row;
        delta[r] = mma::quad_sum(d_run[r]) / l_row;
      }
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
      k = 0;
      for (unsigned b = x.qlive; b != 0; b &= b - 1, ++k) {
        const int kb = __ffs(b) - 1;
        // the fragments again from the tiles: held across this loop beside
        // dq^, they spilled at the 128 registers a thread of 512
        mma::load_a<kD>(qh, t.qhi, qb * kBlk, lane);
        mma::load_a<kD>(ql, t.qlo, qb * kBlk, lane);
        mma::load_a<kD>(da, t.dot, qb * kBlk, lane);
        float cs[2][4], e[2][4], dp[2][4];
        block_logits(cs, e, qh, ql, t, tm, scale, first + k, qb, kb, lane);
        mma::product_nt<kD>(dp, da, t.vt, kb * kBlk, lane);
        dlog_block(dq, ds, slab, i == 0, e, cs, dp, m, il, delta, scale, t,
                   first + k, kb, lane);
      }
      store_normalised<kD>(dst, stride, dq, t.qhi, t.qlo, t.qfac, qb * kBlk,
                           n, lane);
    }
    __syncthreads();  // every row's stats

    {  // b. warp on key block kb: its live query blocks
      const int kb = x.qb;
      float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) dk[j][r] = dv[j][r] = 0.f;
      uint32_t kh[kD / 16][4], kl[kD / 16][4], va[kD / 16][4];
      mma::load_a<kD>(kh, t.khi, kb * kBlk, lane);
      mma::load_a<kD>(kl, t.klo, kb * kBlk, lane);
      mma::load_a<kD>(va, t.vt, kb * kBlk, lane);
      for (unsigned b = x.kcol; b != 0; b &= b - 1) {
        const int qb = __ffs(b) - 1;
        float s[2][4], dp[2][4];
        split_nt<kD>(s, kh, kl, t.qhi, t.qlo, qb * kBlk, lane);  // cos^T
        mma::product_nt<kD>(dp, va, t.dot, qb * kBlk, lane);     // dp^T
        key_block(dk, dv, s, dp, t, tm, scale, tm.slot(qb, kb), qb, kb, lane);
      }
      store_normalised<kD>(dst + x.c, stride, dk, t.khi, t.klo, t.kfac,
                           kb * kBlk, n, lane);
      mma::store_rows<kD>(dst + 2 * x.c, stride, dv, kb * kBlk, n, 1.f,
                          lane);
    }
  }

  // d_scale: the CTA's partial, warps in order; then the ticket
  float* red = reinterpret_cast<float*>(x.smem + x.s.red);
  int* flag = reinterpret_cast<int*>(red + kMaxNb);
  ds = warp_sum(ds);
  if (lane == 0) red[x.warp] = ds;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int w = 0; w < nb; ++w) sum += red[w];
    a.ds_part[static_cast<size_t>(x.h) * a.slices + x.slice] = sum;
  }
  if (!last_cta(a.tickets + x.h, a.slices, flag)) return;
  // the last CTA of the head: d_template = the slabs summed in slice order
  // on the live blocks; warp qb takes its query block's
  const int qb = x.qb;
  int k = 0;
  for (unsigned b = x.qlive; b != 0; b &= b - 1, ++k) {
    const int kb = __ffs(b) - 1;
    const size_t at = static_cast<size_t>(tm.first[qb] + k) * kBlockFloats;
    float4 sum[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                     make_float4(0.f, 0.f, 0.f, 0.f)};
    for (int sl = 0; sl < a.slices; ++sl) {
      const float4* p = reinterpret_cast<const float4*>(
          a.part + (static_cast<size_t>(sl) * a.num_heads + x.h) * plane + at +
          lane * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 v = __ldcg(p + j);
        sum[j].x += v.x;
        sum[j].y += v.y;
        sum[j].z += v.z;
        sum[j].w += v.w;
      }
    }
    float* row = dtm + static_cast<size_t>(qb * kBlk + g) * n + kb * kBlk + t2;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      *reinterpret_cast<float2*>(row + 8 * j) = make_float2(sum[j].x, sum[j].y);
      *reinterpret_cast<float2*>(row + 8 * static_cast<size_t>(n) + 8 * j) =
          make_float2(sum[j].z, sum[j].w);
    }
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool takes(int n) { return dense_takes(n); }

// The arguments both entry points take, checked; per_slice from slices.
cudaError_t check(Args* a, const void* qkv, const void* scale,
                  const void* tmpl, void* out, int batch, int n,
                  int num_heads, int head_dim, int slices, int cluster) {
  if (batch < 1 || !takes(n) || num_heads < 1 || num_heads > 65535 ||
      head_dim != kD || slices < 1 || slices > batch || slices > 65535 ||
      cluster < 1 || cluster > 8 || (cluster & (cluster - 1)) != 0 ||
      slices % cluster != 0 ||
      qkv == nullptr || scale == nullptr || tmpl == nullptr ||
      out == nullptr || !aligned(qkv) || !aligned(tmpl) || !aligned(out))
    return cudaErrorInvalidValue;
  a->per_slice = (batch + slices - 1) / slices;
  if ((slices - 1) * a->per_slice >= batch)  // an empty slice
    return cudaErrorInvalidValue;
  a->scale = static_cast<const float*>(scale);
  a->tmpl = static_cast<const float*>(tmpl);
  a->out = static_cast<bf16*>(out);
  a->batch = batch;
  a->n = n;
  a->nb = n / kBlk;
  a->num_heads = num_heads;
  a->slices = slices;
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, bool bwd) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Layout(kMaxN, bwd).bytes));
}

cudaError_t grid_map(CUtensorMap* map, const void* base, int batch, int n,
                     int cols) {
  return head_box_map(map, base, batch, n, cols, n);
}

// A launch of `kernel` on the grid (num_heads, slices), in clusters of cs
// consecutive slices of one head.
cudaLaunchConfig_t config(int num_heads, int slices, int n, bool bwd,
                          cudaStream_t stream, cudaLaunchAttribute* attr,
                          int cs) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(num_heads, slices);
  cfg.blockDim = dim3(32 * (n / kBlk));
  cfg.dynamicSmemBytes = Layout(n, bwd).bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = cs;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster a call takes: the most CTAs of a head (a divisor of slices,
// at most 8, the portable limit) whose clusters the card still holds in one
// wave, so that the head's template is scanned as few times as the card
// allows (at B = 32, H = 16, N = 256 on an H100: 8, the 8 slices of a head
// in one cluster, if its GPCs hold 16 clusters of 8).
template <typename Kernel>
cudaError_t cluster_of(Kernel kernel, int num_heads, int slices, int n,
                       bool bwd, int* cs) {
  cudaError_t err = prepare(kernel, bwd);
  for (int c = 8; c >= 1 && err == cudaSuccess; c /= 2) {
    if (slices % c != 0) continue;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        config(num_heads, slices, n, bwd, nullptr, &attr, c);
    int fit = 0;
    err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (err == cudaSuccess &&
        (c == 1 || static_cast<long long>(fit) * c >=
                       static_cast<long long>(num_heads) * slices)) {
      *cs = c;
      return cudaSuccess;
    }
  }
  return err;
}

}  // namespace

// The batch slices a call at (batch, n, num_heads) takes: the count whose
// CTAs (num_heads x slices) fill the current device's SMs in the fewest
// sample-times (waves x the samples a CTA takes), the smaller on a tie, so
// the fewest d_template partials.  At B = 32, N = 256, H = 16 on 132 SMs: 8
// (128 CTAs of 4 samples; 16 would take two waves of 2).  Negative on a CUDA
// error.
extern "C" int tpat_window_attention_dense_slices(int batch, int n,
                                                  int num_heads, int bwd) {
  if (batch < 1 || !takes(n) || num_heads < 1)
    return -static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int threads = 32 * (n / kBlk);
  const size_t smem = Layout(n, bwd != 0).bytes;
  if (err == cudaSuccess) {
    if (bwd) {
      err = prepare(window_attention_dense_bwd_kernel, true);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, window_attention_dense_bwd_kernel, threads, smem);
    } else {
      err = prepare(window_attention_dense_fwd_kernel, false);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, window_attention_dense_fwd_kernel, threads, smem);
    }
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidValue);
  const long long slots = static_cast<long long>(sms) * per_sm;
  int best = 1;
  long long best_t = -1;
  for (int s = 1; s <= batch && s <= 65535; ++s) {
    const long long per = (batch + s - 1) / s;
    if ((s - 1) * per >= batch) continue;  // an empty slice
    const long long t =
        (static_cast<long long>(num_heads) * s + slots - 1) / slots * per;
    if (best_t < 0 || t < best_t) {
      best = s;
      best_t = t;
    }
  }
  return best;
}

// The dynamic shared memory of each kernel at n tokens (bwd = 0: forward),
// for the record beside ptxas's report.
extern "C" long long tpat_window_attention_dense_smem(int n, int bwd) {
  return takes(n) ? static_cast<long long>(Layout(n, bwd != 0).bytes) : -1;
}

// The CTAs a cluster of a call at (n, num_heads, slices) takes (bwd = 0:
// the forward; cluster_of); negative on a CUDA error.
extern "C" int tpat_window_attention_dense_cluster(int n, int num_heads,
                                                   int slices, int bwd) {
  if (!takes(n) || num_heads < 1 || slices < 1)
    return -static_cast<int>(cudaErrorInvalidValue);
  int cs = 1;
  const cudaError_t err =
      bwd ? cluster_of(window_attention_dense_bwd_kernel, num_heads, slices,
                       n, true, &cs)
          : cluster_of(window_attention_dense_fwd_kernel, num_heads, slices,
                       n, false, &cs);
  return err == cudaSuccess ? cs : -static_cast<int>(err);
}

// qkv: (batch, n, 3 C) bf16 contiguous in the grid's original order, C =
// num_heads * 32; scale: (num_heads,) f32; tmpl: (num_heads, n, n) f32;
// n a multiple of 16 up to 256; out: (batch, n, C) bf16; slices: 1 ..
// batch, no slice empty (tpat_window_attention_dense_slices); cluster: 1,
// 2, 4 or 8 dividing slices (tpat_window_attention_dense_cluster).  qkv,
// tmpl and out 16-byte aligned.  Launches one kernel on `stream`, synchronises
// nothing, returns the CUDA error (0 on success).
extern "C" int tpat_window_attention_dense_fwd(const void* qkv,
                                               const void* scale,
                                               const void* tmpl, void* out,
                                               int batch, int n, int num_heads,
                                               int head_dim, int slices,
                                               int cluster, void* stream) {
  Args a{};
  cudaError_t err = check(&a, qkv, scale, tmpl, out, batch, n, num_heads,
                          head_dim, slices, cluster);
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  err = grid_map(&map, qkv, batch, n, 3 * num_heads * kD);
  if (err != cudaSuccess) return err;
  err = prepare(window_attention_dense_fwd_kernel, false);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(
      num_heads, slices, n, false, static_cast<cudaStream_t>(stream), &attr,
      cluster);
  err = cudaLaunchKernelEx(&cfg, window_attention_dense_fwd_kernel, map, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// As the forward, with dout: (batch, n, C) bf16, 16-byte aligned.  Writes
// dqkv (batch, n, 3 C) bf16, dtmpl (num_heads, n, n) f32 (summed over the
// batch; 0 on the dead blocks) and ds_part (num_heads, slices) f32, whose
// rows sum to d_scale.  part: (slices, num_heads, (n / 16)^2, 256) f32, the
// CTAs' slabs (room for every block; a call touches each head's live blocks
// only, at the front of its slab; contents on entry do not matter); with
// slices > 1, tickets: (num_heads,) int32, all 0 (the kernel leaves them
// 0).
extern "C" int tpat_window_attention_dense_bwd(
    const void* qkv, const void* scale, const void* tmpl, const void* dout,
    void* dqkv, void* dtmpl, void* part, void* ds_part, void* tickets,
    int batch, int n, int num_heads, int head_dim, int slices, int cluster,
    void* stream) {
  Args a{};
  cudaError_t err = check(&a, qkv, scale, tmpl, dqkv, batch, n, num_heads,
                          head_dim, slices, cluster);
  if (err != cudaSuccess) return err;
  if (dout == nullptr || !aligned(dout) || dtmpl == nullptr ||
      !aligned(dtmpl) || ds_part == nullptr || part == nullptr ||
      !aligned(part) || (slices > 1 && tickets == nullptr))
    return cudaErrorInvalidValue;
  a.dtmpl = static_cast<float*>(dtmpl);
  a.part = static_cast<float*>(part);
  a.ds_part = static_cast<float*>(ds_part);
  a.tickets = static_cast<int*>(tickets);
  CUtensorMap qkv_map, do_map;
  err = grid_map(&qkv_map, qkv, batch, n, 3 * num_heads * kD);
  if (err == cudaSuccess)
    err = grid_map(&do_map, dout, batch, n, num_heads * kD);
  if (err != cudaSuccess) return err;
  err = prepare(window_attention_dense_bwd_kernel, true);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(
      num_heads, slices, n, true, static_cast<cudaStream_t>(stream), &attr,
      cluster);
  err = cudaLaunchKernelEx(&cfg, window_attention_dense_bwd_kernel, qkv_map,
                           do_map, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
