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
//         (exact, not approximate), normalised by multiplying with the
//         reciprocal of the row sum; keys at or past kv_valid get p = 0, as
//         the TPU kernel's -1e30 logit gives them (kv_valid = N: all keys);
//   out = cast_to_input_dtype(p) . v, accumulated in f32, written in the
//         input dtype -- the same rounding point as the JAX kernel;
//   'patch_mean': column sums of the normalised f32 p over query rows in
//                 [extra, kv_valid) (the AudioMAE importance signal);
//   'cls':        the row-0 probabilities (the AST importance signal);
//   none:         no score output and no score work.
// The logits are the f32 sum of the products times D^-1/2 (the scale after
// the product, q is never pre-scaled).  q, k and v are read straight out of
// the packed (B, N, 3C) projection output (sections at column offsets 0, C
// and 2C, head h at h*D) and out is written as (B, N, C): no permute on
// either side.
//
// Head dims 32 (the MAE's plain decoder: 512 wide, 16 heads), 64 (ViT-B) and
// 80 (ViT-H), in both bodies below.
//
// Both bodies: one CTA = one (b, h, tile of 64 query rows).  Pass 1
// walks K once and keeps each row's running max and denominator (online
// rescaling), so the softmax is exact without holding a 64 x N logit tile;
// pass 2 walks K and V again, recomputes the same logits (same code, same
// order, so p <= 1 and rows sum to 1), accumulates p.v and the score column
// sums.  Column sums go to an f32 partial buffer (B, H, n_qtiles, N) that the
// wrapper sums over q-tiles: no atomics, so scores are deterministic.  Ragged
// edges (none of 257/181/127/90 is a multiple of 64) are masked: rows past N
// load as zero and are never written, keys past kv_valid get p = 0.  The
// prefix form is the same code with kv_valid < N in the key predicate: rows
// at or past kv_valid are still computed and written, as on the TPU.
//
// bf16 (every path of the model): what bounds it is bytes.  One b128 call at
// N = 257 moves ~200 MB (~60 us at 3.35 TB/s) and does ~26 GFLOP (~26 us at
// 989 TFLOP/s), so the products belong on the tensor cores and the tiles in
// bf16.  Four warps, each owning 16 query rows; Q, K and V are staged in
// shared memory as bf16 with 16-byte cp.async copies into padded rows
// (attention_mma.cuh), K/V tiles double-buffered so the copy of tile j+1
// overlaps the products of tile j.  q.k^T and p.v run as mma.sync m16n8k16
// (f32 accumulation) fed by ldmatrix (.trans for V); the Q fragments stay in
// registers.  The softmax works on the accumulator fragments: the row max
// and sum are quad reductions, the normalised f32 p feeds the column sums
// (a reduce-scatter over the warp's 8 quads, 4 shuffles per 16 keys, then
// the 4 warps through shared memory) and, rounded to bf16, is the A
// operand of p.v without passing through shared memory.  Keys are processed 16 at a time; tiles wholly past
// kv_valid are not visited.
//
// f32 (the parity checks, which hold it to plain at 1e-5 and need equal
// pruning indices): tensor-core f32 would be TF32, so it stays on exact FMA
// loops with the Q tile in shared memory as f32, K (and V) streamed, each
// thread owning a 4 x 4 register micro-tile (rows ty + 16i, keys or head
// dims tx + 16j) over shared rows padded by one float.

#include <cmath>
#include <cstddef>

#include "attention_mma.cuh"
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

// Shared memory of the bf16 kernel, in bytes: the Q tile, two K and two V
// tiles, and the 4 warps' column sums of one key tile.
template <int D>
struct SmemBf16 {
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
    qkv_attention_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ qkv,
                                  __nv_bfloat16* __restrict__ out,
                                  float* __restrict__ colsum, int n,
                                  int num_heads, int mode, int extra,
                                  int kv_valid, float scale) {
  using mma::bf16;
  using S = SmemBf16<D>;
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
cudaError_t launch_bf16(const void* qkv, void* out, void* colsum, int batch,
                        int n, int num_heads, int mode, int extra,
                        int kv_valid, float scale, cudaStream_t stream) {
  auto kernel = qkv_attention_fwd_bf16_kernel<D>;
  constexpr size_t smem = SmemBf16<D>::kBytes;
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

// Query rows per CTA (64 in both instantiations): the patch_mean partial
// buffer holds ceil(n / this) q-tiles, so the wrapper sizes it from here and
// nowhere else.
static_assert(kBQ == mma::kRows, "both instantiations tile 64 query rows");
extern "C" int tpat_qkv_attention_qtile() { return kBQ; }

// dtype: 0 = float32, 1 = bfloat16.  mode: 0 = none, 1 = patch_mean,
// 2 = cls.  colsum: (batch, num_heads, n_qtiles, n) f32 for patch_mean, with
// n_qtiles = ceil(n / tpat_qkv_attention_qtile()),
// (batch, num_heads, 1, n) for cls, unused for none.  kv_valid in
// (extra, n]: keys [0, kv_valid) are valid (n for the plain form).  Returns
// the CUDA error of the launch (0 on success).
extern "C" int tpat_qkv_attention_fwd(const void* qkv, void* out, void* colsum,
                                      int batch, int n, int num_heads,
                                      int head_dim, int dtype, int mode,
                                      int extra, int kv_valid, float scale,
                                      void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || num_heads < 1 ||
      num_heads > 65535 || mode < kModeNone || mode > kModeCls || extra < 0 ||
      kv_valid <= extra || kv_valid > n ||
      (mode != kModeNone && colsum == nullptr)) {
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
    return launch_bf16<32>(qkv, out, colsum, batch, n, num_heads, mode, extra,
                           kv_valid, scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch_bf16<64>(qkv, out, colsum, batch, n, num_heads, mode, extra,
                           kv_valid, scale, s);
  if (dtype == 1 && head_dim == 80)
    return launch_bf16<80>(qkv, out, colsum, batch, n, num_heads, mode, extra,
                           kv_valid, scale, s);
  return cudaErrorInvalidValue;
}
