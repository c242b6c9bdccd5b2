// Attention probe kernels for Hopper (sm_90a): the counterparts of the two
// Pallas probes of the fused attention forward,
//   scripts/probe_attn_softmax.py::_variant_kernel  (P1: six softmax variants)
//   scripts/probe_attn_grouping.py::_kernel         (P2: program geometry)
// built on one body, the B1 forward (csrc/qkv_attention.cu, whose helpers
// it shares through qkv_attention_common.cuh) without its prefix and 'cls'
// forms, with the softmax variant, the query-tile height and the heads per
// CTA as template parameters.
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
// What bounds it at the probe's shapes (B = 128, N = 257 or 181, H = 12):
// like B1, the N^2 D logit and p.v work per head on the FMA pipes (every K or
// V element staged in shared memory feeds BQ FMAs), not the 204 MB of q, k,
// v and out.  Design: one CTA = one (b, group of HPB heads, tile of BQ query
// rows), 256 threads; the Q tile is held in shared memory as f32, K and V
// stream through it in tiles of 64 keys; pass 1 keeps each row's running max
// and denominator (online rescaling; skipped where the variant needs
// neither), pass 2 recomputes the same logits, writes p to shared memory,
// accumulates p.v in registers and reduces the column sums; each thread owns
// a (BQ / 16) x 4 micro-tile (rows ty + 16 i, keys or head dims tx + 16 j).
// The heads of a CTA run one after the other: P2 asks what fewer, longer
// CTAs (HPB) and taller query tiles (BQ) buy, as the TPU probe asked of its
// batch group and lane width.  Plain FMA loops, no tensor cores.

#include <cmath>
#include <cstddef>

#include "qkv_attention_common.cuh"

namespace {

constexpr int kD = 64;   // head dim of the probe (C = 768, H = 12)
constexpr int kBK = 64;  // keys per streamed tile
constexpr int kVariantRows = 64;  // P1's query tile: the B1 kernel's

enum Variant { kFull = 0, kNoScore, kExp2, kNoExp, kNoMax, kMmOnly };

// Shared-memory layout in floats for a query tile of BQ rows.
template <int BQ>
struct Smem {
  static constexpr int kLd = kD + 1;    // padded Q/K rows
  static constexpr int kPLd = kBK + 1;  // padded p rows
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + BQ * kLd;
  static constexpr int kV = kK + kBK * kLd;
  static constexpr int kP = kV + kBK * kD;
  static constexpr int kRed = kP + BQ * kPLd;
  static constexpr int kFloats = kRed + 4 * kBK;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <int V>
__device__ __forceinline__ float expo(float v) {
  return V == kExp2 ? exp2f(v) : expf(v);
}

template <typename T, int BQ, int HPB, int V>
__global__ void __launch_bounds__(kThreads)
    attn_probe_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                      float* __restrict__ colsum, int n, int num_heads,
                      float scale) {
  static_assert(BQ % 16 == 0 && BQ >= 32, "BQ rows split over 16 lanes x 4 parts");
  constexpr int RI = BQ / 16;
  constexpr int kDj = kD / 16;
  constexpr bool kMax = V == kFull || V == kNoScore || V == kExp2 || V == kNoExp;
  constexpr bool kNorm = V == kFull || V == kNoScore || V == kExp2 || V == kNoMax;
  using S = Smem<BQ>;
  extern __shared__ float smem[];
  float* qs = smem + S::kQ;
  float* ks = smem + S::kK;
  float* vs = smem + S::kV;
  float* ps = smem + S::kP;
  float* red = smem + S::kRed;

  const int qt = blockIdx.x;
  const int b = blockIdx.z;
  const int c = num_heads * kD;
  const size_t row_stride = 3 * static_cast<size_t>(c);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = qt * BQ;

  for (int hh = 0; hh < HPB; ++hh) {
    const int h = blockIdx.y * HPB + hh;
    const T* q_src = qkv + static_cast<size_t>(b) * n * row_stride +
                     static_cast<size_t>(h) * kD;
    const T* k_src = q_src + c;
    const T* v_src = q_src + 2 * c;
    __syncthreads();  // the previous head's tiles fully consumed
    load_rows<T, kD>(qs, S::kLd, q_src, row_stride, q0, BQ, n);

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
        load_rows<T, kD>(ks, S::kLd, k_src, row_stride, k0, kBK, n);
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
      load_rows<T, kD>(ks, S::kLd, k_src, row_stride, k0, kBK, n);
      load_rows<T, kD>(vs, kD, v_src, row_stride, k0, kBK, n);
      __syncthreads();
      float s[RI][4];
      tile_logits<kD, RI>(qs, ks, tx, ty, scale, s);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float p = 0.f;
          if (k0 + tx + 16 * j < n) {
            if (V == kNoExp)
              p = s[i][j] - m[i];
            else if (V == kMmOnly)
              p = s[i][j];
            else
              p = expo<V>(s[i][j] - m[i]) * inv[i];
          }
          ps[(ty + 16 * i) * S::kPLd + tx + 16 * j] = p;
        }
      __syncthreads();

      const int kn = min(kBK, n - k0);
      for (int kk = 0; kk < kn; ++kk) {
        float p[RI], v[kDj];
#pragma unroll
        for (int i = 0; i < RI; ++i)
          p[i] = Io<T>::round(ps[(ty + 16 * i) * S::kPLd + kk]);
#pragma unroll
        for (int j = 0; j < kDj; ++j) v[j] = vs[kk * kD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < kDj; ++j) o[i][j] = fmaf(p[i], v[j], o[i][j]);
      }

      if (V == kFull) {
        // four partial sums of BQ / 4 rows per key column, then one per
        // column; query row 0 is left out
        const int col = tid & (kBK - 1);
        const int part = tid / kBK;
        float acc = 0.f;
        for (int r = part * (BQ / 4); r < (part + 1) * (BQ / 4); ++r) {
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
        T* dst = out + (static_cast<size_t>(b) * n + row) * c +
                 static_cast<size_t>(h) * kD;
#pragma unroll
        for (int j = 0; j < kDj; ++j) Io<T>::store(dst + tx + 16 * j, o[i][j]);
      }
    }
  }
}

template <typename T, int BQ, int HPB, int V>
cudaError_t launch(const void* qkv, void* out, void* colsum, int batch, int n,
                   int num_heads, float scale, cudaStream_t stream) {
  auto kernel = attn_probe_kernel<T, BQ, HPB, V>;
  constexpr size_t smem = Smem<BQ>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BQ - 1) / BQ, num_heads / HPB, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out),
      static_cast<float*>(colsum), n, num_heads, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_variant(int variant, const void* qkv, void* out,
                           void* colsum, int batch, int n, int num_heads,
                           float scale, cudaStream_t s) {
  constexpr int R = kVariantRows;
  switch (variant) {
    case kFull:
      return launch<T, R, 1, kFull>(qkv, out, colsum, batch, n, num_heads, scale, s);
    case kNoScore:
      return launch<T, R, 1, kNoScore>(qkv, out, colsum, batch, n, num_heads, scale, s);
    case kExp2:
      return launch<T, R, 1, kExp2>(qkv, out, colsum, batch, n, num_heads, scale, s);
    case kNoExp:
      return launch<T, R, 1, kNoExp>(qkv, out, colsum, batch, n, num_heads, scale, s);
    case kNoMax:
      return launch<T, R, 1, kNoMax>(qkv, out, colsum, batch, n, num_heads, scale, s);
    case kMmOnly:
      return launch<T, R, 1, kMmOnly>(qkv, out, colsum, batch, n, num_heads, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int BQ>
cudaError_t launch_grouped(int heads, const void* qkv, void* out, int batch,
                           int n, int num_heads, float scale, cudaStream_t s) {
  using T = __nv_bfloat16;
  switch (heads) {
    case 1:
      return launch<T, BQ, 1, kNoScore>(qkv, out, nullptr, batch, n, num_heads, scale, s);
    case 2:
      return launch<T, BQ, 2, kNoScore>(qkv, out, nullptr, batch, n, num_heads, scale, s);
    case 4:
      return launch<T, BQ, 4, kNoScore>(qkv, out, nullptr, batch, n, num_heads, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory of a CTA with query tiles of `rows` (0 for a height
// the source has no instantiation of).
extern "C" long long tpat_attn_probe_smem(int rows) {
  switch (rows) {
    case 32: return Smem<32>::kBytes;
    case 64: return Smem<64>::kBytes;
    case 128: return Smem<128>::kBytes;
    default: return 0;
  }
}

// Query rows per CTA of the variant kernels: the 'full' partial buffer holds
// ceil(n / this) q-tiles, so the wrapper sizes it from here and nowhere else.
extern "C" int tpat_attn_probe_variant_rows() { return kVariantRows; }

// P1: the six variants at kVariantRows-row query tiles, one head per CTA.  dtype:
// 0 = float32, 1 = bfloat16; variant: 0 full, 1 noscore, 2 exp2, 3 noexp,
// 4 nomax, 5 mmonly.  colsum: (batch, num_heads, n_qtiles, n) f32 for
// 'full' (n_qtiles = ceil(n / tpat_attn_probe_variant_rows())), unused
// otherwise.  scale: the logit scale (D^-1/2, times log2(e)
// for exp2).  Returns the CUDA error of the launch (0 on success).
extern "C" int tpat_attn_probe_variant(const void* qkv, void* out,
                                       void* colsum, int batch, int n,
                                       int num_heads, int dtype, int variant,
                                       float scale, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || num_heads < 1 ||
      num_heads > 65535 || (variant == kFull && colsum == nullptr))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_variant<float>(variant, qkv, out, colsum, batch, n,
                                 num_heads, scale, s);
  if (dtype == 1)
    return launch_variant<__nv_bfloat16>(variant, qkv, out, colsum, batch, n,
                                         num_heads, scale, s);
  return cudaErrorInvalidValue;
}

// P2: softmax attention without scores (the noscore body), bf16, at query
// tiles of `rows` in {32, 64, 128} and `heads` in {1, 2, 4} heads per CTA
// (num_heads a multiple of it).
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
