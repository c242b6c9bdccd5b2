// LayerNorm prologue fused into a matrix product, for Hopper (sm_90a): the
// counterpart of the probe kernel scripts/probe_ln_matmul.py::_ln_mm_kernel.
//
// What it computes, for x (M, K), g and b (K,) f32, w (K, N):
//   y   = LN(x) per row with f32 statistics (mean, then the centred
//         variance), y = (x - mu) * rsqrt(var + eps) * g + b, rounded to x's
//         dtype (the TPU kernel's y.astype(x.dtype));
//   out = y . w, accumulated in f32, written in x's dtype.
// The product is computed here, in the kernel's own body: no library GEMM.
//
// What bounds it: operations.  At the probe's shapes (M = 128 * 257,
// K = 768, N = 2304) the product is 116 GFLOP against 205 MB of traffic,
// far above the H100's ~295 operations per byte in bf16.
//
// bf16: the tensor-core kernel (ln_matmul_bf16_tc_kernel), on the pieces of
// hopper_tma_wgmma.cuh.
//   - Output tiles of 128 rows x 256 columns.  Persistent CTAs, at most one
//     per SM: CTA c takes row blocks c, c + grid, ... and runs each block's
//     column tiles back to back, so the block's LayerNorm statistics are
//     computed once and kept in registers, and its rows of x stay in L2
//     while the column tiles re-read them; w (3.5 MB at the probe's shapes)
//     stays in L2 throughout.
//   - 384 threads: two consumer warpgroups (warps 0-3, 4-7), each owning 64
//     rows of the tile, and a producer warpgroup (warps 8-11) whose first
//     thread issues the TMA loads.  setmaxnreg moves registers from the
//     producers (40 a thread) to the consumers (232), whose 64 x 256 f32
//     accumulator takes 128 a thread.
//   - A ring of three 48 KB stages in shared memory, filled by TMA with the
//     128-byte swizzle under a "full" mbarrier per stage (one arrival plus
//     the bytes of its boxes) and handed back under an "empty" mbarrier (one
//     arrival per consumer warp).  Per row block the producer sends x's
//     (128 x 64) slices alone twice, for the statistics, then per column
//     tile and 64-deep slice of K x's slice and w's (64 x 256) slice (four
//     boxes of 64 columns).
//   - The LayerNorm without storing y: each consumer thread takes mu, then
//     the centred variance (f32, two passes, as the TPU kernel) of its two
//     fragment rows over the first two sweeps, from the same ldmatrix
//     fragments as the product, summed per thread and then over its quad.
//     Per stage of the product each warp loads its A fragments of x with
//     ldmatrix from the swizzled slice, forms y = ((x - mu) * rstd) * g[k] +
//     b[k] in f32 in the plain version's order (round-to-nearest
//     intrinsics, no contraction into FMAs), rounds it to bf16 and packs it,
//     and the warpgroup issues four wgmma m64n256k16 with A from those
//     registers and B (w, N-major: the transpose-B bit) from the stage
//     through a descriptor.  It waits for them before it hands the stage
//     back (keeping one group in flight measured no faster).
//   - Epilogue: the accumulator rounded to bf16 into the warpgroup's 32 KB
//     output buffer (four swizzled 64 x 64 boxes), then one thread stores it
//     by TMA and the warpgroup goes on with the next tile; the store must
//     have read the buffer before the next epilogue writes it.
//   - Ragged edges: the tensor maps fill zeros past M, K and N on loads and
//     drop what lies past M and N on the store; g and b read as 0 past K,
//     so y there is exactly 0 and nothing leaks into the product, and the
//     variance leaves those columns out.  TMA needs 16-byte strides and
//     bases: K % 8 == 0, N % 8 == 0 and 16-byte aligned x, w and out (the
//     wrapper checks; the C function refuses anything else).
//
// f32: the FMA kernel (ln_matmul_f32_kernel), exact f32 products (TF32 would
// break the f32 limit).  One CTA = one (64-row, 128-column) output tile, 256
// threads:
//   - prologue: the tile's 64 rows of x, the whole K of each, go to shared
//     memory (64 x K f32); one warp per row computes mu and rstd over that
//     copy and overwrites it with y, so x is read from device memory once
//     per CTA and y never goes there;
//   - main loop: 32-row slices of w stream through shared memory; each
//     thread accumulates a 4 x 8 register tile (rows ty + 16 i, columns
//     tx + 16 j), reading y and w from shared memory;
//   - CTAs of neighbouring column tiles share their x rows, and blockIdx.x
//     runs over the column tiles first, so the repeated reads of x hit L2;
//   - ragged edges are masked: rows past M are zero (their y is b, never
//     written), columns past N and the k slice past K load as zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper_tma_wgmma.cuh"

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- f32: FMA tiles ------------------------------------------------------

namespace f32 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 64;   // rows per CTA
constexpr int kBN = 128;  // columns per CTA
constexpr int kBK = 32;   // rows of w per streamed slice

size_t smem_bytes(int k) {
  return (kBM * static_cast<size_t>(k) + kBK * kBN) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
    ln_matmul_f32_kernel(const float* __restrict__ x,
                         const float* __restrict__ g,
                         const float* __restrict__ b,
                         const float* __restrict__ w, float* __restrict__ out,
                         int m, int k, int n, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ys = reinterpret_cast<float*>(smem_raw);  // (kBM, k), y after the prologue
  float* ws = ys + kBM * static_cast<size_t>(k);   // (kBK, kBN)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;

  // prologue: LN of the tile's rows, one warp per row
  for (int r = warp; r < kBM; r += kWarps) {
    const int row = m0 + r;
    float* yr = ys + static_cast<size_t>(r) * k;
    const float* xr = x + static_cast<size_t>(row) * k;
    float sum = 0.f;
    for (int c = lane; c < k; c += 32) {
      const float v = row < m ? xr[c] : 0.f;
      yr[c] = v;
      sum += v;
    }
    const float mu = warp_sum(sum) / static_cast<float>(k);
    float sq = 0.f;
    for (int c = lane; c < k; c += 32) {
      const float d = yr[c] - mu;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(k) + eps);
    for (int c = lane; c < k; c += 32) yr[c] = (yr[c] - mu) * rstd * g[c] + b[c];
  }

  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    __syncthreads();  // the prologue done, or the previous slice consumed
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int kk = e / kBN;
      const int cc = e - kk * kBN;
      ws[e] = k0 + kk < k && n0 + cc < n
                  ? w[static_cast<size_t>(k0 + kk) * n + n0 + cc]
                  : 0.f;
    }
    __syncthreads();
    const int kn = min(kBK, k - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float a[4], bw[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = ys[static_cast<size_t>(ty + 16 * i) * k + k0 + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) bw[j] = ws[kk * kBN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < n) out[static_cast<size_t>(row) * n + col] = acc[i][j];
    }
  }
}

cudaError_t launch(const float* x, const float* g, const float* b,
                   const float* w, float* out, int m, int k, int n, float eps,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      ln_matmul_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if ((m + kBM - 1) / kBM > 65535) return cudaErrorInvalidValue;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  ln_matmul_f32_kernel<<<grid, kThreads, smem, stream>>>(x, g, b, w, out, m,
                                                         k, n, eps);
  return cudaGetLastError();
}

}  // namespace f32

// ---- bf16: wgmma, TMA and mbarriers --------------------------------------

namespace tc {

constexpr int kBM = 128;  // rows per output tile: two warpgroups of 64
constexpr int kBN = 256;  // columns per output tile: one m64n256k16 per k16
constexpr int kBK = 64;   // depth of a stage: one 128-byte row of x
constexpr int kStages = 3;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer warpgroup
// registers a thread after setmaxnreg: 128 x 40 + 256 x 232 <= 65536
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr uint32_t kXBytes = kBM * kBK * 2;        // 16 KB
constexpr uint32_t kWBox = kBK * 64 * 2;           // 8 KB: 64 x 64 of w
constexpr uint32_t kStageBytes = kXBytes + (kBN / 64) * kWBox;  // 48 KB
// a consumer warpgroup's output tile (64 x 256 bf16) on its way to TMA, as
// four (64 x 64) boxes of 128-byte rows
constexpr uint32_t kOutBox = 64 * 128;
constexpr uint32_t kOutBytes = (kBN / 64) * kOutBox;  // 32 KB
constexpr size_t kSmem = kStages * kStageBytes + 2 * kOutBytes + 1024;  // + alignment
// the w stage's descriptor: 64-wide N blocks kWBox apart (LBO), 8-row K
// groups one swizzle atom (1024 bytes) apart (SBO)
constexpr uint32_t kLbo = kWBox;
constexpr uint32_t kSbo = 8 * 128;

__device__ __forceinline__ float ln_elem(float v, float mu, float rstd,
                                         float g, float b) {
  // the plain version's order, xc * rstd * g + b, each step rounded
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), rstd), g), b);
}

__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

__device__ __forceinline__ uint32_t ln_pair(uint32_t xv, float mu,
                                            float rstd, float2 g, float2 b) {
  const __nv_bfloat162 y =
      __floats2bfloat162_rn(ln_elem(lo_f(xv), mu, rstd, g.x, b.x),
                            ln_elem(hi_f(xv), mu, rstd, g.y, b.y));
  return *reinterpret_cast<const uint32_t*>(&y);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float2 load_f2(const float* p, int c, int k) {
  return c < k ? *reinterpret_cast<const float2*>(p + c) : make_float2(0.f, 0.f);
}

// The producer's loop (one thread): per row block, x's (128 x 64) boxes
// alone for the two sweeps of the statistics, then per (column tile,
// 64-deep slice of K) x's box and w's four (64 x 64) boxes, each into the
// next stage once it is free.
__device__ __forceinline__ void produce(const CUtensorMap* xmap,
                                        const CUtensorMap* wmap,
                                        unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, int row_blocks,
                                        int col_tiles, int slices) {
  int stage = 0;
  uint32_t phase = 0;
  for (int rb = blockIdx.x; rb < row_blocks; rb += gridDim.x) {
    // the statistics' two sweeps over the block's x: the mean, then the
    // centred variance
    for (int sweep = 0; sweep < 2; ++sweep)
      for (int s = 0; s < slices; ++s) {
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        hopper::mbar_arrive_expect_tx(&full[stage], kXBytes);
        hopper::tma_load_2d(smem + stage * kStageBytes, xmap, &full[stage],
                            s * kBK, rb * kBM);
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
    for (int ct = 0; ct < col_tiles; ++ct) {
      for (int s = 0; s < slices; ++s) {
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + stage * kStageBytes;
        hopper::mbar_arrive_expect_tx(&full[stage], kStageBytes);
        hopper::tma_load_2d(st, xmap, &full[stage], s * kBK, rb * kBM);
#pragma unroll
        for (int j = 0; j < kBN / 64; ++j)
          hopper::tma_load_2d(st + kXBytes + j * kWBox, wmap, &full[stage],
                              ct * kBN + j * 64, s * kBK);
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
    }
  }
}

// A consumer warp: warpgroup (warp >> 2) owns tile rows [64 (warp >> 2),
// + 64), the warp rows [tile_row, tile_row + 16).
__device__ __forceinline__ void consume(const CUtensorMap* omap,
                                        const float* __restrict__ g,
                                        const float* __restrict__ b, int k,
                                        float eps, unsigned char* smem,
                                        uint64_t* full, uint64_t* empty,
                                        int row_blocks, int col_tiles,
                                        int slices, int warp, int lane) {
  const int wg = warp >> 2;
  const int wg_thread = threadIdx.x & 127;
  const int tile_row = wg * 64 + (warp & 3) * 16;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int out_row = (warp & 3) * 16 + gq;  // in the warpgroup's 64 rows
  unsigned char* obuf = smem + kStages * kStageBytes + wg * kOutBytes;
  // ldmatrix.x4: lane l addresses row (l & 7) + 8 (i & 1) of matrix
  // i = l >> 3, whose 16-byte chunk in a k16 step is i >> 1
  const int ld_row = tile_row + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int ld_chunk = lane >> 4;
  int stage = 0;
  uint32_t phase = 0;
  float acc[128];
  for (int rb = blockIdx.x; rb < row_blocks; rb += gridDim.x) {
    // the lane's fragment rows (tile_row + gq, + 8): mu over the first
    // sweep, the centred variance over the second (columns past K, zeros
    // from the tensor map, left out), each summed per lane, then per quad
    float mu[2] = {0.f, 0.f}, rstd[2] = {0.f, 0.f};
    for (int sweep = 0; sweep < 2; ++sweep) {
      float sum[2] = {0.f, 0.f};
      for (int s = 0; s < slices; ++s) {
        hopper::mbar_wait(&full[stage], phase);
        const uint32_t xs = hopper::smem_addr(smem + stage * kStageBytes);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t v[4];
          hopper::ldmatrix_x4(
              v, xs + hopper::swizzle128(ld_row, 2 * kk + ld_chunk));
          const int c = s * kBK + kk * 16 + 2 * t;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = i & 1;
            if (sweep == 0) {
              sum[r] += lo_f(v[i]) + hi_f(v[i]);
            } else if (c + 8 * (i >> 1) < k) {
              const float d0 = lo_f(v[i]) - mu[r], d1 = hi_f(v[i]) - mu[r];
              sum[r] += d0 * d0 + d1 * d1;
            }
          }
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[stage]);
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mean = quad_sum(sum[r]) / static_cast<float>(k);
        if (sweep == 0)
          mu[r] = mean;
        else
          rstd[r] = rsqrtf(mean + eps);
      }
    }
    for (int ct = 0; ct < col_tiles; ++ct) {
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int s = 0; s < slices; ++s) {
        hopper::mbar_wait(&full[stage], phase);
        const uint32_t xs = hopper::smem_addr(smem + stage * kStageBytes);
        const uint32_t ws = xs + kXBytes;
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t v[4];
          hopper::ldmatrix_x4(
              v, xs + hopper::swizzle128(ld_row, 2 * kk + ld_chunk));
          const int c = s * kBK + kk * 16 + 2 * t;
          const float2 g0 = load_f2(g, c, k), g1 = load_f2(g, c + 8, k);
          const float2 b0 = load_f2(b, c, k), b1 = load_f2(b, c + 8, k);
          a[kk][0] = ln_pair(v[0], mu[0], rstd[0], g0, b0);
          a[kk][1] = ln_pair(v[1], mu[1], rstd[1], g0, b0);
          a[kk][2] = ln_pair(v[2], mu[0], rstd[0], g1, b1);
          a[kk][3] = ln_pair(v[3], mu[1], rstd[1], g1, b1);
        }
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_m64n256k16_rs(
              acc, a[kk], hopper::desc_b128(ws + kk * 16 * 128, kLbo, kSbo));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_acc(acc);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[stage]);
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
      // epilogue: the accumulator rounded to bf16 into the warpgroup's
      // swizzled output boxes (conflict-free: the eight rows of a store
      // land in eight 16-byte chunks), then one thread stores the boxes by
      // TMA, which drops what lies past M and N
      if (wg_thread == 0) hopper::bulk_wait_read<0>();  // the buffer is free
      hopper::named_barrier_sync(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        unsigned char* p = obuf + (j >> 3) * kOutBox +
                           hopper::swizzle128(out_row, j & 7) + 4 * t;
        const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
        *reinterpret_cast<__nv_bfloat162*>(p) = lo;
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * 128) = hi;  // row + 8
      }
      hopper::fence_proxy_async();
      hopper::named_barrier_sync(1 + wg, 128);
      if (wg_thread == 0) {
#pragma unroll
        for (int jb = 0; jb < kBN / 64; ++jb)
          hopper::tma_store_2d(omap, obuf + jb * kOutBox, ct * kBN + jb * 64,
                               rb * kBM + wg * 64);
        hopper::bulk_commit();
      }
    }
  }
  if (wg_thread == 0) hopper::bulk_wait_all();
}

__global__ void __launch_bounds__(kThreads, 1) ln_matmul_bf16_tc_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap omap, const float* __restrict__ g,
    const float* __restrict__ b, int m, int k, int n, float eps) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int row_blocks = (m + kBM - 1) / kBM;
  const int col_tiles = (n + kBN - 1) / kBN;
  const int slices = (k + kBK - 1) / kBK;
  if (warp >= kConsumerWarps) {  // the producer warpgroup
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0)
      produce(&xmap, &wmap, smem, full, empty, row_blocks, col_tiles, slices);
  } else {
    hopper::setmaxnreg_inc<kConsumerRegs>();
    consume(&omap, g, b, k, eps, smem, full, empty, row_blocks, col_tiles,
            slices, warp, lane);
  }
}

cudaError_t launch(const void* x, const float* g, const float* b,
                   const void* w, void* out, int m, int k, int n, float eps,
                   cudaStream_t stream) {
  const auto aligned = [](const void* p, uintptr_t to) {
    return reinterpret_cast<uintptr_t>(p) % to == 0;
  };
  if (k % 8 != 0 || n % 8 != 0 || !aligned(x, 16) || !aligned(w, 16) ||
      !aligned(g, 8) || !aligned(b, 8) || !aligned(out, 16))
    return cudaErrorInvalidValue;
  CUtensorMap xmap, wmap, omap;
  cudaError_t err = hopper::tensor_map_2d(&xmap, x, m, k, kBM);
  if (err == cudaSuccess) err = hopper::tensor_map_2d(&wmap, w, k, n, kBK);
  if (err == cudaSuccess) err = hopper::tensor_map_2d(&omap, out, m, n, 64);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ln_matmul_bf16_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const int row_blocks = (m + kBM - 1) / kBM;
  const int grid = row_blocks < sms ? row_blocks : sms;
  ln_matmul_bf16_tc_kernel<<<grid, kThreads, kSmem, stream>>>(
      xmap, wmap, omap, g, b, m, k, n, eps);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Dynamic shared memory a CTA of the f32 kernel needs at depth k: the
// wrapper refuses a k whose tile does not fit.  The bf16 kernel's is fixed
// (three stages and two output buffers) and takes any k.
extern "C" long long tpat_ln_matmul_smem(int k) {
  return static_cast<long long>(f32::smem_bytes(k));
}

// dtype: 0 = float32, 1 = bfloat16 (x, w and out).  x: (m, k), w: (k, n),
// out: (m, n), all contiguous; g, b: (k,) f32.  bf16 needs k % 8 == 0,
// n % 8 == 0 and 16-byte aligned x, w and out.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int tpat_ln_matmul(const void* x, const float* g, const float* b,
                              const void* w, void* out, int m, int k, int n,
                              int dtype, float eps, void* stream) {
  if (m < 1 || k < 1 || n < 1) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return f32::launch(static_cast<const float*>(x), g, b,
                       static_cast<const float*>(w), static_cast<float*>(out),
                       m, k, n, eps, s);
  if (dtype == 1) return tc::launch(x, g, b, w, out, m, k, n, eps, s);
  return cudaErrorInvalidValue;
}
