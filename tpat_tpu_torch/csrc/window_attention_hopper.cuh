// What the two Hopper window-attention sources share, bf16, head_dim 32:
// window_attention_banded.cu (the banded form, 128-token chunks) and
// window_attention_dense.cu (the dense form, a grid of up to 256 tokens).
//   - A sample's q, k, v (and dO) as TMA boxes of one head's 32 values x
//     `rows` rows out of the packed (B, N, 3C) input (and the (B, N, C)
//     cotangent), through 3-D tensor maps with the 64-byte swizzle, into a
//     stage completed on an mbarrier (load_boxes; the wait is
//     hopper::mbar_wait).
//   - The live map's rule on warp ballots over a template's rows: key block
//     kb of a query block is live when one of its 16 x 16 entries is above
//     kDead, or when one of the query block's rows has no such entry at all
//     (its p is uniform over the row's window, so the block is kept whole).
//   - The integer ticket that finds the last CTA of a sum taken across
//     CTAs, which then sums the partials in a fixed order (no floating-point
//     atomics) and puts the ticket back to 0.
// sm_90a only.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_wgmma.cuh"
#include "hopper_tma_wgmma.cuh"
#include "window_attention_common.cuh"
#include "window_attention_tc.cuh"

namespace window_attention {

constexpr int kHeadDim = 32;  // the MAE decoder's 512 / 16
constexpr uint32_t kRowBytes = kHeadDim * 2;  // one head's row of a box

// The tensor map of a bf16 (batch, n, cols) tensor at `base` (16-byte
// aligned, cols % 8 == 0) in boxes of one head's 32 columns x `box_rows`
// rows (at most 256) of one sample, with the 64-byte swizzle; rows past n
// read as zeros and never reach into the next sample.
inline cudaError_t head_box_map(CUtensorMap* map, const void* base,
                                uint64_t batch, uint64_t n, uint64_t cols,
                                uint32_t box_rows) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {cols, n, batch};
  const cuuint64_t strides[2] = {cols * sizeof(__nv_bfloat16),
                                 n * cols * sizeof(__nv_bfloat16)};
  const cuuint32_t box[3] = {kHeadDim, box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Byte offset of 16-byte chunk c of row r in a box written by TMA under
// CU_TENSOR_MAP_SWIZZLE_64B (64-byte rows, the box 512-byte aligned): eight
// consecutive rows of one chunk sit in eight bank groups.
__device__ __forceinline__ uint32_t swizzle64(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// The dynamic shared memory's first 1024-byte boundary (TMA boxes under a
// swizzle want their atom's alignment).
__device__ __forceinline__ unsigned char* aligned_1024(
    unsigned char* smem_raw) {
  const uint32_t raw = hopper::smem_addr(smem_raw);
  return smem_raw + (((raw + 1023u) & ~1023u) - raw);
}

// Sample b's q, k and v boxes of head h (rows row0 .. row0 + box rows, c =
// num_heads * 32 the width of a section) at stage + 0, 1, 2 box_bytes, and
// with do_map its dO box at stage + 3 box_bytes, completing on `bar`.  One
// thread.
__device__ __forceinline__ void load_boxes(unsigned char* stage,
                                           const CUtensorMap* qkv_map,
                                           const CUtensorMap* do_map,
                                           uint64_t* bar, uint32_t box_bytes,
                                           int b, int row0, int h, int c) {
  hopper::mbar_arrive_expect_tx(bar, (do_map ? 4 : 3) * box_bytes);
#pragma unroll
  for (int t = 0; t < 3; ++t)
    wgmma::tma_load_3d(stage + t * box_bytes, qkv_map, bar,
                       t * c + h * kHeadDim, row0, b);
  if (do_map)
    wgmma::tma_load_3d(stage + 3 * box_bytes, do_map, bar, h * kHeadDim,
                       row0, b);
}

// One template row's ballot over a 128-column span: lane l holds columns
// 4l .. 4l + 3 of it, so key block kb of the span is lanes 4kb .. 4kb + 3.
__device__ __forceinline__ unsigned row_ballot(const float4& t) {
  return __ballot_sync(kFull, t.x > kDead || t.y > kDead || t.z > kDead ||
                                  t.w > kDead);
}

// The span's 8 key blocks as bits from the OR of its rows' ballots.
__device__ __forceinline__ unsigned span_blocks(unsigned any) {
  unsigned bits = 0;
#pragma unroll
  for (int kb = 0; kb < 8; ++kb)
    if (((any >> (4 * kb)) & 0xfu) != 0) bits |= 1u << kb;
  return bits;
}

// After the CTA's partials are written (every thread): whether this CTA is
// the last of `count` on `ticket`; the last puts the ticket back to 0.
// `flag` is an int of shared memory.  count == 1 takes no ticket.
__device__ __forceinline__ bool last_cta(int* ticket, int count, int* flag) {
  __threadfence();  // the partials before the ticket
  __syncthreads();
  if (threadIdx.x == 0)
    *flag = count == 1 || atomicAdd(ticket, 1) == count - 1;
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  if (threadIdx.x == 0 && count > 1) *ticket = 0;
  return true;
}

}  // namespace window_attention
