// Hopper pieces of the bf16 LayerNorm-matmul kernel (ln_matmul.cu, probe
// P3): mbarriers, TMA tile loads and stores through tensor maps with the
// 128-byte swizzle, named barriers, setmaxnreg, and wgmma
// m64n256k16 with A from registers and B from shared memory through a
// matrix descriptor.  sm_90a only.
//
// The 128-byte swizzle (CU_TENSOR_MAP_SWIZZLE_128B): a TMA box whose rows
// are 128 bytes (64 bf16) lands row r at byte 128 r of the (1024-byte
// aligned) tile, with its 16-byte chunk c at chunk position c ^ (r % 8).
// `swizzle128` is that map; ldmatrix addresses go through it.
//
// wgmma with B "MN-major" (imm-trans-b = 1: B's N is the contiguous axis,
// as in a row-major (K, N) matrix): B is read from boxes of 8 K-rows x 64 N
// values (1024 bytes, one swizzle atom per 8 rows); the descriptor's
// leading byte offset (LBO) is the step from one 64-wide N block to the
// next, the stride byte offset (SBO) the step from one 8-row K group to the
// next, the layout type bits (62-63) 1 for the 128-byte swizzle.
//
// Register fragments (PTX ISA, wgmma .m64nNk16, per warp w of the
// warpgroup, rows 16 w .. 16 w + 15, lane = 4 g + t):
//   A: a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 8+2t..), a3 = (g+8,
//      8+2t..), two bf16 per register, low half first (mma.m16n8k16's A);
//   D (f32): d[4j], d[4j+1] = (g, 8j+2t..8j+2t+1), d[4j+2], d[4j+3] = (g+8,
//      8j+2t..), j over the N / 8 column blocks.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `chunk` (0-7) of row `row` in a tile of
// 128-byte rows written by TMA under CU_TENSOR_MAP_SWIZZLE_128B.
__host__ __device__ constexpr uint32_t swizzle128(uint32_t row,
                                                  uint32_t chunk) {
  return row * 128u + ((chunk ^ (row & 7u)) << 4);
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also expects `bytes` of TMA traffic before the phase
// completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---- TMA -----------------------------------------------------------------

// The box of `map` at (c0 along the contiguous axis, c1) into `dst`; its
// bytes (the whole box, out-of-bounds zeros included) complete on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The box of `map` at (c0, c1) from `src`, as one bulk group of this
// thread; the elements outside the tensor are not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's bulk groups still read
// their shared memory (the buffer may then be written again).
template <int pending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(pending)
               : "memory");
}

// Wait until this thread's bulk groups have completed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (a TMA store that reads them).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links without -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a row-major bf16 (rows, cols) matrix at `base` (16-byte
// aligned, cols % 8 == 0) in boxes of (box_rows, 64) values: 128-byte rows,
// the 128-byte swizzle, zeros outside the matrix.  Returns the CUDA error
// (cudaErrorSymbolNotFound without the driver's encoder).
inline cudaError_t tensor_map_2d(CUtensorMap* map, const void* base,
                                 uint64_t rows, uint64_t cols,
                                 uint32_t box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- register rebalancing ------------------------------------------------

// A warpgroup gives registers back to the pool (a TMA producer) or takes
// them (wgmma consumers); every warp of the warpgroup executes it, on
// paths that never rejoin.
template <int regs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(regs));
}

template <int regs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(regs));
}

// ---- ldmatrix and wgmma --------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The descriptor of a 128-byte-swizzled operand at shared address `addr`
// (1024-byte aligned, so the base offset field stays 0).
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Orders the registers and shared memory written before it ahead of the
// wgmmas after it (A fragments, accumulators).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most `pending` committed wgmma groups are in flight.
template <int pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(pending)
               : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across a
// wgmma wait: the registers are written asynchronously.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TPAT_ACC8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 256, f32) += A (64 x 16, bf16, registers) . B (16 x 256, bf16,
// shared memory, MN-major through desc_b); scale-d (the predicate p) is 1:
// the accumulators are zeroed by the caller.
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128],
                                                    const uint32_t a[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : TPAT_ACC8(0), TPAT_ACC8(8), TPAT_ACC8(16), TPAT_ACC8(24),
        TPAT_ACC8(32), TPAT_ACC8(40), TPAT_ACC8(48), TPAT_ACC8(56),
        TPAT_ACC8(64), TPAT_ACC8(72), TPAT_ACC8(80), TPAT_ACC8(88),
        TPAT_ACC8(96), TPAT_ACC8(104), TPAT_ACC8(112), TPAT_ACC8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef TPAT_ACC8

}  // namespace hopper
