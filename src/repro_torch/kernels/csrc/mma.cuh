// Warp-level tensor-core and asynchronous-copy primitives for sm_90a,
// shared by the bf16 static prefill attention (mma_attention.cuh) and the
// W4A16 matmul (gptq_matmul.cu).
//
// The product is mma.sync.m16n8k16 (bf16 x bf16 -> f32).  Fragment
// layouts, with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major), 4 x b32:  a0 (row g,     cols 2t, 2t+1)
//                                     a1 (row g + 8, cols 2t, 2t+1)
//                                     a2 (row g,     cols 2t+8, 2t+9)
//                                     a3 (row g + 8, cols 2t+8, 2t+9)
//   B (16 x 8, k x n), 2 x b32:       b0 (k 2t, 2t+1,   col g)
//                                     b1 (k 2t+8, 2t+9, col g)
//   C (16 x 8, f32), 4 floats:        c0, c1 (row g,     cols 2t, 2t+1)
//                                     c2, c3 (row g + 8, cols 2t, 2t+1)
// Each b32 holds two bf16, the lower index in the low half.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses registers; with valid false
// nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// The same for 4 bytes (rows whose stride is not a multiple of 16 bytes).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8i .. 8i + 7 give the
// row addresses of matrix i, and register i receives matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way (k-major rows -> B frags).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a @ b on one 16 x 8 x 16 tile.
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats rounded (nearest even) to bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace rt
