// Warp-level tensor-core building blocks shared by the bf16 paths of
// flash_attention.cu and ssd_scan.cu (sm_90a).
//
// mma_bf16 issues mma.sync.m16n8k16 with bf16 operands and float32
// accumulation.  Per lane (g = lane / 4, t = lane % 4) the fragments hold:
//   A (16 x 16, row major), 4 regs of 2 bf16:
//     a0 (row g, cols 2t, 2t+1)   a1 (row g+8, cols 2t, 2t+1)
//     a2 (row g, cols 2t+8, +9)   a3 (row g+8, cols 2t+8, +9)
//   B (16 x 8, k by n), 2 regs: b0 (k 2t, 2t+1; col g)  b1 (k 2t+8, +9; col g)
//   C (16 x 8 float32): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// ldmatrix x4 loads four 8 x 8 bf16 matrices from shared memory; lanes
// 8q .. 8q+7 give the row addresses of matrix q, and lane i receives row
// i / 4, cols 2(i % 4), +1 of each (with .trans: rows 2(i % 4), +1 of
// col i / 4).  The callers' address maps are written beside each call.
//
// split_bf16 rounds a float32 pair to bf16 twice: hi = bf16(x) and
// lo = bf16(x - hi).  hi + lo carries x to ~2^-17 of its size, so two
// products against one exact bf16 operand give float32-class results;
// one bf16 rounding of x would miss the port's kernel-against-plain bars
// (../flash_attention.py and ../ssd_scan.py, _split_bf16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !pred (the
// source is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n groups of this thread are still in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a * b  (16 x 16 by 16 x 8, bf16 in, float32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 in one register, x0 in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 x0,
                                              __nv_bfloat16 x1) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x0)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(x1)) << 16);
}

// hi = bf16(x0, x1) and lo = bf16(x - hi), each packed as one register
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                 __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}

}  // namespace mma
