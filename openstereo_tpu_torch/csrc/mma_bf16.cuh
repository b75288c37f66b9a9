// Warp-level bf16 tensor-core helpers for Hopper (sm_90a), shared by the
// kernels of this directory: one `mma.sync.aligned.m16n8k16` (bf16 operands,
// f32 accumulators), the 32-bit register packing its fragments use, their
// loads from shared memory (`ldmatrix`, plain and transposed), and `cp.async`
// copies from global to shared memory.
//
// Fragment layout, lane = 4*g + t (g = lane / 4, t = lane % 4), two bf16 per
// register, the lower index in the low half:
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                           a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8, k x n):      b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C (16 x 8, f32):        c0, c1 = C[g][2t], C[g][2t+1];  c2, c3 = C[g+8][2t], C[g+8][2t+1]
// So an A or B fragment is two consecutive bf16 along k, read as one 32-bit
// word from a shared-memory tile that is stored k-contiguous.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace mma {

// d += a * b on one 16 x 8 x 16 tile
__device__ __forceinline__ void bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two consecutive bf16 of shared memory (4-byte aligned) as one register
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// round two floats to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragment of rows [r0, r0+16), k columns [k0, k0+16) of a row-major
// bf16 tile with row stride ld (elements)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                       int r0, int k0, int g, int t) {
  const __nv_bfloat16* p = tile + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// ldmatrix: lane L gives the address of row L % 8 of 8 x 8 matrix L / 8 (16 bytes,
// 16-byte aligned); register i receives matrix i's row lane / 4, columns
// 2 (lane % 4), +1: a fragment as laid out above
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// the same with each 8 x 8 matrix transposed: register i receives matrix i's
// rows 2 (lane % 4), +1 at column lane / 4 (a B fragment of a tile stored [k][n])
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// 16 bytes from global to shared memory without passing through registers
// (cp.async, L2 only); zeros where !valid
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

// the A fragment of rows [r0, r0+16), k columns [k0, k0+16) by one ldmatrix.x4
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                       int r0, int k0, int lane) {
  ldsm_x4(a, tile + (r0 + lane % 8 + 8 * (lane / 8 % 2)) * ld + k0 + 8 * (lane / 16));
}

// B fragments {b0, b1} of the two n8 tiles at rows [n0, n0+16) of a tile stored
// [n][k] (k-contiguous), k columns [k0, k0+16): b[0], b[1] for rows n0..n0+7,
// b[2], b[3] for rows n0+8..n0+15
__device__ __forceinline__ void ldsm_b2(uint32_t (&b)[4], const __nv_bfloat16* tile, int ld,
                                        int n0, int k0, int lane) {
  ldsm_x4(b, tile + (n0 + lane % 8 + 8 * (lane / 16)) * ld + k0 + 8 * (lane / 8 % 2));
}

// B fragments {b0, b1} of the two n8 tiles at columns [n0, n0+16) of a tile
// stored [k][n] (n-contiguous), k rows [k0, k0+16): b[0], b[1] for columns
// n0..n0+7, b[2], b[3] for n0+8..n0+15
__device__ __forceinline__ void ldsm_bt2(uint32_t (&b)[4], const __nv_bfloat16* tile, int ld,
                                         int k0, int n0, int lane) {
  ldsm_x4_trans(b, tile + (k0 + lane % 8 + 8 * (lane / 8 % 2)) * ld + n0 + 8 * (lane / 16));
}
__device__ __forceinline__ void ldsm_bt1(uint32_t (&b)[2], const __nv_bfloat16* tile, int ld,
                                         int k0, int n0, int lane) {
  ldsm_x2_trans(b, tile + (k0 + lane % 8 + 8 * (lane / 8 % 2)) * ld + n0);
}

}  // namespace mma
