// Tensor-core and async-copy building blocks for Hopper (sm_90a), shared by
// the kernels of csrc/: 16-byte cp.async into shared memory, ldmatrix,
// mma.sync.m16n8k16 with bf16 operands and f32 accumulation, the split of an
// f32 pair into a bf16 high part and a bf16 low part, so a product with f32
// operands keeps about 16 bits of them on the tensor cores (two products),
// and the widening of int8 values to bf16 (exact).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16): lane = 4 g + t;
// A (16x16, row): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..);
// B (16x8, col):  b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
// C (16x8):       c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tcore {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; nothing is read and zeros land when !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(src));
}
// 4 bytes global -> shared; nothing is read and zeros land when !in
__device__ __forceinline__ void cp_async4z(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}
// keeps the compiler from moving shared-memory loads and stores across this
// point: a thread that reads its own cp.async pieces without a barrier, and
// then copies new ones over them, fences both sides
__device__ __forceinline__ void compiler_fence() { asm volatile("" ::: "memory"); }

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a b: a 16x16 (row), b 16x8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) rounded to bf16, returned packed; their remainders, rounded to
// bf16 too, go to lo: hi + lo holds about 16 bits of each
__device__ __forceinline__ uint32_t split_bf16(float x, float y, uint32_t& lo) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(hi);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
  return bits(hi);
}

// the int8 value x of one byte of w, where w holds the bytes x ^ 0x80 = x +
// 128 (sel 0x7540 .. 0x7543 picks byte 0 .. 3): that byte in the mantissa of
// 2^23 gives the float 2^23 + x + 128, exactly, on the full-rate ALUs
__device__ __forceinline__ float byte_to_f32(uint32_t w, uint32_t sel) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, sel)) - 8388736.f;
}

// the four int8 values of w as two packed bf16 pairs (exact): an integer of
// at most 8 significant bits is its float32's upper 16 bits
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  lo = __byte_perm(__float_as_uint(byte_to_f32(u, 0x7540)),
                   __float_as_uint(byte_to_f32(u, 0x7541)), 0x7632);
  hi = __byte_perm(__float_as_uint(byte_to_f32(u, 0x7542)),
                   __float_as_uint(byte_to_f32(u, 0x7543)), 0x7632);
}

}  // namespace tcore
