// Hopper building blocks shared by the port's tensor-core kernels (K2 in
// gn_conv.cu, K5 in flash_attn.cu): asynchronous 16- and 4-byte copies into
// shared memory, ldmatrix fragments, and warpgroup matrix multiply (wgmma)
// with A from registers and B from shared memory through a descriptor.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tempo {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES (16 or 4) from global to shared memory, asynchronously; when not
// live nothing is read and the destination is filled with zeros.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool live) {
  const int n = live ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory: lanes 8i .. 8i+7 give the
// row addresses of matrix i, and r[i] comes back as the mma fragment of
// matrix i (lane (g, c) holds row g, columns 2c and 2c + 1).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// The same with every matrix transposed on the way (lane (g, c) holds
// column g, rows 2c and 2c + 1 of the stored matrix).
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// A lane's element offset into a row-major tile (row stride LD) for the two
// ldmatrix.x4 address patterns:
// - lane_rc: matrices (rows 0-7, cols 0-7), (rows 8-15, cols 0-7), (rows
//   0-7, cols 8-15), (rows 8-15, cols 8-15) of a 16 x 16 block. Plain, it is
//   the A operand of rows r0.. over columns k0..; transposed (ldsm4_t), the
//   B operands (b0, b1) of two adjacent 8-column blocks n0.., n0+8.. over
//   the 16 rows k0.. of an operand read down its rows (do and q in K5dkv's
//   second products).
// - lane_cr: matrices (rows 0-7, cols 0-7), (rows 0-7, cols 8-15), (rows
//   8-15, cols 0-7), (rows 8-15, cols 8-15): plain, the B operands (b0, b1)
//   of the 8-row blocks n0.., n0+8.. over columns k0.. of an operand read
//   along its rows (B[kk][nn] = y[n0 + nn][k0 + kk]: q in k.q^T, do in
//   v.do^T).
template <int LD>
__device__ __forceinline__ int lane_rc(int lane) {
  return (lane & 15) * LD + ((lane >> 4) << 3);
}
template <int LD>
__device__ __forceinline__ int lane_cr(int lane) {
  return ((lane & 7) + ((lane >> 4) << 3)) * LD + (((lane >> 3) & 1) << 3);
}

// The 128-byte swizzle wgmma's descriptor mode 1 names: the 16-byte chunk
// index of a byte offset is XORed with the offset's bits 7..9 (the row
// within an 8-row, 1024-byte group of 128-byte rows).
__device__ __forceinline__ int swizzle128(int off) {
  return off ^ (((off >> 7) & 7) << 4);
}

// Warpgroup matrix multiply: 4 warps start one asynchronous m64nNk16 product,
// A (16 rows a warp, mma.sync's A fragment) from registers, B from shared
// memory through a 64-bit descriptor, the sum in registers in mma.sync's
// accumulator layout (warp w holds rows 16w .. 16w + 15).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins an accumulator between an asynchronous product and its first use:
// the compiler may not move arithmetic on it above the wait.
__device__ __forceinline__ void pin(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
// Makes writes through the generic proxy (cp.async, st.shared) visible to
// wgmma's reads of shared memory (the async proxy).
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory descriptor of a swizzled operand: start address, leading
// and stride byte offsets (each >> 4), swizzle mode (1: 128 bytes, 2: 64).
// For an n-major B with 128-byte swizzle, the leading offset is the step
// between 64-column panels and the stride offset the step between 8-row
// groups of k.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, int lbo, int sbo,
                                            int mode) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)mode << 62);
}

// d (+)= a . b, m64n128k16 (K2's 128-column tiles). TB = 0: b is stored
// with k contiguous; TB = 1: with n contiguous. acc = 0 overwrites d.
template <int TB>
__device__ __forceinline__ void wgmma(float (&d)[16][4],
                                      const uint32_t (&a)[4], uint64_t b,
                                      int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,"
      "%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "{%64,%65,%66,%67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
        "n"(TB));
}

// The same with n = 64 (K5f's score and output tiles, K2's 64-column tiles).
template <int TB>
__device__ __forceinline__ void wgmma(float (&d)[8][4],
                                      const uint32_t (&a)[4], uint64_t b,
                                      int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
        "n"(TB));
}

// The same with n = 32 (K5f's output at hd 32).
template <int TB>
__device__ __forceinline__ void wgmma(float (&d)[4][4],
                                      const uint32_t (&a)[4], uint64_t b,
                                      int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
        "n"(TB));
}

}  // namespace tempo
