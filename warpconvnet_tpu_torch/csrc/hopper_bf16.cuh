// bf16 device helpers of the segment-attention kernels (K9's bf16 forward
// in segment_attention.cu, K9-dkv and K9-dq in segment_attention_bwd_bf16.cu):
// cp.async copies, the visited-tile walk, bf16 packing, and Hopper's wgmma
// with the swizzled shared-memory tiles it reads.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace wct::hopper {

using bf16 = __nv_bfloat16;

// One [ROWS][D] bf16 tile in shared memory (ROWS 64: wgmma's M, and the N
// of a 64 x 64 product): row-major within column blocks
// of ROWB bytes a row (one block for D <= 64, two for D = 128), each block
// swizzled as wgmma reads it: bits 4-6 (4-5, 4) of a byte offset XOR bits
// 7-9 (7-8, 7) for the 128 (64, 32) byte swizzle. Tile bases are
// 1024-byte aligned, the swizzles' period.
template <int D>
struct Tile {
  static constexpr int ROWS = 64;
  static constexpr uint32_t ROWB = D * 2 < 128 ? D * 2 : 128;
  static constexpr uint32_t BLOCK = ROWS * ROWB;  // bytes of one column block
  static constexpr uint32_t BYTES = ROWS * D * 2;
  static constexpr uint64_t MODE = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;  // descriptor swizzle

  // Byte offset of the 16-byte chunk c (elements 8c .. 8c + 7) of row r.
  __device__ static uint32_t chunk(int r, int c) {
    constexpr int PER = ROWB / 16;  // chunks of a row in one block
    const uint32_t o = (c / PER) * BLOCK + r * ROWB + (c % PER) * 16;
    return o ^ ((o >> 3) & (ROWB - 16));
  }

  // Shared-memory matrix descriptor: start address, leading and stride
  // byte offsets (the stride: 8 rows of the swizzle atom), swizzle mode.
  __device__ static uint64_t desc(uint32_t addr, uint32_t lbo) {
    return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
           (uint64_t((8 * ROWB) >> 4) << 32) | (MODE << 62);
  }

  // The tile at `base` as a K-major operand (rows are M or N), k-step ks:
  // elements [16 ks, 16 ks + 16) of every row.
  __device__ static uint64_t k_major(uint32_t base, int ks) {
    constexpr int PER = ROWB / 2;  // elements of a row in one block
    return desc(base + (ks * 16 / PER) * BLOCK + (ks * 16 % PER) * 2, 16);
  }

  // The tile at `base` as an MN-major B operand: rows [16 kk, 16 kk + 16)
  // are K, the 64 (or D) columns of column block cb are N. One swizzle atom
  // spans N, so the leading offset is unused; it repeats the stride.
  __device__ static uint64_t mn_major(uint32_t base, int kk, int cb) {
    return desc(base + cb * BLOCK + kk * 16 * ROWB, 8 * ROWB);
  }
};

// 16 bytes global -> shared (a shared-memory address, or a pointer into
// shared memory) without passing through registers; zeros when !valid (src
// is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const bf16* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
  cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(dst)), src, valid);
}

// 4 bytes global -> shared; zeros when !valid (src is then not read).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(addr), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulators across
// the wgmma fence, issue and wait.
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define WG_OUT8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] (+)= A B over one 16-deep k-step, fp32 sums; A and B K-major
// in shared memory (descriptors a, b). acc == 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT8(0), WG_OUT8(8), WG_OUT8(16), WG_OUT8(24)
      : "l"(a), "l"(b), "r"(acc));
}

// d[64 x N] += A B over one k-step: A [64 x 16] from registers (bf16
// fragments, the mma.m16n8k16 A layout per warp), B MN-major in shared
// memory. N = 16, 32 or 64 by the size of d.
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : WG_OUT8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : WG_OUT8(0), WG_OUT8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT8(0), WG_OUT8(8), WG_OUT8(16), WG_OUT8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_OUT8

// 2^x, flushing results below 2^-126 to 0 (one MUFU instruction; exp2f
// adds a subnormal path).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The first visited tile after `after` (-1: the first) in a bitmask of
// nwords words, or -1.
__device__ __forceinline__ int next_tile(const unsigned* bits, int nwords, int after) {
  const int t = after + 1;
  int w = t >> 5;
  if (w >= nwords) return -1;
  unsigned word = bits[w] & (~0u << (t & 31));
  while (word == 0u) {
    if (++w >= nwords) return -1;
    word = bits[w];
  }
  return w * 32 + __ffs(word) - 1;
}

}  // namespace wct::hopper
