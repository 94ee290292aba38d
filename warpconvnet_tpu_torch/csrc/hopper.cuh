// Hopper device helpers of the segment-attention kernels (K9 in
// segment_attention_fwd_{tf32,bf16}.cu, K9-dkv and K9-dq in
// segment_attention_bwd_{tf32,bf16}.cu): cp.async and bulk copies, the
// visited-tile walk, mbarriers and named barriers, 16-byte loads and stores,
// register reallocation, bf16 packing and TF32 splitting, and Hopper's wgmma
// (bf16 and tf32) with the swizzled shared-memory tiles it reads.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace wct::hopper {

using bf16 = __nv_bfloat16;

// One [R][COLS] tile of ELEM-byte elements (bf16 2, tf32 4) in shared
// memory (R 64: wgmma's M, and the N of a 64 x 64 product): row-major
// within column blocks of ROWB bytes a row (one block for rows of up to
// 128 bytes, more for wider ones), each block swizzled as wgmma reads it:
// bits 4-6 (4-5, 4) of a byte offset XOR bits 7-9 (7-8, 7) for the 128
// (64, 32) byte swizzle. Tile bases are 1024-byte aligned, the swizzles'
// period.
template <int COLS, int ELEM = 2, int R = 64>
struct Tile {
  static constexpr int ROWS = R;
  static constexpr uint32_t ROWB = COLS * ELEM < 128 ? COLS * ELEM : 128;
  static constexpr uint32_t BLOCK = ROWS * ROWB;  // bytes of one column block
  static constexpr uint32_t BYTES = ROWS * COLS * ELEM;
  static constexpr uint64_t MODE = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;  // descriptor swizzle

  // Byte offset of the 16-byte chunk c (bytes 16c .. 16c + 15) of row r.
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
  // bytes [32 ks, 32 ks + 32) of every row (16 bf16 or 8 tf32 values).
  __device__ static uint64_t k_major(uint32_t base, int ks) {
    return desc(base + (ks * 32 / ROWB) * BLOCK + (ks * 32 % ROWB), 16);
  }

  // The bf16 tile at `base` as an MN-major B operand: rows
  // [16 kk, 16 kk + 16) are K, the 64 (or COLS) columns of column block cb
  // are N. One swizzle atom spans N, so the leading offset is unused; it
  // repeats the stride. (tf32 takes K-major operands only.)
  __device__ static uint64_t mn_major(uint32_t base, int kk, int cb) {
    static_assert(ELEM == 2, "MN-major operands are bf16 only");
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

// An mbarrier in shared memory (its address): init with the arrivals a
// phase takes; arrive (release); wait until the phase of the given parity
// has completed (acquire).
__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// One arrival on the mbarrier once this thread's earlier cp.async copies
// have landed (counted among the phase's arrivals).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

// mbarrier: this thread's arrival, announcing `bytes` of transactions.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// `bytes` (a multiple of 16) global -> shared by the copy engine in one
// request (a TMA bulk copy, no tensor map), completing as transactions on
// the mbarrier.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Makes initialised mbarriers visible to the copy engine.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// d[64 x 64] += A B over one k-step: A [64 x 16] from registers (bf16
// fragments, the mma.m16n8k16 A layout per warp), B K-major in shared
// memory (its rows are N).
__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WG_OUT8(0), WG_OUT8(8), WG_OUT8(16), WG_OUT8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x N] (+)= A B over one 8-deep k-step of tf32 operands, fp32 sums;
// A and B K-major in shared memory (descriptors a, b). N = 16, 32 or 64 by
// the size of d; acc == 0 overwrites d. tf32 wgmma has no transpose bits.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[8], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : WG_OUT8(0)
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : WG_OUT8(0), WG_OUT8(8)
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : WG_OUT8(0), WG_OUT8(8), WG_OUT8(16), WG_OUT8(24)
      : "l"(a), "l"(b), "r"(acc));
}

// d[64 x N] += A B over one k-step: A [64 x 8] tf32 from registers (per
// warp the mma.m16n8k8 tf32 A layout: rows g and g + 8, columns t and
// t + 4 for lane 4 g + t), B K-major in shared memory. N = 16, 32 or 64 by
// the size of d.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : WG_OUT8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : WG_OUT8(0), WG_OUT8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_OUT8(0), WG_OUT8(8), WG_OUT8(16), WG_OUT8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_OUT8

// 16 bytes of v to global (p) or shared (addr) memory.
__device__ __forceinline__ void st_global4(unsigned char* p, const uint32_t (&v)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void st_shared4(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]) : "memory");
}

// Four fp32 values from 16-byte aligned p, or zeros when !ok (p is then not read).
__device__ __forceinline__ float4 load4(const float* p, bool ok) {
  return ok ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Sets this warpgroup's registers a thread to N (INC: raise, else lower);
// every thread of the warpgroup executes it.
template <int N, bool INC>
__device__ __forceinline__ void set_max_regs() {
  if constexpr (INC)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
  else
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// Waits at named barrier `id` (1-15) for the 128 threads of one warpgroup.
__device__ __forceinline__ void wg_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// 2^x, flushing results below 2^-126 to 0 (one MUFU instruction; exp2f
// adds a subnormal path).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to tf32 (10 mantissa bits; to nearest, ties away from zero),
// as the bits of an fp32 value whose 13 low bits are zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x as hi + lo, both tf32: hi = tf32(x), lo = tf32(x - hi), so that
// |x - hi - lo| <= 2^-22 |x| for normal x. The three products
// a_lo b_hi + a_hi b_lo + a_hi b_hi of two split values (3xTF32) then
// carry fp32-class error. FINITE: x is known finite (P, dS); otherwise a
// non-finite hi gets lo = 0, as the plain `tf32_split` of
// kernels/segment_attention.py has it.
template <bool FINITE>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  const bool finite = FINITE || (hi & 0x7F800000u) != 0x7F800000u;
  lo = finite ? to_tf32(x - __uint_as_float(hi)) : 0u;
}

// Split the four values of v into hi and lo words (split_tf32).
__device__ __forceinline__ void split4(const float4& v, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32<false>(v.x, hi[0], lo[0]);
  split_tf32<false>(v.y, hi[1], lo[1]);
  split_tf32<false>(v.z, hi[2], lo[2]);
  split_tf32<false>(v.w, hi[3], lo[3]);
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
