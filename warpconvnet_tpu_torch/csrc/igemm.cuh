// Device routines of the implicit-GEMM kernels: K2 (implicit_gemm.cu: the
// forward, and dgrad through the reverse table), K3 (implicit_gemm_wgrad.cu:
// the weight gradient of any map) and K4 (implicit_gemm_bwd_fused.cu: the
// fused backward of a symmetric self-map). They replace, in
// warpconvnet_tpu/kernels/implicit_gemm.py, `_igemm_kernel` (:546),
// `_igemm_wgrad_kernel` (:683) and `_igemm_bwd_fused_kernel` (:801).
//
// What bounds them on the card: the row gathers. A pair costs one row of x
// (or g) gathered by index and C_in x C_out multiply-adds, so at the
// MinkUNet18 step's widths (32-384 channels) the bytes moved, not the
// tensor cores, set the floor; what the design controls is how many
// gathered rows, table entries and flushed dw floats are not useful work.
//
// A tile is 64 output rows taken in the map's row order (`order[b, i]`, a
// permutation of each scene's rows that puts rows with equal offset masks
// together; null reads the rows in index order). A block first reads the
// tile's table entries for up to KC offsets at once (the slab) into shared
// memory and lists the offsets that have a pair among its rows; only those
// are walked. The results do not depend on the order: each row sums its
// listed offsets in ascending k over the same channel slices, and an
// offset a row lacks adds an exact zero whether it is listed or not.
//
// bf16 (`gather_gemm_bf16`): a block of NWG warpgroups (one or two) takes
// NWG consecutive tiles of the order; each warpgroup computes its tile's
// 64 rows x W output columns (W up to 256, so each input row is gathered
// once per tile) on the tensor cores with wgmma, the gathered rows as A
// (K-major, 64 input channels a step) and the weight slice as B
// (MN-major), which the tiles share: neighbouring tiles in the order meet
// mostly the same offsets, so with two warpgroups a slice read from L2
// serves 128 rows, while each warpgroup skips the offsets its own tile
// lacks. The (offset, 64-channel slice) steps run through a ring of
// shared-memory stages: the rows arrive by cp.async 16-byte copies, row
// i's copies zero-filled without a read when its entry is -1; the weight
// slice by one bulk copy (TMA, completing on the stage's mbarrier) from a
// weight image that `pack_weights` lays out in the stage's swizzled
// layout before the kernel runs. The copies of the next steps are in
// flight while the tensor cores work on this one. One warpgroup with a
// three-stage ring (several blocks an SM: one block's setup of its tiles,
// its rows, slab and first copies, overlaps another's steps) serves
// widths up to 128 and small maps; two warpgroups serve wider chunks,
// whose weight slices cost the most. Ragged widths (C_in 3, widths not
// multiples of 8, or unaligned bases) take element copies through
// registers for the rows, in the same ring. fp32 (`gather_gemm_f32`)
// keeps CUDA-core FMAs (TF32 would change the numerics) over 64 x 64
// tiles, with the same rows and list.
//
// The weight gradient dw[k] = sum x[table[b, k, o]]^T g[o] (`dw_chunk_bf16`,
// `dw_chunk_f32`), shared by K3 (every map: x and g with their own row
// counts) and K4's dw blocks (a self-map), runs per (offset k, a chunk of
// input channels, 64 output channels a warpgroup (fp32: 64 a block), a
// chunk of output rows, scene; `DwGrid`): the chunk's valid pairs of
// offset k are compacted into shared memory (`PairList`), then their g and x rows gathered 64 pairs a step through the
// same kind of ring and summed on the tensor cores (bf16: dw^T = G^T X,
// both operands MN-major, each warpgroup 64 output channels x the whole
// input chunk in registers; fp32: 64 x 64 FMA tiles) into accumulators
// added into dw once per block with float4 atomics. So x, g and the table
// are read once per (input chunk, output-channel block), gathers touch
// only rows with a pair, and dw takes C_in x C_out floats per (scene,
// offset, chunk) that holds a pair; long chunks keep those flushes few on
// big maps, short ones fill the card on small maps (K3 picks the chunk
// length at launch, `plan_dw`; K4 keeps fixed ones).
//
// Counts: the first column chunk's blocks add their tile work, 64 rows
// for each (tile, listed offset) that the tile computes, to `work`; each
// dw block that flushes adds the floats it adds into dw to `dw_floats`.
// One atomic a block, so that a run reports what the kernels did (the
// host models of both, implicit_gemm.py `tile_work` and
// `bwd_fused_dw_atomics`, are held against them on the card).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace wct::igemm {

using namespace wct::hopper;

constexpr int BM = 64;        // rows of a tile
constexpr int BK = 64;        // input channels of one bf16 step
constexpr int KC = 32;        // offsets of one slab
constexpr int WG = 128;       // threads of the bf16 roles: one warpgroup
constexpr int F_THREADS = 256;  // threads of the fp32 roles
constexpr int DW_ROWS = 4096;   // rows of a bf16 weight-gradient chunk (K4; K3's longest)
constexpr int F_DW_ROWS = 2048; // rows of an fp32 one (K4; K3's longest)
constexpr int DW_PAIRS = 64;    // pairs of one weight-gradient step

// ---- PTX beside hopper.cuh ---------------------------------------------------

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

#define WG_OUT8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] += A B over one 16-deep k-step, both operands in shared
// memory; TA / TB: 0 K-major, 1 MN-major (transposed).
template <int TA, int TB>
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %34, %35;\n}\n"
      : WG_OUT8(0), WG_OUT8(8), WG_OUT8(16), WG_OUT8(24)
      : "l"(a), "l"(b), "n"(TA), "n"(TB), "r"(1));
}

// d[64 x 32] += A B, as wgmma64.
template <int TA, int TB>
__device__ __forceinline__ void wgmma32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %20, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %18, %19;\n}\n"
      : WG_OUT8(0), WG_OUT8(8)
      : "l"(a), "l"(b), "n"(TA), "n"(TB), "r"(1));
}

#undef WG_OUT8

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One 16-byte chunk (8 bf16) of a row into shared memory at `dst`: by
// cp.async (vec: the source is 16-byte aligned and whole), zero-filled
// without a read when !ok; or element by element through registers, the
// elements at and past n_ok zero.
__device__ __forceinline__ void copy_chunk(unsigned char* dst, const bf16* src, bool ok, int n_ok,
                                           bool vec, const bf16* any) {
  if (vec) {
    cp_async16(smem_addr(dst), ok ? src : any, ok);
  } else {
    alignas(16) bf16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = ok && j < n_ok ? src[j] : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}

// ---- the block's rows, the slab and the offset list --------------------------

// A block's ROWS rows (one 64-row tile, or one for each of the bf16 roles'
// two warpgroups), their table entries for up to KC offsets, and the
// offsets with a pair among them.
template <int ROWS>
struct Slab {
  static constexpr int TILES = ROWS / BM;
  uint64_t bar[8];        // the bf16 ring's stages' mbarriers (weight images landed)
  int32_t rows[ROWS];     // the block's rows (output rows of the table); -1 past n_out
  int32_t src[KC][ROWS];  // table[b, k0 + kk, rows[r]], or -1
  int32_t list[KC];       // offsets kk with a pair among the rows, ascending
  int32_t has[KC];        // for list[i]: bit w set when 64-row tile w has a pair of it
  int32_t flag[KC];
  int n;                  // entries of list
};

// Rows m0 .. m0 + ROWS - 1 of the order (or of the index order when order
// is null).
template <int NT, int ROWS>
__device__ __forceinline__ void load_rows(Slab<ROWS>& sl, const int32_t* __restrict__ order,
                                          int b, int n_out, int m0) {
  for (int r = threadIdx.x; r < ROWS; r += NT) {
    const int i = m0 + r;
    sl.rows[r] = i >= n_out ? -1 : order != nullptr ? order[int64_t(b) * n_out + i] : i;
  }
}

// Reads the slab of offsets k0 .. k0 + kc - 1 and lists the non-empty ones.
// The caller has synchronised after load_rows; returns after a barrier.
template <int NT, int ROWS>
__device__ __forceinline__ void load_slab(Slab<ROWS>& sl, const int32_t* __restrict__ table,
                                          int b, int k_vol, int n_out, int k0, int kc) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int32_t* tb = table + (int64_t(b) * k_vol + k0) * n_out;
  constexpr int IT = KC * ROWS / NT;
  int32_t v[IT];  // every load in flight before the first store
#pragma unroll
  for (int j = 0; j < IT; ++j) {
    const int idx = t + j * NT, kk = idx / ROWS;
    const int32_t o = sl.rows[idx % ROWS];
    v[j] = kk < kc && o >= 0 ? __ldg(tb + int64_t(kk) * n_out + o) : -1;
  }
#pragma unroll
  for (int j = 0; j < IT; ++j) {
    const int idx = t + j * NT;
    if (idx / ROWS < kc) sl.src[idx / ROWS][idx % ROWS] = v[j];
  }
  __syncthreads();
  for (int kk = warp; kk < kc; kk += NT / 32) {
    int f = 0;
#pragma unroll
    for (int w = 0; w < Slab<ROWS>::TILES; ++w)
      f |= int(__any_sync(0xffffffffu, sl.src[kk][BM * w + lane] >= 0 ||
                                            sl.src[kk][BM * w + lane + 32] >= 0)) << w;
    if (lane == 0) sl.flag[kk] = f;
  }
  __syncthreads();
  if (warp == 0) {
    const int f = lane < kc ? sl.flag[lane] : 0;
    const unsigned bits = __ballot_sync(0xffffffffu, f != 0);
    if (f != 0) {
      const int pos = __popc(bits & ((1u << lane) - 1u));
      sl.list[pos] = lane;
      sl.has[pos] = f;
    }
    if (lane == 0) sl.n = __popc(bits);
  }
  __syncthreads();
}

// ---- bf16: two warpgroups, wgmma over a cp.async ring ------------------------

constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may use

// Shared-memory tiles of one step: A [64 rows][64 channels] for each of
// the block's NWG warpgroups, and B [64 channels][W columns], shared by
// them, as 64-column blocks (128-byte swizzle) and, for W = 64 j + 32, a
// 32-column tail (64-byte swizzle).
template <int W, int NWG>
struct Ring {
  static constexpr int NB = W / 64;        // full 64-column blocks
  static constexpr int T32 = W % 64 / 32;  // a 32-column tail
  static_assert(W % 32 == 0 && W >= 32 && W <= 256, "W is a multiple of 32 up to 256");
  using TA = Tile<64>;
  using TBm = Tile<64 * (NB > 0 ? NB : 1)>;
  using TBt = Tile<32>;
  static constexpr int NT = NWG * WG;  // threads of the block
  static constexpr uint32_t BM_OFF = NWG * TA::BYTES;
  static constexpr uint32_t BT_OFF = BM_OFF + NB * 8192;
  static constexpr uint32_t STAGE = BT_OFF + T32 * TBt::BYTES;
  __device__ static constexpr uint32_t a_off(int w) { return w * TA::BYTES; }
  // Stages of a one-warpgroup ring (`one`: a small ring lets several
  // blocks share an SM, so that one block's setup of its tiles, its rows,
  // slab and first copies, overlaps another's steps; measured faster than
  // deeper rings at widths up to 128), or for two warpgroups as many as
  // fit beside `scratch` bytes, at most 6.
  static constexpr int stages(int one, int scratch) {
    return NWG == 1 ? one
           : int((MAX_SMEM - 1024 - scratch) / STAGE) < 6 ? int((MAX_SMEM - 1024 - scratch) / STAGE)
                                                          : 6;
  }
};

// k-steps (16 channels) of the slice starting at input channel c0.
__device__ __forceinline__ int slice_ksteps(int c_in, int c0) {
  const int n = (c_in - c0 + 15) / 16;
  return n < 4 ? n : 4;
}

// The row gathers of one step into a stage: for each warpgroup w whose
// tile has a pair of the offset (bit w of `has`), A_w = its tile's rows
// gathered at sl.src[kk] (channels c0 ..).
template <int W, int NWG>
__device__ __forceinline__ void load_step(unsigned char* stage, const Slab<NWG * BM>& sl, int kk,
                                          int has, const bf16* __restrict__ x, int64_t x_row0,
                                          int c_in, int c0, bool vec) {
  using R = Ring<W, NWG>;
  const int t = threadIdx.x;
  const int nks = slice_ksteps(c_in, c0);
  const int ach = 2 * nks;  // 16-byte chunks of a gathered row segment
  for (int idx = t; idx < NWG * BM * ach; idx += R::NT) {
    const int w = idx / (BM * ach), rest = idx - w * (BM * ach);
    if (!((has >> w) & 1)) continue;  // that tile lacks the offset: its A is not read
    const int r = rest / ach, c = rest - r * ach;
    const int32_t s = sl.src[kk][BM * w + r];
    const int ch = c0 + 8 * c;
    copy_chunk(stage + R::a_off(w) + R::TA::chunk(r, c), x + (x_row0 + s) * c_in + ch,
               s >= 0 && ch < c_in, c_in - ch, vec, x);
  }
}

template <int W>
using Acc = float[W / 64 > 0 ? W / 64 : 1][32];

// A warpgroup's products of one step: NKS k-steps of 16 (channels, or
// pairs) of A (at `a`: K-major, or MN-major with MN_A) times B (MN-major,
// at the stage's B slots), issued, committed and waited for inside one
// branch.
template <int W, int NWG, int NKS, int MN_A>
__device__ __forceinline__ void mma_step(Acc<W>& acc, float (&tail)[16], uint32_t a,
                                         uint32_t stage) {
  using R = Ring<W, NWG>;
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    const uint64_t da = MN_A ? R::TA::mn_major(a, ks, 0) : R::TA::k_major(a, ks);
#pragma unroll
    for (int cb = 0; cb < R::NB; ++cb)
      wgmma64<MN_A, 1>(acc[cb], da, R::TBm::mn_major(stage + R::BM_OFF, ks, cb));
    if constexpr (R::T32 != 0)
      wgmma32<MN_A, 1>(tail, da, R::TBt::mn_major(stage + R::BT_OFF, ks, 0));
  }
  wg_commit();
  wg_wait<0>();
#pragma unroll
  for (int cb = 0; cb < R::NB; ++cb) hold(acc[cb]);
  hold(tail);
}

template <int W>
__device__ __forceinline__ void zero(Acc<W>& acc, float (&tail)[16]) {
#pragma unroll
  for (int cb = 0; cb < (W / 64 > 0 ? W / 64 : 1); ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) tail[i] = 0.f;
}

// out[b, rows, n0 .. n0 + W) = sum over the listed offsets of
// x[b, table[b, k, rows]] @ w[k'][:, n0 ..] (n0 = W chunk), rounded once to
// bf16; rows = the order's rows m0 .. m0 + 64 NWG - 1, warpgroup w taking
// 64-row tile w and skipping the offsets its tile lacks. x [B, n_in,
// c_in], out [B, n_out, c_out]; wimg holds w [K, c_in, c_out] as
// pack_weights lays it out (k' chosen there), so that each step's weight
// slice reaches its stage in one bulk copy. `ring` is the block's
// 1024-aligned dynamic shared memory (S stages). Every thread of the block
// calls it.
template <int W, int NWG, int S>
__device__ __forceinline__ void gather_gemm_bf16(
    Slab<NWG * BM>& sl, unsigned char* ring, const bf16* __restrict__ x,
    const unsigned char* __restrict__ wimg, const int32_t* __restrict__ table,
    const int32_t* __restrict__ order, bf16* __restrict__ out, int b, int m0, int chunk,
    int n_chunks, int n_in, int n_out, int k_vol, int c_in, int c_out, bool vec,
    unsigned long long* work) {
  using R = Ring<W, NWG>;
  constexpr uint32_t IMG = R::STAGE - R::BM_OFF;  // bytes of one step's weight slice
  const int t = threadIdx.x, wg = t / WG, tw = t % WG;
  const int n0 = chunk * W;
  Acc<W> acc;
  float tail[16];
  zero<W>(acc, tail);

  load_rows<R::NT>(sl, order, b, n_out, m0);
  if (t == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) mbar_init(smem_addr(&sl.bar[s]), 1);
    fence_barrier_init();
  }
  __syncthreads();
  const int ncs = (c_in + BK - 1) / BK;
  const int64_t x_row0 = int64_t(b) * n_in;
  const uint32_t ring_s = smem_addr(ring);
  int done = 0;  // steps of earlier slabs: the stages' and mbarriers' count goes on
  unsigned long long walked = 0;  // (tile, offset) pairs computed (thread 0)
  for (int k0 = 0; k0 < k_vol; k0 += KC) {
    const int kc = k_vol - k0 < KC ? k_vol - k0 : KC;
    load_slab<R::NT>(sl, table, b, k_vol, n_out, k0, kc);
    if (t == 0)
      for (int li = 0; li < sl.n; ++li) walked += __popc(sl.has[li]);
    const int n_steps = sl.n * ncs;
    auto issue = [&](int s) {
      if (s < n_steps) {
        const int li = s / ncs, kk = sl.list[li], cs = s % ncs, st = (done + s) % S;
        load_step<W, NWG>(ring + st * R::STAGE, sl, kk, sl.has[li], x, x_row0, c_in, cs * BK,
                          vec);
        if (t == 0) {
          const uint32_t bar = smem_addr(&sl.bar[st]);
          mbar_expect_tx(bar, IMG);
          bulk_copy(ring_s + st * R::STAGE + R::BM_OFF,
                    wimg + ((int64_t(k0 + kk) * ncs + cs) * n_chunks + chunk) * IMG, IMG, bar);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < S - 1; ++s) issue(s);
    for (int s = 0; s < n_steps; ++s) {
      const int st = (done + s) % S;
      cp_async_wait<S - 2>();
      fence_async_proxy();  // the landed copies and stores, before the tensor cores read them
      __syncthreads();      // every thread's copies of step s; every wgmma of step s - 1 done
      mbar_wait(smem_addr(&sl.bar[st]), ((done + s) / S) & 1);  // the weight slice landed
      issue(s + S - 1);
      if ((sl.has[s / ncs] >> wg) & 1) {
        const uint32_t a = ring_s + st * R::STAGE + R::a_off(wg), stg = ring_s + st * R::STAGE;
        switch (slice_ksteps(c_in, (s % ncs) * BK)) {
          case 4: mma_step<W, NWG, 4, 0>(acc, tail, a, stg); break;
          case 3: mma_step<W, NWG, 3, 0>(acc, tail, a, stg); break;
          case 2: mma_step<W, NWG, 2, 0>(acc, tail, a, stg); break;
          default: mma_step<W, NWG, 1, 0>(acc, tail, a, stg); break;
        }
      }
    }
    cp_async_wait<0>();
    done += n_steps;
    __syncthreads();  // the slab and the ring are free for the next offsets
  }
  if (work != nullptr && t == 0 && chunk == 0 && walked != 0) atomicAdd(work, walked * BM);

  // Thread tw of warpgroup wg holds its tile's rows 16 (tw / 32) + g and
  // that + 8 (g = tw % 32 / 4), columns 8 i + 2 (tw % 4) + {0, 1} of each
  // 8-column group i.
  const int g = tw % 32 / 4, q = tw % 4;
  const bool pairs = vec;  // c_out even and the rows 4-byte aligned
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int32_t o = sl.rows[BM * wg + 16 * (tw / 32) + g + 8 * h];
    if (o < 0) continue;
    bf16* orow = out + (int64_t(b) * n_out + o) * c_out + n0;
    auto put = [&](int col, float v0, float v1) {
      if (n0 + col + 1 < c_out && pairs) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (n0 + col < c_out) orow[col] = __float2bfloat16(v0);
        if (n0 + col + 1 < c_out) orow[col + 1] = __float2bfloat16(v1);
      }
    };
#pragma unroll
    for (int cb = 0; cb < R::NB; ++cb)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        put(64 * cb + 8 * i + 2 * q, acc[cb][4 * i + 2 * h], acc[cb][4 * i + 2 * h + 1]);
    if constexpr (R::T32 != 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        put(64 * R::NB + 8 * i + 2 * q, tail[4 * i + 2 * h], tail[4 * i + 2 * h + 1]);
    }
  }
}

// ---- fp32: CUDA cores, 256 threads, 64 x 64 tiles ----------------------------

constexpr int F_BK = 16;  // input channels of one fp32 step

struct F32Smem {
  float As[F_BK][BM];      // gathered rows, transposed
  float Bs[F_BK][64 + 4];  // w[k] slice
};

// As gather_gemm_bf16 for fp32 over 64 output columns from n0, by 256
// threads with 4 x 4 outputs each; w [K, c_in, c_out], or with trans_w
// [K, c_out, c_in] whose transpose the product takes (dgrad, K4's dx),
// offset k reading w[K-1-k] with flip_w.
__device__ __forceinline__ void gather_gemm_f32(
    Slab<BM>& sl, F32Smem& sm, const float* __restrict__ x, const float* __restrict__ w,
    const int32_t* __restrict__ table, const int32_t* __restrict__ order, float* __restrict__ out,
    int b, int m0, int n0, int n_in, int n_out, int k_vol, int c_in, int c_out, bool flip_w,
    bool trans_w, unsigned long long* work) {
  const int t = threadIdx.x;
  const int ty = t / 16, tx = t % 16;
  const int a_row = t / 4, a_col = (t % 4) * 4;   // A: 4 threads a row, 4 channels each
  // B: 4 columns a thread; neighbouring threads take neighbouring columns
  // of one channel, or with trans_w neighbouring channels of one column,
  // so that they read neighbouring floats of w either way.
  const int b_row = trans_w ? t % 16 : t / 16, b_col = (trans_w ? t / 16 : t % 16) * 4;
  const float* xb = x + int64_t(b) * n_in * c_in;
  float acc[4][4] = {};
  unsigned long long walked = 0;
  load_rows<F_THREADS>(sl, order, b, n_out, m0);
  __syncthreads();
  for (int k0 = 0; k0 < k_vol; k0 += KC) {
    const int kc = k_vol - k0 < KC ? k_vol - k0 : KC;
    load_slab<F_THREADS>(sl, table, b, k_vol, n_out, k0, kc);
    walked += sl.n;
    for (int li = 0; li < sl.n; ++li) {
      const int kk = sl.list[li];
      const int32_t s = sl.src[kk][a_row];
      const float* xrow = s >= 0 ? xb + int64_t(s) * c_in : nullptr;
      const float* wk = w + int64_t(flip_w ? k_vol - 1 - (k0 + kk) : k0 + kk) * c_in * c_out;
      for (int c0 = 0; c0 < c_in; c0 += F_BK) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + a_col + j;
          sm.As[a_col + j][a_row] = (xrow != nullptr && c < c_in) ? xrow[c] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + b_row, col = n0 + b_col + j;
          sm.Bs[b_row][b_col + j] =
              c < c_in && col < c_out
                  ? wk[trans_w ? int64_t(col) * c_in + c : int64_t(c) * c_out + col] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kq = 0; kq < F_BK; ++kq) {
          float av[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = sm.As[kq][ty * 4 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = sm.Bs[kq][tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
    __syncthreads();  // the slab is free for the next offsets
  }
  if (work != nullptr && t == 0 && n0 == 0 && walked != 0) atomicAdd(work, walked * BM);
  float* ob = out + int64_t(b) * n_out * c_out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int32_t o = sl.rows[ty * 4 + i];
    if (o < 0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < c_out) ob[int64_t(o) * c_out + col] = acc[i][j];
    }
  }
}

// ---- the weight gradient (K3, K4's dw blocks): a chunk of rows of one offset

// The dw blocks: (k, input-channel chunk, co_width output channels, chunk
// of `rows` output rows, scene), row chunk fastest.
struct DwGrid {
  int n_rc, n_co, n_ci, k_vol, co_width;
  static DwGrid make(int n_out, int rows, int c_out, int co_width, int n_ci, int k_vol) {
    return DwGrid{(n_out + rows - 1) / rows, (c_out + co_width - 1) / co_width, n_ci, k_vol,
                  co_width};
  }
  int64_t blocks(int b) const { return int64_t(n_rc) * n_co * n_ci * k_vol * b; }
  __device__ void decode(int j, int& k, int& ci, int& co0, int& rc, int& b) const {
    rc = j % n_rc;
    j /= n_rc;
    co0 = (j % n_co) * co_width;
    j /= n_co;
    ci = j % n_ci;
    j /= n_ci;
    k = j % k_vol;
    b = j / k_vol;
  }
};

// The valid pairs (table entry, row) of rows lo .. hi - 1 of table[b, k],
// compacted in row order into shared memory at `mem` (bytes(rows) bytes
// for chunks of up to rows <= MAX_ROWS rows): each warp loads its own
// segment of the chunk (hi - lo split evenly over the warps in multiples
// of 32 rows), all its loads in flight together, counts its pairs with
// ballots, and after a prefix sum over the warps writes them from its
// start, so that pair p sits at src[p], dst[p].
template <int NT, int MAX_ROWS>
struct PairList {
  static constexpr int NW = NT / 32;
  static constexpr int IT = MAX_ROWS / NT;  // loads a lane, at most
  static_assert(MAX_ROWS % NT == 0, "whole loads a lane");
  int32_t* src;
  int32_t* dst;
  int* start;

  __host__ __device__ static constexpr int bytes(int rows) { return rows * 8 + (NW + 1) * 4; }

  __device__ PairList(unsigned char* mem, int rows)
      : src(reinterpret_cast<int32_t*>(mem)), dst(src + rows),
        start(reinterpret_cast<int*>(dst + rows)) {}

  // Every thread calls; returns the number of pairs after a barrier.
  __device__ __forceinline__ int build(const int32_t* __restrict__ trow, int lo, int hi) {
    const int t = threadIdx.x, lane = t % 32, warp = t / 32;
    const int it = (hi - lo + NT - 1) / NT;
    const int s0 = lo + warp * 32 * it + lane;
    int32_t v[IT];
#pragma unroll
    for (int j = 0; j < IT; ++j)
      v[j] = j < it && s0 + 32 * j < hi ? __ldg(trow + s0 + 32 * j) : -1;
    int n = 0;
#pragma unroll
    for (int j = 0; j < IT; ++j) n += __popc(__ballot_sync(0xffffffffu, v[j] >= 0));
    if (lane == 0) start[warp + 1] = n;
    __syncthreads();
    if (t == 0) {
      start[0] = 0;
      for (int w = 0; w < NW; ++w) start[w + 1] += start[w];
    }
    __syncthreads();
    int p = start[warp];
#pragma unroll
    for (int j = 0; j < IT; ++j) {
      const unsigned bits = __ballot_sync(0xffffffffu, v[j] >= 0);
      if (v[j] >= 0) {
        const int q = p + __popc(bits & ((1u << lane) - 1u));
        src[q] = v[j];
        dst[q] = s0 + 32 * j;
      }
      p += __popc(bits);
    }
    __syncthreads();
    return start[NW];
  }
};

// dw[k][n0 .. n0 + W)[co0 .. co0 + 64 NWG) += sum over the chunk's pairs
// of x[b, src][n0 ..]^T g[b, dst][co0 ..] (x [B, n_in, c_in], g [B, n_out,
// c_out], table [B, k_vol, n_out]), on the tensor cores as its
// transpose G^T X: 64 pairs a step through a ring of S stages laid out as
// Ring<W, NWG>'s (warpgroup w's A slot holds the pairs' g rows at output
// channels co0 + 64 w .., read MN-major as A = G^T; the shared B slots
// their x rows, read MN-major as B = X), one fp32 accumulator a warpgroup
// (64 output x W input channels) over the whole chunk, added into dw once,
// through shared memory, with float4 atomics.
template <int W, int NWG, int S>
__device__ __forceinline__ void dw_chunk_bf16(PairList<NWG * WG, DW_ROWS>& pl,
                                              unsigned char* ring,
                                              const bf16* __restrict__ x,
                                              const bf16* __restrict__ g,
                                              const int32_t* __restrict__ table, float* dw, int b,
                                              int k, int n0, int co0, int lo, int hi, int n_in,
                                              int n_out, int k_vol, int c_in, int c_out, bool vec,
                                              unsigned long long* dw_floats) {
  using R = Ring<W, NWG>;
  constexpr int CO = 64 * NWG;  // output channels of the block
  constexpr int LD = CO + 4;
  static_assert(W * LD * 4 <= S * R::STAGE, "the ring holds the staged sums");
  const int t = threadIdx.x, wg = t / WG, tw = t % WG;
  const int n_pairs = pl.build(table + (int64_t(b) * k_vol + k) * n_out, lo, hi);
  if (n_pairs == 0) return;
  const int n_steps = (n_pairs + DW_PAIRS - 1) / DW_PAIRS;
  const int64_t x_row0 = int64_t(b) * n_in, g_row0 = int64_t(b) * n_out;
  const bool active = co0 + 64 * wg < c_out;  // the warpgroup has output channels
  auto issue = [&](int s) {
    if (s < n_steps) {
      unsigned char* st = ring + (s % S) * R::STAGE;
      for (int idx = t; idx < NWG * DW_PAIRS * 8; idx += R::NT) {  // g rows: 64 channels a wg
        const int w = idx / (DW_PAIRS * 8), p = idx / 8 % DW_PAIRS, c = idx % 8;
        const int pp = s * DW_PAIRS + p, ch = co0 + 64 * w + 8 * c;
        if (co0 + 64 * w >= c_out) continue;  // that warpgroup has no channels
        const bool in = pp < n_pairs;
        copy_chunk(st + R::a_off(w) + R::TA::chunk(p, c),
                   g + (g_row0 + (in ? pl.dst[pp] : 0)) * c_out + ch, in && ch < c_out,
                   c_out - ch, vec, g);
      }
      constexpr int NCH = W / 8;
      for (int idx = t; idx < DW_PAIRS * NCH; idx += R::NT) {  // x rows: W input channels
        const int p = idx / NCH, c = idx % NCH, pp = s * DW_PAIRS + p;
        const bool in = pp < n_pairs;
        const int ch = n0 + 8 * c;
        const uint32_t off = c < 8 * R::NB ? R::BM_OFF + R::TBm::chunk(p, c)
                                           : R::BT_OFF + R::TBt::chunk(p, c - 8 * R::NB);
        copy_chunk(st + off, x + (x_row0 + (in ? pl.src[pp] : 0)) * c_in + ch,
                   in && ch < c_in, c_in - ch, vec, x);
      }
    }
    cp_async_commit();
  };
  Acc<W> acc;
  float tail[16];
  zero<W>(acc, tail);
  const uint32_t ring_s = smem_addr(ring);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(s);
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<S - 2>();
    fence_async_proxy();
    __syncthreads();
    issue(s + S - 1);
    if (active) {
      const uint32_t st = ring_s + (s % S) * R::STAGE;
      mma_step<W, NWG, DW_PAIRS / 16, 1>(acc, tail, st + R::a_off(wg), st);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the sums as [input channel][output channel]

  // Thread tw of warpgroup wg holds output channels 64 wg + 16 (tw / 32) +
  // gq and that + 8 (rows of G^T X), input channels 8 i + 2 (tw % 4) +
  // {0, 1} of each 8-column group i.
  float* tile = reinterpret_cast<float*>(ring);
  const int gq = tw % 32 / 4, q = tw % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int co = 64 * wg + 16 * (tw / 32) + gq + 8 * h;
#pragma unroll
    for (int cb = 0; cb < R::NB; ++cb)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          tile[(64 * cb + 8 * i + 2 * q + e) * LD + co] = acc[cb][4 * i + 2 * h + e];
    if constexpr (R::T32 != 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          tile[(64 * R::NB + 8 * i + 2 * q + e) * LD + co] = tail[4 * i + 2 * h + e];
    }
  }
  __syncthreads();
  float* out = dw + (int64_t(k) * c_in + n0) * c_out + co0;
  const int n_rows = c_in - n0, n_cols = c_out - co0;
  if (dw_floats != nullptr && t == 0)
    atomicAdd(dw_floats,
              (unsigned long long)(n_rows < W ? n_rows : W) * (n_cols < CO ? n_cols : CO));
  if (c_out % 4 == 0 && reinterpret_cast<uintptr_t>(dw) % 16 == 0) {
    for (int idx = t; idx < W * CO / 4; idx += R::NT) {  // four output channels an atomic
      const int r = idx / (CO / 4), c = idx % (CO / 4) * 4;
      if (r < n_rows && c < n_cols) {
        const float* v = tile + r * LD + c;
        atomicAdd(reinterpret_cast<float4*>(out + r * int64_t(c_out) + c),
                  make_float4(v[0], v[1], v[2], v[3]));
      }
    }
  } else {
    for (int idx = t; idx < W * CO; idx += R::NT) {
      const int r = idx / CO, c = idx % CO;
      if (r < n_rows && c < n_cols) atomicAdd(out + r * int64_t(c_out) + c, tile[r * LD + c]);
    }
  }
}

struct F32DwSmem {
  float X[32][64 + 4];  // 32 pairs' x rows, 64 input channels
  float G[32][64 + 4];  // their g rows, 64 output channels
};

// As dw_chunk_bf16 in fp32 on the CUDA cores: 32 pairs a step staged in
// shared memory (8 threads a pair, 8 channels each, so a thread reads its
// pair's rows once a step), 4 x 4 of the 64 x 64 tile a thread.
__device__ __forceinline__ void dw_chunk_f32(PairList<F_THREADS, F_DW_ROWS>& pl, F32DwSmem& sm,
                                             const float* __restrict__ x,
                                             const float* __restrict__ g,
                                             const int32_t* __restrict__ table, float* dw, int b,
                                             int k, int ci0, int co0, int lo, int hi, int n_in,
                                             int n_out, int k_vol, int c_in, int c_out,
                                             unsigned long long* dw_floats) {
  const int t = threadIdx.x;
  const int n_pairs = pl.build(table + (int64_t(b) * k_vol + k) * n_out, lo, hi);
  if (n_pairs == 0) return;
  const int ty = t / 16, tx = t % 16;  // ci ty*4.., co tx*4..
  static_assert(F_THREADS == 32 * 8, "8 loader threads for each of a step's 32 pairs");
  const int lp = t / 8, lc = t % 8 * 8;  // loader: pair lp, channels lc ..
  const int64_t x_row0 = int64_t(b) * n_in, g_row0 = int64_t(b) * n_out;
  float acc[4][4] = {};
  for (int p0 = 0; p0 < n_pairs; p0 += 32) {
    const bool in = p0 + lp < n_pairs;
    const float* xr = x + (x_row0 + (in ? pl.src[p0 + lp] : 0)) * c_in + ci0;
    const float* gr = g + (g_row0 + (in ? pl.dst[p0 + lp] : 0)) * c_out + co0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = lc + j;
      sm.X[lp][c] = in && ci0 + c < c_in ? xr[c] : 0.f;
      sm.G[lp][c] = in && co0 + c < c_out ? gr[c] : 0.f;
    }
    __syncthreads();
    const int m = n_pairs - p0 < 32 ? n_pairs - p0 : 32;  // the step's pairs
#pragma unroll 4
    for (int p = 0; p < m; ++p) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sm.X[p][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sm.G[p][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* dk = dw + int64_t(k) * c_in * c_out;
  if (dw_floats != nullptr && t == 0)
    atomicAdd(dw_floats, (unsigned long long)(c_in - ci0 < 64 ? c_in - ci0 : 64) *
                             (c_out - co0 < 64 ? c_out - co0 : 64));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = ci0 + ty * 4 + i;
    if (ci >= c_in) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx * 4 + j;
      if (co < c_out) atomicAdd(dk + int64_t(ci) * c_out + co, acc[i][j]);
    }
  }
}

// Bytes of the weight image of a bf16 K2 (or K4 dx) launch: one Ring B
// slice [64 channels][W columns] for each (offset, 64-channel slice of
// c_in, chunk of c_out).
inline int64_t image_bytes(int k_vol, int c_in, int w, int n_chunks) {
  return int64_t(k_vol) * ((c_in + BK - 1) / BK) * n_chunks * 64 * w * 2;
}

// Lays the weight out as the image: slice (k, cs, chunk) holds B[k'][64 cs
// .., W chunk ..] (k' = k, or K-1-k with flip), B[k][r][c] = w[k][r][c]
// for w [K, c_in, c_out], or w[k][c][r] for w [K, c_out, c_in] with trans
// (the product with w^T, as dgrad and K4's dx take it), in the ring's B
// layout (64-column blocks with the 128-byte swizzle, a 32-column tail
// with the 64-byte one), zero past c_in and c_out. One block a slice;
// static: each source that includes this header has its own.
static __global__ void pack_weights(const bf16* __restrict__ w, unsigned char* __restrict__ img,
                                    int k_vol, int c_in, int c_out, int width, int n_chunks,
                                    bool flip, bool trans) {
  const int ncs = (c_in + BK - 1) / BK;
  const int id = blockIdx.x, chunk = id % n_chunks, cs = id / n_chunks % ncs;
  const int k = id / (n_chunks * ncs), kw = flip ? k_vol - 1 - k : k;
  const int nb = width / 64, nch = width / 8;
  unsigned char* out = img + int64_t(id) * 64 * width * 2;
  for (int j = threadIdx.x; j < 64 * nch; j += blockDim.x) {
    const int kr = j / nch, c = j % nch;
    const int ci = cs * BK + kr, n = chunk * width + 8 * c;
    const uint32_t off = c < 8 * nb ? (c / 8) * Tile<64>::BYTES + Tile<64>::chunk(kr, c % 8)
                                    : nb * Tile<64>::BYTES + Tile<32>::chunk(kr, c - 8 * nb);
    alignas(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = ci < c_in && n + e < c_out
                 ? w[int64_t(kw) * c_in * c_out + (trans ? int64_t(n + e) * c_in + ci
                                                         : int64_t(ci) * c_out + n + e)]
                 : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(out + off) = *reinterpret_cast<const uint4*>(v);
  }
}

// True when every row chunk of 8 bf16 can move as one 16-byte copy: both
// widths are multiples of 8 and the bases 16-byte aligned.
inline bool vec_ok(int c0, int c1, const void* p0, const void* p1, const void* p2,
                   const void* p3 = nullptr) {
  auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return c0 % 8 == 0 && c1 % 8 == 0 && al(p0) && al(p1) && al(p2) && (p3 == nullptr || al(p3));
}

inline int num_sms() {
  static const int sms = [] {
    int device = 0, n = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    return n;
  }();
  return sms;
}

// cudaFuncSetAttribute(KERNEL, max dynamic shared memory, bytes), once per
// kernel (a template instance each) and device: the call costs host time
// on every launch otherwise.
template <auto KERNEL>
cudaError_t allow_smem(int bytes) {
  static unsigned done = 0;  // a bit per device
  int device = 0;
  cudaGetDevice(&device);
  if (device < 32 && (done >> device) & 1u) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device < 32) done |= 1u << device;
  return err;
}

// Warpgroups of a bf16 block for a chunk of W output columns: two (128
// rows sharing each weight slice) above 128 columns when the two-tile
// blocks still fill the card's SMs, else one.
inline int warpgroups(int w, int rows, int blocks_per_row_pair) {
  return w > 128 && int64_t((rows + 2 * BM - 1) / (2 * BM)) * blocks_per_row_pair >= num_sms()
             ? 2 : 1;
}

// Width of a bf16 column chunk: the c_out output columns split into chunks
// of at most 256, each rounded up to a multiple of 32; a small map (fewer
// 64-row tiles than two an SM) splits more than 128 columns in two, for
// twice the blocks.
inline int chunk_width(int c_out, int rows, int b, int* n_chunks) {
  int nc = (c_out + 255) / 256;
  if (nc == 1 && c_out > 128 && int64_t((rows + BM - 1) / BM) * b < 2 * num_sms()) nc = 2;
  const int per = (c_out + nc - 1) / nc;
  *n_chunks = nc;
  return (per + 31) / 32 * 32;
}

// ---- the plan of a launch of dw blocks alone (K3) ---------------------------

constexpr int MIN_DW_ROWS = 256;  // the shortest row chunk

// Width of a dw block's input-channel chunk: the c_in input channels split
// into chunks of at most 256 (a warpgroup's accumulators), each rounded up
// to a multiple of 32. The row chunks, not the channels, fill the card.
inline int dw_width(int c_in, int* n_chunks) {
  const int nc = (c_in + 255) / 256;
  *n_chunks = nc;
  return ((c_in + nc - 1) / nc + 31) / 32 * 32;
}

// The grid and chunk length of a launch of dw blocks alone: from `rows`
// (at most MIN_DW_ROWS << 6) down to MIN_DW_ROWS, halved while the grid
// holds fewer blocks than the card keeps resident at once (`full` false),
// or while a chunk half as long (a pair list half the size) lets more
// blocks share an SM. Long chunks keep the flushes few on big maps, short
// ones fill the card on small maps. KERNEL's blocks an SM at each length
// are asked once (the occupancy call costs host time); smem(rows) is its
// dynamic shared memory, whose limit must be raised first. K4 keeps fixed
// chunks (DW_ROWS, F_DW_ROWS): its dw blocks share one grid and one
// shared-memory size with its dx tiles, so their length moves neither the
// blocks an SM nor the grid's fill.
struct DwPlan {
  DwGrid grid;
  int rows;
  bool full;
};

template <auto KERNEL, typename Smem>
DwPlan plan_dw(int b, int n_out, int rows, int c_out, int co_width, int n_ci, int k_vol,
               int threads, Smem smem) {
  static int per_sm[8] = {};  // by halvings from `rows`
  auto resident = [&](int i, int r) {
    if (per_sm[i] == 0) {
      int n = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, KERNEL, threads, smem(r));
      per_sm[i] = n > 0 ? n : 1;
    }
    return per_sm[i];
  };
  for (int i = 0;; ++i, rows /= 2) {
    const DwGrid dg = DwGrid::make(n_out, rows, c_out, co_width, n_ci, k_vol);
    const bool full = dg.blocks(b) >= int64_t(num_sms()) * resident(i, rows);
    if (rows <= MIN_DW_ROWS || (full && resident(i, rows) >= resident(i + 1, rows / 2)))
      return DwPlan{dg, rows, full};
  }
}

}  // namespace wct::igemm
