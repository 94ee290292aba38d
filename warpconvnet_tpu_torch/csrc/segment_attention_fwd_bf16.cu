// Segment-masked attention forward (K9) on bf16 inputs: Hopper's tensor
// cores (wgmma, sm_90a).
//
// The function is segment_attention.cu's: out = softmax(scale * Q K^T) V
// over the pairs of equal segments, per (scene, head), and (when asked) the
// rows' natural-log log-sum-exp, +inf on rows that match nothing (whose
// out is exactly 0). As in the stock TPU kernel, the unnormalised
// probabilities P = exp(S - running max) are rounded to bf16 before P V;
// S, the softmax state, the row sums (of the fp32 P) and out's sums are
// fp32, and out is written in bf16 from them.
//
// Replaces: `_flash_attention_kernel` (:331, body :342-482) of jax 0.9.0's
// jax/experimental/pallas/ops/tpu/flash_attention.py, the stock forward
// that warpconvnet_tpu/nn/functional/flash_attention.py `segment_attention`
// runs with SegmentIds.
//
// What bounds it on the card: the tensor cores, 4 * D FLOPs per (query,
// kv) pair of one head with equal segments against 989 TFLOP/s of dense
// bf16; beside them each pair costs one exp2 (MUFU, 16 a cycle an SM: at
// D 64 as many cycles as the products) and a few fp32 operations on the
// CUDA cores, so the two have to overlap.
//
// Design: the bf16 K9-dq's (segment_attention_bwd_bf16.cu) with an online
// softmax, warp-specialised. A block per (own query tile, head, scene):
// three consumer warpgroups of 64 own query rows each (two at D 128) and
// one producer warp, walking the kv tiles. The own tile's [min, max]
// segment range marks the visited 64-row kv tiles in a shared bitmask
// (mark_kv_tiles, segment_attention_fwd.cuh), so every segment layout stays
// exact. Q's A fragments are read once into registers. The producer moves
// each visited K and V tile and its segment ids by cp.async into a free
// stage of a four-stage ring, in the swizzle wgmma reads (128, 64 or 32
// bytes by D); the consumers share each stage. Per visited tile a consumer
// computes S = Q K^T (Q from registers, K read K-major), and P, rounded to
// bf16, goes from S's fp32 accumulator straight into the register A
// fragments of O += P V, whose B operand is the V tile read MN-major:
// nothing is transposed and P never touches shared memory. A warpgroup
// issuing wgmma waits while the tensor cores are busy, so the consumers
// take turns (named barriers): in its turn a consumer issues S of this
// tile and P V of the previous one, and forms this tile's P while the
// others' products run (FlashAttention-3's schedule); only the stages'
// mbarriers tie them to the producer. out's accumulator is rescaled (when
// a row's max moved) before each P V. When
// every own and visited row of a tile pair is valid and in one segment (a
// warp's vote), the mask is skipped. Each block writes only its own rows:
// deterministic. TMA comes later.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "hopper.cuh"
#include "segment_attention_fwd.cuh"

namespace wct::seg_fwd {
namespace {

using namespace wct::hopper;
static_assert(Tile<16>::ROWS == TILE, "wgmma tiles are the kv tiles");

constexpr int WG = 128;               // threads of a warpgroup
constexpr int STAGES = 4;             // kv tiles in shared memory
constexpr size_t kMaxSmem = 232448;   // bytes a block may use on sm_90

// Consumer warpgroups a block, 64 own query rows each: three, two at D 128
// (its accumulators need the registers); then one producer warp.
template <int D>
constexpr int kNumWg = D > 64 ? 2 : 3;
template <int D>
constexpr int kThreads = kNumWg<D> * WG + 32;

// The consumer warpgroups take turns issuing their products: warpgroup w
// waits on named barrier 1 + w until the previous one has passed it the
// turn (2 x 128 threads meet there).
__device__ __forceinline__ void turn_wait(int w) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + w) : "memory");
}

__device__ __forceinline__ void pass_turn(int w) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(1 + w) : "memory");
}

// Keeps the compiler from moving the computation of register operands
// across the wgmma fence.
template <int N>
__device__ __forceinline__ void hold_frags(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// Warp-specialised: the last warp produces (cp.async of each visited kv
// tile into a free stage, whose full mbarrier the copies complete), the
// warpgroups consume (each on its own 64 query rows: S, the online
// softmax and P V, then they mark the stage empty). Nothing but the
// stages' mbarriers ties the warpgroups after the start, so one's products
// run on the tensor cores while another's softmax runs on the CUDA cores.
// Thread t of a consumer warpgroup holds, in every [64 x N] accumulator,
// own rows 16 (t / 32) + (t % 32) / 4 and that + 8, columns
// 8 i + 2 (t % 4) + {0, 1} of each 8-column group i (wgmma's accumulator
// layout).
template <int D>
__global__ void __launch_bounds__(kThreads<D>, 1) seg_attn_fwd_bf16(Args a) {
  using L = Tile<D>;
  constexpr int NWG = kNumWg<D>;
  constexpr int NT = kThreads<D>;
  constexpr int OWN = NWG * TILE;             // own query rows of a block
  constexpr int NB = D > 64 ? D / 64 : 1;     // column blocks of out (N of P V)
  constexpr int NW = (D > 64 ? 64 : D) / 2;   // out's fp32 registers a thread, per block
  constexpr int CPR = D / 8;                  // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t tiles = (raw + 1023u) & ~1023u;
  // [K x STAGES][V x STAGES], then each stage's full and empty mbarriers.
  auto vis_k = [&](int st) { return tiles + st * L::BYTES; };
  auto vis_v = [&](int st) { return tiles + (STAGES + st) * L::BYTES; };
  const uint32_t bars = tiles + 2 * STAGES * L::BYTES;
  auto full_bar = [&](int st) { return bars + st * 8; };
  auto empty_bar = [&](int st) { return bars + (STAGES + st) * 8; };
  int32_t* seg_own = reinterpret_cast<int32_t*>(
      smem_raw + (tiles - raw) + 2 * STAGES * L::BYTES + 2 * STAGES * sizeof(uint64_t));  // [OWN]
  int32_t* seg_oth = seg_own + OWN;  // [STAGES][TILE]
  int* range = seg_oth + STAGES * TILE;
  unsigned* bits = reinterpret_cast<unsigned*>(range + 4);

  const int t = threadIdx.x;
  const int wg = t / WG, tw = t % WG;  // warpgroup (NWG: the producer warp), thread in it
  const int lane = t & 31;
  const int g = tw % 32 / 4, tq = tw % 4;
  const int own0 = blockIdx.x * OWN;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int32_t* skv = a.seg_kv + int64_t(b) * a.skv;
  mark_kv_tiles<NT, OWN>(a.seg_q + int64_t(b) * a.sq, a.sq, own0, skv, a.skv, a.nwords,
                         scene_visit(a.visit, b, a.sq, OWN), a.visits, seg_own, bits, range);
  // A full tile pair (every own and visited row valid, one segment) needs
  // no mask: the own rows must be uniform, the visited tile is voted on.
  const int own_lo = range[0];
  const bool own_uniform = own_lo == range[1] && own0 + OWN <= a.sq;

  const bf16* qb = static_cast<const bf16*>(a.q) + int64_t(b) * a.q_sb + int64_t(hh) * D;
  const bf16* kb = static_cast<const bf16*>(a.k) + int64_t(b) * a.k_sb + int64_t(hh) * D;
  const bf16* vb = static_cast<const bf16*>(a.v) + int64_t(b) * a.v_sb + int64_t(hh) * D;

  if (t == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_bar(st), 32);
      mbar_init(empty_bar(st), NWG * WG);
    }
  }
  __syncthreads();  // the mbarriers
  // The walk: tile i lies in stage i % STAGES.
  int cur = next_tile(bits, a.nwords, -1);

  if (wg == NWG) {
    // Producer warp: K, V (rows past Skv zero) and the segment ids (zero
    // past the end) of each visited tile into a free stage, by cp.async;
    // each lane's copies, once landed, arrive on the stage's full mbarrier.
    for (int it = 0; cur >= 0; ++it) {
      const int st = it % STAGES;
      if (it >= STAGES) mbar_wait(empty_bar(st), (it / STAGES - 1) & 1);
      const int o0 = cur * TILE;
#pragma unroll 4
      for (int idx = lane; idx < TILE * CPR; idx += 32) {
        const int r = idx / CPR, c = idx % CPR;
        const bool ok = o0 + r < a.skv;
        const int64_t row = ok ? o0 + r : 0;
        cp_async16(vis_k(st) + L::chunk(r, c), kb + row * a.k_ss + c * 8, ok);
        cp_async16(vis_v(st) + L::chunk(r, c), vb + row * a.v_ss + c * 8, ok);
      }
#pragma unroll
      for (int r = lane; r < TILE; r += 32)
        cp_async4(seg_oth + st * TILE + r, skv + (o0 + r < a.skv ? o0 + r : 0), o0 + r < a.skv);
      cp_async_mbar_arrive(full_bar(st));
      cur = next_tile(bits, a.nwords, cur);
    }
    cp_async_wait_all();
    return;
  }

  // Consumer warpgroup wg.
  const int rows[2] = {16 * (tw / 32) + g, 16 * (tw / 32) + g + 8};  // own rows in the warpgroup
  const int wg0 = own0 + wg * TILE;  // this warpgroup's first own row
  int my_seg[2];
  bool my_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    my_seg[h] = seg_own[wg * TILE + rows[h]];
    my_ok[h] = wg0 + rows[h] < a.sq;
  }
  // Q's A fragments straight from global memory: k-step ks holds rows
  // rows[0], rows[1] at columns 16 ks + 2 tq (+1) and that + 8 (zero past
  // Sq).
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bf16* qrow = qb + int64_t(my_ok[h] ? wg0 + rows[h] : 0) * a.q_ss + 2 * tq;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        qa[ks][2 * half + h] =
            my_ok[h] ? *reinterpret_cast<const uint32_t*>(qrow + 16 * ks + 8 * half) : 0u;
  }
  // Online softmax state of the thread's two rows (log2 units; l the
  // thread's share of the row sum, summed over the quad at the end) and
  // out's accumulator.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NB][NW];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < NW; ++i) o[cb][i] = 0.f;

  // The walk, software-pipelined (FlashAttention-3's schedule): in its
  // turn a warpgroup issues S of this tile and P V of the previous one;
  // outside it, it forms this tile's P while the next warpgroup's products
  // run. The turns go round the warpgroups through named barriers
  // (turn_wait / pass_turn), so their products do not queue behind each
  // other's and the tensor cores and the softmax overlap.
  float s[32], alpha[2] = {1.f, 1.f};
  uint32_t pa[4][4];
  int st = 0, o0 = 0, pv_st = 0;
  bool full = false;
  // Waits until tile `cur` (step it) has landed in stage st; votes.
  auto arrive_tile = [&](int it) {
    st = it % STAGES;
    o0 = cur * TILE;
    mbar_wait(full_bar(st), (it / STAGES) & 1);
    fence_async_proxy();  // the landed copies, before the tensor cores read them
    // Lanes vote whether kv rows lane and lane + 32 are valid and in the
    // own rows' one segment.
    full = own_uniform &&
        __all_sync(0xffffffffu, o0 + lane + 32 < a.skv && seg_oth[st * TILE + lane] == own_lo &&
                                    seg_oth[st * TILE + lane + 32] == own_lo);
  };
  // S = Q K^T (Q from registers, K K-major): one commit group.
  auto issue_s = [&]() {
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = 0.f;
    hold(s);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) wgmma_rs_kmajor(s, qa[ks], L::k_major(vis_k(st), ks));
    wg_commit();
  };
  // out *= alpha (skipped when no row of the warp changed its max: alpha
  // exactly 1, as in most tiles after the first few), then out += P V of
  // the previous tile (P in pa, its tile in stage pv_st): one commit group.
  auto issue_pv = [&]() {
    if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
      for (int cb = 0; cb < NB; ++cb)
#pragma unroll
        for (int x = 0; x < NW; ++x) o[cb][x] *= alpha[(x >> 1) & 1];
    }
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) hold(o[cb]);
    hold_frags(pa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) wgmma_rs(o[cb], pa[kk], L::mn_major(vis_v(pv_st), kk, cb));
    wg_commit();
  };
  // Online softmax over equal segments of valid rows (MASKED; a full tile
  // pair has no other): kv row c of register 4 j + 2 h + e is
  // 8 j + 2 tq + e. The max runs on the raw scores (the scale is
  // positive); P = exp2(S scale log2(e) - m) replaces S; alpha rescales
  // what came before.
  auto softmax_masked = [&](auto masked) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * h + e, c = 8 * j + 2 * tq + e;
          if constexpr (decltype(masked)::value)
            s[x] = my_ok[h] && o0 + c < a.skv && seg_oth[st * TILE + c] == my_seg[h]
                       ? s[x] : -INFINITY;
          mx = fmaxf(mx, s[x]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * a.scale_log2);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no match yet
      alpha[h] = exp2_ftz(m[h] - m_use);
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * h + e;
          s[x] = exp2_ftz(fmaf(s[x], a.scale_log2, -m_use));
          sum += s[x];
        }
      l[h] = l[h] * alpha[h] + sum;
    }
  };
  auto softmax = [&]() {  // after the wait for issue_s's group
    hold(s);
    if (full)
      softmax_masked(std::false_type{});
    else
      softmax_masked(std::true_type{});
  };
  // P rounded to bf16 as A fragments (the registers of 8-column groups
  // 2 kk and 2 kk + 1 are k-step kk's fragment), once the previous P V is
  // done with them.
  auto hand_off = [&]() {
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) hold(o[cb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
    pv_st = st;
    cur = next_tile(bits, a.nwords, cur);
  };

  if (wg == NWG - 1) pass_turn(0);  // the first turn is warpgroup 0's
  if (cur >= 0) {
    arrive_tile(0);
    turn_wait(wg);
    issue_s();
    pass_turn((wg + 1) % NWG);
    wg_wait<0>();
    softmax();
    hand_off();
    for (int it = 1; cur >= 0; ++it) {
      arrive_tile(it);
      turn_wait(wg);
      issue_s();
      issue_pv();
      pass_turn((wg + 1) % NWG);
      wg_wait<1>();
      softmax();
      wg_wait<0>();
      mbar_arrive(empty_bar(pv_st));  // the previous tile's stage is read
      hand_off();
    }
    turn_wait(wg);
    issue_pv();  // the last tile's
    pass_turn((wg + 1) % NWG);
    wg_wait<0>();
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) hold(o[cb]);
  }
  if (wg == 0) turn_wait(0);  // the last warpgroup's final pass

  // Own rows of out (O / l, bf16) and lse.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = wg0 + rows[h];
    if (r >= a.sq) continue;
    if (a.lse != nullptr && tq == 0)  // m and the reduced l are the same on a quad
      a.lse[(int64_t(b) * a.h + hh) * a.sq + r] = row_lse(m[h], l[h]);
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    bf16* row = static_cast<bf16*>(a.out) + ((int64_t(b) * a.sq + r) * a.h + hh) * D;
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int x = 0; x < NW / 4; ++x)
        *reinterpret_cast<__nv_bfloat162*>(row + 64 * cb + 8 * x + 2 * tq) =
            __floats2bfloat162_rn(o[cb][4 * x + 2 * h] * inv, o[cb][4 * x + 2 * h + 1] * inv);
  }
}

template <int D>
int launch(const Args& a, int b, cudaStream_t stream) {
  // 1024 bytes to align the tiles, the tiles, the mbarriers, then seg_own,
  // seg_oth, range (padded to 4) and the bitmask.
  constexpr int OWN = kNumWg<D> * TILE;
  const size_t bytes = 1024 + 2 * STAGES * size_t(Tile<D>::BYTES) + 2 * STAGES * sizeof(uint64_t) +
                       (OWN + STAGES * TILE + 4 + size_t(a.nwords)) * sizeof(int);
  if (bytes > kMaxSmem) return int(cudaErrorInvalidValue);
  auto kernel = seg_attn_fwd_bf16<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(bytes));
  if (err != cudaSuccess) return int(err);
  const int rc = launch_visit(a.seg_q, a.sq, a.seg_kv, a.skv, b, OWN, a.visit, stream);
  if (rc != 0) return rc;
  const dim3 grid((a.sq + OWN - 1) / OWN, a.h, b);
  kernel<<<grid, kThreads<D>, bytes, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

int launch_bf16(const Args& a, int b, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16>(a, b, stream);
    case 32: return launch<32>(a, b, stream);
    case 64: return launch<64>(a, b, stream);
    case 128: return launch<128>(a, b, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace wct::seg_fwd
