// Segment-masked attention backward on bf16 inputs: K9-dkv and K9-dq on
// Hopper's tensor cores (wgmma, sm_90a).
//
// The function is segment_attention_bwd.cu's: with S = scale * Q K^T over
// the pairs of equal segments, P = exp(S - lse) (lse from K9's forward,
// +inf on rows that match nothing, so their P is exactly 0) and
// di = rowsum(O * dO),
//   dV = P^T dO,  dP = dO V^T,  dS = scale * P * (dP - di),
//   dQ = dS K,  dK = dS^T Q,
// per (scene, head). As in the stock TPU kernels, P and dS (the scale
// folded in) are rounded to bf16 before the products that read them; dP
// and every sum are fp32, and dq, dk and dv are written in bf16 from the
// fp32 sums. Inputs as in segment_attention_bwd.cu (strided q, k, v, dO
// rows; fp32 lse and di [B, H, Sq]); the gradients are contiguous.
//
// Replaces: `_flash_attention_dkv_kernel` (:796) and
// `_flash_attention_dq_kernel` (:1146) of jax 0.9.0's
// jax/experimental/pallas/ops/tpu/flash_attention.py, the stock backward
// that warpconvnet_tpu/nn/functional/flash_attention.py `segment_attention`
// runs with SegmentIds.
//
// What bounds it on the card: the tensor cores. K9-dkv does 8 * D FLOPs per
// (query, kv) pair of one head with equal segments (S^T, dP^T, dV, dK),
// K9-dq 6 * D (S, dP, dQ), against 989 TFLOP/s of dense bf16; the bytes
// (q, k, v, dO, lse and di read once, the gradients written once) take far
// less. Beside the products, each pair costs one exp2 and a few fp32
// operations on the CUDA cores.
//
// Design: a block per (own tile, head, scene), one warpgroup (128 threads)
// per 64 own rows: three warpgroups (192 rows) at D <= 64, one at D 128
// (its sums need the registers). K9-dkv owns kv rows and walks the query
// tiles, K9-dq owns query rows and walks the kv tiles. The own tile's
// [min, max] segment range marks the visited 64-row tiles in a shared
// bitmask (segment_attention_bwd.cuh, the rule of the fp32 kernels), so
// every segment layout stays exact. The own tiles are staged once; the
// visited tiles, their segment ids and (K9-dkv) lse and di move by
// cp.async into a two-stage ring, the next loading while this one
// computes, and the block's warpgroups share each of them. Tiles lie in
// shared memory row-major, in the swizzle wgmma reads (128, 64 or 32 bytes
// by D). For each visited tile two products read both operands from shared
// memory (K9-dkv S^T = K Q^T and dP^T = V dO^T, K9-dq S = Q K^T and
// dP = dO V^T; the visited rows K-major); P is formed while dP runs, and P
// and dS go from the fp32 accumulators straight into bf16 register
// fragments, the A operand of dV += P^T dO (running while dS is formed)
// and dK += dS^T Q (K9-dkv) or dQ += dS K (K9-dq), whose B operand is the
// visited tile read MN-major. So nothing is transposed in memory and P and
// dS never touch shared memory. When every own and visited row of a tile
// pair is valid and in one segment (the block votes), the mask is skipped.
// Each block writes only its own rows: no atomics, deterministic. TMA, warp
// specialisation and fusing the two passes come later.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "hopper.cuh"
#include "segment_attention_bwd.cuh"

namespace wct::seg_bwd {
namespace {

using namespace wct::hopper;
static_assert(Tile<16>::ROWS == TILE, "wgmma tiles are the backward's tiles");

constexpr int WG = 128;               // threads of a warpgroup
constexpr size_t kMaxSmem = 232448;   // bytes a block may use on sm_90

// Rows [r0, r0 + TILE) of one head of x into the swizzled tile at dst, by
// NTH threads (this one is number i); rows past n are zero. Thread i moves
// chunk i % (D / 8) of rows i / (D / 8) + j * RSTEP, whose swizzled offsets
// differ by whole swizzle periods (RSTEP is a multiple of 8 rows).
template <int D, int NTH>
__device__ __forceinline__ void copy_tile(uint32_t dst, const bf16* x, int64_t ss, int r0, int n,
                                          int i) {
  using L = Tile<D>;
  constexpr int CPR = D / 8;          // 16-byte chunks a row
  constexpr int RSTEP = NTH / CPR;    // rows apart of a thread's chunks
  static_assert(RSTEP % 8 == 0, "chunk offsets must repeat the swizzle");
  const int row = i / CPR, col = i % CPR;
  const bf16* src = x + int64_t(r0 + row) * ss + col * 8;
  const uint32_t off = dst + L::chunk(row, col);
#pragma unroll
  for (int j = 0; j < (TILE + RSTEP - 1) / RSTEP; ++j) {
    if (TILE % RSTEP != 0 && row + j * RSTEP >= TILE) break;
    const bool ok = r0 + row + j * RSTEP < n;
    cp_async16(off + L::chunk(j * RSTEP, 0), ok ? src + int64_t(j * RSTEP) * ss : x, ok);
  }
}

// DKV: own rows are kv rows (K, V), visited rows query rows (Q, dO, lse,
// di); dV += P^T dO, dK += dS^T Q. Otherwise (dq): own rows are query rows
// (Q, dO, lse, di), visited rows kv rows (K, V); dQ += dS K. NWG
// warpgroups, each with 64 own rows, share every visited tile. Thread t of
// a warpgroup holds, in every [64 x N] accumulator, own rows
// 16 (t / 32) + (t % 32) / 4 and that + 8, columns 8 i + 2 (t % 4) + {0, 1}
// of each 8-column group i (wgmma's accumulator layout).
template <int D, bool DKV, int NWG>
__global__ void __launch_bounds__(NWG * WG, NWG == 1 ? 2 : 1) seg_attn_bwd_bf16(Args a) {
  using L = Tile<D>;
  constexpr int NT = NWG * WG;
  constexpr int OWN = NWG * TILE;             // own rows of the block
  constexpr int SLOTS = NWG > 2 ? NWG : 2;   // lse / di slots: stages, or dq's own tiles
  constexpr int NB = D > 64 ? D / 64 : 1;    // column blocks of a [64 x D] sum
  constexpr int NW = (D > 64 ? 64 : D) / 2;  // its fp32 registers a thread, per block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t tiles = (raw + 1023u) & ~1023u;
  // [own A x NWG][own B x NWG][visited A x 2][visited B x 2]: DKV K, V, Q,
  // dO; dq Q, dO, K, V.
  auto ownA = [&](int w) { return tiles + w * L::BYTES; };
  auto ownB = [&](int w) { return tiles + (NWG + w) * L::BYTES; };
  auto othA = [&](int st) { return tiles + (2 * NWG + st) * L::BYTES; };
  auto othB = [&](int st) { return tiles + (2 * NWG + 2 + st) * L::BYTES; };
  int32_t* seg_own =
      reinterpret_cast<int32_t*>(smem_raw + (tiles - raw) + (2 * NWG + 4) * L::BYTES);  // [OWN]
  int32_t* seg_oth = seg_own + OWN;                               // [2][TILE]
  float* row_lse = reinterpret_cast<float*>(seg_oth + 2 * TILE);  // [SLOTS][TILE]
  float* row_di = row_lse + SLOTS * TILE;                         // [SLOTS][TILE]
  int* range = reinterpret_cast<int*>(row_di + SLOTS * TILE);
  unsigned* bits = reinterpret_cast<unsigned*>(range + 4);

  const int t = threadIdx.x;
  const int wg = t / WG, tw = t % WG;  // warpgroup, thread in it
  const int g = tw % 32 / 4, tq = tw % 4;
  const int own0 = blockIdx.x * OWN;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_own = DKV ? a.skv : a.sq, n_oth = DKV ? a.sq : a.skv;
  const int32_t* sown = (DKV ? a.seg_kv : a.seg_q) + int64_t(b) * n_own;
  const int32_t* soth = (DKV ? a.seg_q : a.seg_kv) + int64_t(b) * n_oth;
  mark_tiles<NT, OWN>(sown, n_own, own0, soth, n_oth, a.nwords,
                      scene_visit(a.visit, b, n_own, OWN), a.visits, seg_own, bits, range);
  // A full tile pair (every own and visited row valid, one segment) needs
  // no mask: the own rows must be uniform, the visited tile is voted on.
  const int own_lo = range[0];
  const bool own_uniform = own_lo == range[1] && own0 + OWN <= n_own;

  const bf16* qb = static_cast<const bf16*>(a.q) + int64_t(b) * a.q_sb + int64_t(hh) * D;
  const bf16* kb = static_cast<const bf16*>(a.k) + int64_t(b) * a.k_sb + int64_t(hh) * D;
  const bf16* vb = static_cast<const bf16*>(a.v) + int64_t(b) * a.v_sb + int64_t(hh) * D;
  const bf16* dob = static_cast<const bf16*>(a.dout) + int64_t(b) * a.do_sb + int64_t(hh) * D;
  const float* lse_b = a.lse + (int64_t(b) * a.h + hh) * a.sq;
  const float* di_b = a.di + (int64_t(b) * a.h + hh) * a.sq;

  // Query-row lse (i < TILE) or di (TILE <= i < 2 TILE) of rows
  // [r0, r0 + TILE) into slot `slot` (zero past Sq, where the mask leaves
  // P at 0).
  auto stage_rows = [&](int r0, int slot, int i) {
    const int j = i % TILE, r = r0 + j;
    cp_async4((i < TILE ? row_lse : row_di) + slot * TILE + j,
              (i < TILE ? lse_b : di_b) + (r < a.sq ? r : 0), r < a.sq);
  };
  // Stage st <- visited tile `tile`, with its segment ids (zero past the
  // end), all by cp.async.
  auto issue = [&](int tile, int st) {
    const int o0 = tile * TILE;
    if constexpr (DKV) {
      copy_tile<D, NT>(othA(st), qb, a.q_ss, o0, a.sq, t);
      copy_tile<D, NT>(othB(st), dob, a.do_ss, o0, a.sq, t);
      if (t < 2 * TILE) stage_rows(o0, st, t);
    } else {
      copy_tile<D, NT>(othA(st), kb, a.k_ss, o0, a.skv, t);
      copy_tile<D, NT>(othB(st), vb, a.v_ss, o0, a.skv, t);
    }
    if (t < TILE)
      cp_async4(seg_oth + st * TILE + t, soth + (o0 + t < n_oth ? o0 + t : 0), o0 + t < n_oth);
    cp_async_commit();
  };

  int cur = next_tile(bits, a.nwords, -1);
  const int wg0 = own0 + wg * TILE;  // this warpgroup's first own row
  if (cur >= 0) {
    if constexpr (DKV) {
      copy_tile<D, WG>(ownA(wg), kb, a.k_ss, wg0, a.skv, tw);
      copy_tile<D, WG>(ownB(wg), vb, a.v_ss, wg0, a.skv, tw);
    } else {
      copy_tile<D, WG>(ownA(wg), qb, a.q_ss, wg0, a.sq, tw);
      copy_tile<D, WG>(ownB(wg), dob, a.do_ss, wg0, a.sq, tw);
      stage_rows(wg0, wg, tw);  // dq: the own rows' lse and di, slot wg for good
    }
    cp_async_commit();
    issue(cur, 0);
  }
  cp_async_wait_all();
  __syncthreads();

  const int rows[2] = {16 * (tw / 32) + g, 16 * (tw / 32) + g + 8};  // own rows in the warpgroup
  int my_seg[2];
  bool my_ok[2];
  float my_lse[2], my_di[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    my_seg[h] = seg_own[wg * TILE + rows[h]];
    my_ok[h] = wg0 + rows[h] < n_own;
    my_lse[h] = DKV ? 0.f : row_lse[wg * TILE + rows[h]] * LOG2E;
    my_di[h] = DKV ? 0.f : row_di[wg * TILE + rows[h]];
  }
  float acc1[NB][NW], acc0[DKV ? NB : 1][NW];  // DKV: dK, dV; dq: dQ in acc1
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < NW; ++i) acc1[cb][i] = acc0[DKV ? cb : 0][i] = 0.f;

  for (int st = 0; cur >= 0; st ^= 1) {
    // The current tile has landed; after the barrier every thread is done
    // with the other stage, which then takes the next tile while this one
    // computes. Thread t < TILE votes whether visited row t is valid and
    // in the own tile's one segment (it copied that id itself).
    const int o0 = cur * TILE;
    cp_async_wait_all();
    const bool vote = t >= TILE || (o0 + t < n_oth && seg_oth[st * TILE + t] == own_lo);
    fence_async_proxy();
    const bool full = __syncthreads_and(vote) && own_uniform;

    // DKV: S^T = K Q^T, dP^T = V dO^T; dq: S = Q K^T, dP = dO V^T; two
    // commit groups.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    hold(s);
    hold(dp);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss(s, L::k_major(ownA(wg), ks), L::k_major(othA(st), ks), ks);
    wg_commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss(dp, L::k_major(ownB(wg), ks), L::k_major(othB(st), ks), ks);
    wg_commit();

    const int nxt = next_tile(bits, a.nwords, cur);
    if (nxt >= 0) issue(nxt, st ^ 1);

    // P = exp(S - lse) over equal segments of valid rows (MASKED; a full
    // tile pair has no other), while dP runs; visited row c of register
    // 4 i + 2 h + e is 8 i + 2 tq + e.
    wg_wait<1>();
    hold(s);
    auto form_p = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = st * TILE + 8 * i + 2 * tq + e;
          const float c_lse = DKV ? row_lse[c] * LOG2E : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = 4 * i + 2 * h + e;
            const float arg = fmaf(s[x], a.scale_log2, -(DKV ? c_lse : my_lse[h]));
            if constexpr (decltype(masked)::value)
              s[x] = my_ok[h] && o0 + 8 * i + 2 * tq + e < n_oth && seg_oth[c] == my_seg[h]
                         ? exp2_ftz(arg) : 0.f;
            else
              s[x] = exp2_ftz(arg);
          }
        }
    };
    if (full)
      form_p(std::false_type{});
    else
      form_p(std::true_type{});
    // P and dS rounded to bf16 as A fragments: the registers of 8-column
    // groups 2 kk and 2 kk + 1 are k-step kk's fragment.
    uint32_t pa[4][4], da[4][4];
    if constexpr (DKV) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int cb = 0; cb < NB; ++cb)
          wgmma_rs(acc0[cb], pa[kk], L::mn_major(othB(st), kk, cb));  // dV += P^T dO
      wg_commit();
      wg_wait<1>();  // dP done; dV runs on while dS is formed
    } else {
      wg_wait<0>();
    }
    hold(dp);

    // dS = scale * P * (dP - di).
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float c_di = DKV ? row_di[st * TILE + 8 * i + 2 * tq + e] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = 4 * i + 2 * h + e;
          dp[x] = s[x] * (dp[x] - (DKV ? c_di : my_di[h])) * a.scale;
        }
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) da[kk][j] = pack_bf16(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int cb = 0; cb < NB; ++cb)
        wgmma_rs(acc1[cb], da[kk], L::mn_major(othA(st), kk, cb));  // dK += dS^T Q; dQ += dS K
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      hold(acc1[cb]);
      if constexpr (DKV) hold(acc0[cb]);
    }
    cur = nxt;
  }

  // Own rows of the gradients, bf16 from the fp32 sums.
  auto write = [&](void* out, const float (&acc)[NB][NW], int n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg0 + rows[h];
      if (r >= n) continue;
      bf16* row = static_cast<bf16*>(out) + ((int64_t(b) * n + r) * a.h + hh) * D;
#pragma unroll
      for (int cb = 0; cb < NB; ++cb)
#pragma unroll
        for (int i = 0; i < NW / 4; ++i)
          *reinterpret_cast<__nv_bfloat162*>(row + 64 * cb + 8 * i + 2 * tq) =
              __floats2bfloat162_rn(acc[cb][4 * i + 2 * h], acc[cb][4 * i + 2 * h + 1]);
    }
  };
  if constexpr (DKV) {
    write(a.dk, acc1, a.skv);
    write(a.dv, acc0, a.skv);
  } else {
    write(a.dq, acc1, a.sq);
  }
}

template <int D, bool DKV>
int launch(const Args& a, int b, cudaStream_t stream) {
  // Three warpgroups a block share each visited tile (a third of the
  // copies a warpgroup alone would make) at up to 170 registers a thread;
  // D 128 needs more registers and takes one.
  constexpr int NWG = D <= 64 ? 3 : 1;
  constexpr int SLOTS = NWG > 2 ? NWG : 2;
  // 1024 bytes to align the tiles, the tiles, then seg_own, seg_oth,
  // row_lse, row_di, range (padded to 4) and the bitmask.
  const size_t bytes = 1024 + (2 * NWG + 4) * size_t(Tile<D>::BYTES) +
                       ((NWG + 2 + 2 * SLOTS) * TILE + 4 + size_t(a.nwords)) * sizeof(int);
  if (bytes > kMaxSmem) return int(cudaErrorInvalidValue);
  auto kernel = seg_attn_bwd_bf16<D, DKV, NWG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(bytes));
  if (err != cudaSuccess) return int(err);
  const int n_own = DKV ? a.skv : a.sq, n_oth = DKV ? a.sq : a.skv;
  const int rc = launch_visit(DKV ? a.seg_kv : a.seg_q, n_own, DKV ? a.seg_q : a.seg_kv, n_oth, b,
                              NWG * TILE, a.visit, stream);
  if (rc != 0) return rc;
  const dim3 grid((n_own + NWG * TILE - 1) / (NWG * TILE), a.h, b);
  kernel<<<grid, NWG * WG, bytes, stream>>>(a);
  return int(cudaGetLastError());
}

template <bool DKV>
int launch_dir(const Args& a, int b, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16, DKV>(a, b, stream);
    case 32: return launch<32, DKV>(a, b, stream);
    case 64: return launch<64, DKV>(a, b, stream);
    case 128: return launch<128, DKV>(a, b, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

int launch_bf16(const Args& a, int b, int d, bool dkv, cudaStream_t stream) {
  return dkv ? launch_dir<true>(a, b, d, stream) : launch_dir<false>(a, b, d, stream);
}

}  // namespace wct::seg_bwd
