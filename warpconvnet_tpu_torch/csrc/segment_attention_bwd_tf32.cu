// Segment-masked attention backward on fp32 inputs: K9-dkv and K9-dq on
// Hopper's TF32 tensor cores with 3xTF32 split products (wgmma, sm_90a).
//
// The function is segment_attention_bwd.cu's: with S = scale * Q K^T over
// the pairs of equal segments, P = exp(S - lse) (lse from K9's forward,
// +inf on rows that match nothing, so their P is exactly 0) and
// di = rowsum(O * dO),
//   dV = P^T dO,  dP = dO V^T,  dS = scale * P * (dP - di),
//   dQ = dS K,  dK = dS^T Q,
// per (scene, head), fp32 in and out. Inputs as in segment_attention_bwd.cu
// (strided q, k, v, dO rows; fp32 lse and di [B, H, Sq]); the gradients
// are contiguous.
//
// Replaces: `_flash_attention_dkv_kernel` (:796) and
// `_flash_attention_dq_kernel` (:1146) of jax 0.9.0's
// jax/experimental/pallas/ops/tpu/flash_attention.py, the stock backward
// that warpconvnet_tpu/nn/functional/flash_attention.py `segment_attention`
// runs with SegmentIds, here for the fp32 trunk.
//
// Arithmetic (3xTF32): every fp32 operand x enters the products as two
// TF32 values, hi = tf32(x) and lo = tf32(x - hi) (cvt.rna: to nearest,
// ties away from zero), and every product a b as
// a_lo b_hi + a_hi b_lo + a_hi b_hi on the TF32 tensor cores with fp32
// sums, the small terms first. The dropped a_lo b_lo and the rounding of
// lo are about 2^-22 of |a b|: fp32-class error, where one TF32 product
// (a_hi b_hi alone) errs by about 2^-11. kernels/segment_attention.py's
// `tf32_split` and `tf32_matmul` emulate it for the tests. The tensor
// cores' own fp32 sums drift over long runs, so they sum only one step's
// products (3 D or 3 VIS terms); the gradients' sums over the whole walk
// are fp32 adds on the CUDA cores.
//
// What bounds it on the card: the tensor cores. K9-dkv does 8 * D FLOPs
// per (query, kv) pair of one head with equal segments (S^T, dP^T, dV,
// dK), K9-dq 6 * D (S, dP, dQ), each three times, against 494.7 TFLOP/s
// of dense TF32: 165 TFLOP/s of fp32-accurate work, 2.46x the CUDA cores'
// fp32 FMA rate. Shared-memory reads of the operands come close to it: an
// m64n32k8 product whose operands both lie in shared memory reads 3 KiB
// for 16 cycles of tensor work.
//
// Design: a block per (own tile, head, scene) with NWG warpgroups of 64
// own rows each (two at D <= 64, one at D 128), K9-dkv owning kv rows
// and walking the query tiles, K9-dq owning query rows and walking the kv
// tiles. The own tile's [min, max] segment range marks the visited 64-row
// tiles in a shared bitmask (segment_attention_bwd.cuh), so every segment
// layout stays exact; a visited tile is taken VIS rows at a time (32, 16
// at D 128: the budget of shared memory). Each operand is split once,
// where it is staged: the own tiles once, row-major; each visited step,
// prefetched into registers while the previous one computes, as hi and lo
// tiles row-major (the K-major B operand of S and dP) and, for the
// operands of the second products, again transposed (tf32 wgmma reads
// both operands K-major only): dO^T and Q^T in K9-dkv, K^T in K9-dq. In a
// transposed tile the visited rows of each group of 8 lie in the order
// 0 2 4 6 1 3 5 7, so that an fp32 accumulator's columns (2t, 2t + 1) of
// lane t are the k columns (t, t + 4) of a tf32 A fragment: P and scale *
// dS go from the accumulators of S and dP, split in registers, straight
// into the A operands of dV += P^T dO and dK += dS^T Q (K9-dkv) or
// dQ += dS K (K9-dq), and never touch shared memory. Both warpgroups
// share each visited step. When every own and visited row of a step is
// valid and in one segment (the block votes), the mask is skipped. Each
// block writes only its own rows: no atomics, deterministic. Shared memory
// at D 64: 128 KiB own tiles, 64 KiB (K9-dkv) or 48 KiB (K9-dq) visited;
// one stage. TMA, a second stage and fusing the two passes come later.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "hopper.cuh"
#include "segment_attention_bwd.cuh"

namespace wct::seg_bwd {
namespace {

using namespace wct::hopper;

constexpr int WG = 128;               // threads of a warpgroup
constexpr size_t kMaxSmem = 232448;   // bytes a block may use on sm_90

__device__ __forceinline__ void st_shared4(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]) : "memory");
}

__device__ __forceinline__ float4 load4(const float* p, bool ok) {
  return ok ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Split the four values of v into hi and lo words.
__device__ __forceinline__ void split4(const float4& v, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32<false>(v.x, hi[0], lo[0]);
  split_tf32<false>(v.y, hi[1], lo[1]);
  split_tf32<false>(v.z, hi[2], lo[2]);
  split_tf32<false>(v.w, hi[3], lo[3]);
}

template <int D>
struct Cfg {
  static constexpr int NWG = D > 64 ? 1 : 2;   // warpgroups a block, 64 own rows each
  static constexpr int VIS = D > 64 ? 16 : 32;  // visited rows a step
  static constexpr int NT = NWG * WG;
  static constexpr int OWN = NWG * TILE;
  using Own = Tile<D, 4>;        // [64][D]: own rows, K-major A of S and dP
  using Row = Tile<D, 4, VIS>;   // [VIS][D]: visited rows, K-major B of S and dP
  using Tr = Tile<VIS, 4, D>;    // [D][VIS]: visited rows transposed, K-major B of the rest
  static_assert(Row::BYTES == Tr::BYTES && Row::BYTES % 1024 == 0 && Own::BYTES % 1024 == 0,
                "tiles keep 1024-byte alignment");
  // Visited 4 x 4 blocks a thread stages a step (two operands).
  static constexpr int BLOCKS = VIS * D / 16;  // of one operand
  static constexpr int PER = (2 * BLOCKS + NT - 1) / NT;

  // 1024 bytes to align the tiles; own tiles (NWG x 2 operands x hi, lo);
  // visited row-major (2 operands x hi, lo) and transposed (DKV 2
  // operands, dq 1, x hi, lo); then seg_own, seg_oth, row_lse, row_di
  // (visited rows in DKV), range (padded to 4) and the bitmask.
  static size_t smem_bytes(bool dkv, int nwords) {
    return 1024 + size_t(NWG) * 4 * Own::BYTES + (dkv ? 8 : 6) * size_t(Row::BYTES) +
           (OWN + VIS + (dkv ? 2 * VIS : 0) + 4 + size_t(nwords)) * sizeof(int);
  }
};

// DKV: own rows are kv rows (K, V), visited rows query rows (Q, dO, lse,
// di); dV += P^T dO, dK += dS^T Q. Otherwise (dq): own rows are query rows
// (Q, dO, lse, di), visited rows kv rows (K, V); dQ += dS K. Thread t of a
// warpgroup holds, in every [64 x N] accumulator, own rows
// 16 (t / 32) + (t % 32) / 4 and that + 8, columns 8 i + 2 (t % 4) + {0, 1}
// of each 8-column group i (wgmma's accumulator layout).
template <int D, bool DKV>
__global__ void __launch_bounds__(Cfg<D>::NT, 1) seg_attn_bwd_tf32(Args a) {
  using C = Cfg<D>;
  using Own = typename C::Own;
  using Row = typename C::Row;
  using Tr = typename C::Tr;
  constexpr int NWG = C::NWG, VIS = C::VIS, NT = C::NT, OWN = C::OWN;
  constexpr int SUBS = TILE / VIS;            // steps a visited tile
  constexpr int NB = D > 64 ? D / 64 : 1;     // 64-row blocks of the [D][VIS] tiles (N of a sum)
  constexpr int NW = (D > 64 ? 64 : D) / 2;   // a sum's fp32 registers a thread, per block
  constexpr int KS = VIS / 8;                 // k-steps of the second products
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t tiles = (raw + 1023u) & ~1023u;
  // op 0: DKV K / dq Q, op 1: DKV V / dq dO; part 0 hi, 1 lo.
  auto own_t = [&](int w, int op, int part) {
    return tiles + ((w * 2 + op) * 2 + part) * Own::BYTES;
  };
  const uint32_t vis0 = tiles + NWG * 4 * Own::BYTES;
  // op 0: DKV Q / dq K, op 1: DKV dO / dq V.
  auto row_t = [&](int op, int part) { return vis0 + (op * 2 + part) * Row::BYTES; };
  // op 0: DKV Q^T / dq K^T, op 1: DKV dO^T.
  auto tr_t = [&](int op, int part) { return vis0 + (4 + op * 2 + part) * Row::BYTES; };
  int32_t* seg_own = reinterpret_cast<int32_t*>(
      smem_raw + (tiles - raw) + NWG * 4 * Own::BYTES + (DKV ? 8 : 6) * Row::BYTES);  // [OWN]
  int32_t* seg_oth = seg_own + OWN;                           // [VIS]
  float* row_lse = reinterpret_cast<float*>(seg_oth + VIS);   // [VIS], DKV: lse * log2(e)
  float* row_di = row_lse + (DKV ? VIS : 0);                  // [VIS], DKV
  int* range = reinterpret_cast<int*>(row_di + (DKV ? VIS : 0));
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
  mark_tiles<NT, OWN>(sown, n_own, own0, soth, n_oth, a.nwords, seg_own, bits, range);
  // A full step (every own and visited row valid, one segment) needs no
  // mask: the own rows must be uniform, the visited rows are voted on.
  const int own_lo = range[0];
  const bool own_uniform = own_lo == range[1] && own0 + OWN <= n_own;

  const float* qb = static_cast<const float*>(a.q) + int64_t(b) * a.q_sb + int64_t(hh) * D;
  const float* kb = static_cast<const float*>(a.k) + int64_t(b) * a.k_sb + int64_t(hh) * D;
  const float* vb = static_cast<const float*>(a.v) + int64_t(b) * a.v_sb + int64_t(hh) * D;
  const float* dob = static_cast<const float*>(a.dout) + int64_t(b) * a.do_sb + int64_t(hh) * D;
  const float* lse_b = a.lse + (int64_t(b) * a.h + hh) * a.sq;
  const float* di_b = a.di + (int64_t(b) * a.h + hh) * a.sq;
  // The visited operands: op 0 DKV Q / dq K, op 1 DKV dO / dq V.
  const float* oth_x0 = DKV ? qb : kb;
  const float* oth_x1 = DKV ? dob : vb;
  const int64_t oth_ss0 = DKV ? a.q_ss : a.k_ss, oth_ss1 = DKV ? a.do_ss : a.v_ss;

  // Visited steps: step v is rows [v VIS, v VIS + VIS), in the bitmask's
  // tile v / SUBS; steps wholly past the end are skipped.
  auto next_step = [&](int v) {
    if (v >= 0 && (v + 1) % SUBS != 0 && (v + 1) * VIS < n_oth) return v + 1;
    const int tile = next_tile(bits, a.nwords, v < 0 ? -1 : v / SUBS);
    return tile < 0 ? -1 : tile * SUBS;
  };

  // Step v into registers: thread t takes, of operand op, the 4 x 4 block
  // of rows 8 m + s + 2 j (j = 0..3) and columns 4 c .. 4 c + 3; threads
  // t < VIS also row t's segment id (and, DKV, lse and di).
  float4 pre[C::PER][4];
  int pre_seg = 0;
  float pre_lse = 0.f, pre_di = 0.f;
  // Which block thread index blk stages. At VIS 32 and D >= 32 the eight
  // lanes of each 128-byte store phase take the blocks (c, m, s) with
  // c % 8 ^ s and (2 m + s) ^ 4 (c % 2) all distinct, so that their
  // 16-byte stores hit distinct banks in both the row-major and the
  // transposed tile (in row order, four lanes would share a bank in the
  // transposed one); a warp's loads still fill whole 32-byte sectors.
  auto block_of = [&](int blk, int& op, int& m, int& s, int& c) {
    op = blk / C::BLOCKS;
    const int rem = blk % C::BLOCKS;
    if constexpr (VIS == 32 && D >= 32) {
      const int l = rem & 7, p = rem >> 3;
      s = (l >> 1) & 1;
      m = 2 * (l >> 2) + (l & 1);
      c = (p >> 3) * 8 + ((l ^ s) ^ (p & 7));
    } else {
      c = rem % (D / 4);
      m = rem / (D / 4) / 2;
      s = rem / (D / 4) % 2;
    }
  };
  auto prefetch = [&](int v) {
    const int r0 = v * VIS;
#pragma unroll
    for (int i = 0; i < C::PER; ++i) {
      const int blk = t + i * NT;
      if (blk >= 2 * C::BLOCKS) break;
      int op, m, s, c;
      block_of(blk, op, m, s, c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + 8 * m + s + 2 * j;
        const bool ok = r < n_oth;
        const float* x = op ? oth_x1 : oth_x0;
        pre[i][j] = load4(x + int64_t(ok ? r : 0) * (op ? oth_ss1 : oth_ss0) + 4 * c, ok);
      }
    }
    if (t < VIS) {
      const int r = r0 + t;
      pre_seg = r < n_oth ? soth[r] : 0;
      if constexpr (DKV) {
        pre_lse = r < a.sq ? lse_b[r] * LOG2E : INFINITY;
        pre_di = r < a.sq ? di_b[r] : 0.f;
      }
    }
  };
  // The prefetched step, split, into the visited tiles.
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < C::PER; ++i) {
      const int blk = t + i * NT;
      if (blk >= 2 * C::BLOCKS) break;
      int op, m, s, c;
      block_of(blk, op, m, s, c);
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split4(pre[i][j], hi[j], lo[j]);
        st_shared4(row_t(op, 0) + Row::chunk(8 * m + s + 2 * j, c), hi[j]);
        st_shared4(row_t(op, 1) + Row::chunk(8 * m + s + 2 * j, c), lo[j]);
      }
      if (DKV || op == 0) {
        // Column 4 c + e, visited positions 8 m + 4 s + j hold rows
        // 8 m + s + 2 j: the 0 2 4 6 1 3 5 7 order.
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t h4[4] = {hi[0][e], hi[1][e], hi[2][e], hi[3][e]};
          const uint32_t l4[4] = {lo[0][e], lo[1][e], lo[2][e], lo[3][e]};
          st_shared4(tr_t(op, 0) + Tr::chunk(4 * c + e, 2 * m + s), h4);
          st_shared4(tr_t(op, 1) + Tr::chunk(4 * c + e, 2 * m + s), l4);
        }
      }
    }
    if (t < VIS) {
      seg_oth[t] = pre_seg;
      if constexpr (DKV) {
        row_lse[t] = pre_lse;
        row_di[t] = pre_di;
      }
    }
  };

  const int rows[2] = {16 * (tw / 32) + g, 16 * (tw / 32) + g + 8};  // own rows in the warpgroup
  const int wg0 = own0 + wg * TILE;  // this warpgroup's first own row
  int my_seg[2];
  bool my_ok[2];
  float my_lse[2], my_di[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg0 + rows[h];
    my_seg[h] = seg_own[wg * TILE + rows[h]];
    my_ok[h] = r < n_own;
    my_lse[h] = !DKV && my_ok[h] ? lse_b[r] * LOG2E : 0.f;
    my_di[h] = !DKV && my_ok[h] ? di_b[r] : 0.f;
  }
  float acc1[NB][NW], acc0[DKV ? NB : 1][NW];  // DKV: dK, dV; dq: dQ in acc1
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < NW; ++i) acc1[cb][i] = acc0[DKV ? cb : 0][i] = 0.f;

  int cur = next_step(-1);
  if (cur >= 0) {
    prefetch(cur);
    // This warpgroup's own rows, split, row-major.
    const float* own_x[2] = {DKV ? kb : qb, DKV ? vb : dob};
    const int64_t own_ss[2] = {DKV ? a.k_ss : a.q_ss, DKV ? a.v_ss : a.do_ss};
#pragma unroll
    for (int op = 0; op < 2; ++op)
#pragma unroll 4
      for (int idx = tw; idx < TILE * D / 4; idx += WG) {
        const int r = idx / (D / 4), c = idx % (D / 4);
        const bool ok = wg0 + r < n_own;
        uint32_t hi[4], lo[4];
        split4(load4(own_x[op] + int64_t(ok ? wg0 + r : 0) * own_ss[op] + 4 * c, ok), hi, lo);
        st_shared4(own_t(wg, op, 0) + Own::chunk(r, c), hi);
        st_shared4(own_t(wg, op, 1) + Own::chunk(r, c), lo);
      }
  }

  while (cur >= 0) {
    const int o0 = cur * VIS;
    store();
    // Thread t < VIS votes whether visited row t is valid and in the own
    // rows' one segment.
    const bool vote = t >= VIS || (o0 + t < n_oth && pre_seg == own_lo);
    fence_async_proxy();
    const bool full = __syncthreads_and(vote) && own_uniform;
    const int nxt = next_step(cur);
    if (nxt >= 0) prefetch(nxt);

    // DKV: S^T = K Q^T, dP^T = V dO^T; dq: S = Q K^T, dP = dO V^T; two
    // commit groups, each product as lo hi + hi lo + hi hi.
    float s[VIS / 2], dp[VIS / 2];
#pragma unroll
    for (int i = 0; i < VIS / 2; ++i) s[i] = dp[i] = 0.f;
    hold(s);
    hold(dp);
    wg_fence();
    auto product = [&](float (&d)[VIS / 2], int op) {
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        const uint64_t ah = Own::k_major(own_t(wg, op, 0), ks);
        const uint64_t al = Own::k_major(own_t(wg, op, 1), ks);
        const uint64_t bh = Row::k_major(row_t(op, 0), ks);
        const uint64_t bl = Row::k_major(row_t(op, 1), ks);
        wgmma_tf32_ss(d, al, bh, 1);
        wgmma_tf32_ss(d, ah, bl, 1);
        wgmma_tf32_ss(d, ah, bh, 1);
      }
      wg_commit();
    };
    product(s, 0);
    product(dp, 1);

    // P = exp(S - lse) over equal segments of valid rows (MASKED; a full
    // step has no other), while dP runs; visited row c of register
    // 4 i + 2 h + e is 8 i + 2 tq + e.
    wg_wait<1>();
    hold(s);
    auto form_p = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < VIS / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * i + 2 * tq + e;
          const float c_lse = DKV ? row_lse[c] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = 4 * i + 2 * h + e;
            const float arg = fmaf(s[x], a.scale_log2, -(DKV ? c_lse : my_lse[h]));
            if constexpr (decltype(masked)::value)
              s[x] = my_ok[h] && o0 + c < n_oth && seg_oth[c] == my_seg[h] ? exp2_ftz(arg) : 0.f;
            else
              s[x] = exp2_ftz(arg);
          }
        }
    };
    if (full)
      form_p(std::false_type{});
    else
      form_p(std::true_type{});

    // Split v (P or scale * dS) into A fragments: k-step kk takes the
    // 8-column group kk, its columns 2 tq and 2 tq + 1 at the fragment's
    // k columns tq and tq + 4 (the transposed tiles' row order).
    auto split_frags = [&](const float (&v)[VIS / 2], uint32_t (&hi)[KS][4],
                           uint32_t (&lo)[KS][4]) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        split_tf32<true>(v[4 * kk], hi[kk][0], lo[kk][0]);
        split_tf32<true>(v[4 * kk + 2], hi[kk][1], lo[kk][1]);
        split_tf32<true>(v[4 * kk + 1], hi[kk][2], lo[kk][2]);
        split_tf32<true>(v[4 * kk + 3], hi[kk][3], lo[kk][3]);
      }
    };
    // The step's share of a gradient goes into `part` (one commit group):
    // A B over the step's VIS rows, B the transposed tile op, rows
    // [64 cb, 64 cb + 64). The tensor cores' fp32 sums drift when left to
    // add a whole walk: so summed over the 38.6k rows of the Volt-s trunk,
    // dq, dk and dv were 1.9e-4 off a float64 backward (the plain fp32
    // backward: 4.2e-6). So each step's product starts from zero, and
    // `add` folds it into the gradient on the CUDA cores.
    float part[NW];
    auto second = [&](const uint32_t (&hi)[KS][4], const uint32_t (&lo)[KS][4], int op,
                      int cb) {
#pragma unroll
      for (int i = 0; i < NW; ++i) part[i] = 0.f;
      hold(part);
      wg_fence();
      const uint32_t bh = tr_t(op, 0) + cb * 64 * Tr::ROWB;
      const uint32_t bl = tr_t(op, 1) + cb * 64 * Tr::ROWB;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        wgmma_tf32_rs(part, lo[kk], Tr::k_major(bh, kk));
        wgmma_tf32_rs(part, hi[kk], Tr::k_major(bl, kk));
        wgmma_tf32_rs(part, hi[kk], Tr::k_major(bh, kk));
      }
      wg_commit();
    };
    auto add = [&](float (&acc)[NW]) {  // after the wait for `part`'s group
      hold(part);
#pragma unroll
      for (int i = 0; i < NW; ++i) acc[i] += part[i];
    };
    uint32_t pa_hi[KS][4], pa_lo[KS][4], da_hi[KS][4], da_lo[KS][4];
    if constexpr (DKV) {
      split_frags(s, pa_hi, pa_lo);
      if constexpr (NB == 1) {
        second(pa_hi, pa_lo, 1, 0);  // dV += P^T dO
        wg_wait<1>();  // dP done; dV runs on while dS is formed
      } else {
        wg_wait<0>();
      }
    } else {
      wg_wait<0>();
    }
    hold(dp);

    // dS = scale * P * (dP - di).
#pragma unroll
    for (int i = 0; i < VIS / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float c_di = DKV ? row_di[8 * i + 2 * tq + e] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = 4 * i + 2 * h + e;
          dp[x] = s[x] * (dp[x] - (DKV ? c_di : my_di[h])) * a.scale;
        }
      }
    split_frags(dp, da_hi, da_lo);
    if constexpr (DKV) {
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) {
        if constexpr (NB > 1) second(pa_hi, pa_lo, 1, cb);
        wg_wait<0>();
        add(acc0[cb]);
      }
    }
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      second(da_hi, da_lo, 0, cb);  // dK += dS^T Q; dQ += dS K
      wg_wait<0>();
      add(acc1[cb]);
    }
    __syncthreads();  // the next step overwrites the visited tiles
    cur = nxt;
  }

  // Own rows of the gradients.
  auto write = [&](void* out, const float (&acc)[NB][NW], int n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg0 + rows[h];
      if (r >= n) continue;
      float* row = static_cast<float*>(out) + ((int64_t(b) * n + r) * a.h + hh) * D;
#pragma unroll
      for (int cb = 0; cb < NB; ++cb)
#pragma unroll
        for (int i = 0; i < NW / 4; ++i)
          *reinterpret_cast<float2*>(row + 64 * cb + 8 * i + 2 * tq) =
              make_float2(acc[cb][4 * i + 2 * h], acc[cb][4 * i + 2 * h + 1]);
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
  using C = Cfg<D>;
  const size_t bytes = C::smem_bytes(DKV, a.nwords);
  if (bytes > kMaxSmem) return int(cudaErrorInvalidValue);
  auto kernel = seg_attn_bwd_tf32<D, DKV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(bytes));
  if (err != cudaSuccess) return int(err);
  const int n_own = DKV ? a.skv : a.sq;
  const dim3 grid((n_own + C::OWN - 1) / C::OWN, a.h, b);
  kernel<<<grid, C::NT, bytes, stream>>>(a);
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

int launch_tf32(const Args& a, int b, int d, bool dkv, cudaStream_t stream) {
  return dkv ? launch_dir<true>(a, b, d, stream) : launch_dir<false>(a, b, d, stream);
}

}  // namespace wct::seg_bwd
