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
// Design: K9-dkv owns kv rows and walks the query tiles, K9-dq owns query
// rows and walks the kv tiles, in two launches a pass (a pass: one scene
// and as many of its heads as the caller's scratch holds). First a
// pre-pass (seg_attn_bwd_split_tf32) splits every visited row of the pass
// once, for all own blocks, into TF32 hi and lo and writes them as the byte
// image of the kernel's shared-memory units: per (head, visited step of VIS
// rows) one contiguous block of the two visited operands' hi and lo tiles
// row-major (the K-major B operand of S and dP), then the hi and lo tiles
// transposed of the operands of the second products (tf32 wgmma reads both
// operands K-major only: dO^T and Q^T in K9-dkv, K^T in K9-dq), swizzled as
// wgmma reads them, then the step's segment ids and, K9-dkv, lse log2(e)
// and di. In a transposed tile the visited rows of each group of 8 lie in
// the order 0 2 4 6 1 3 5 7, so that an fp32 accumulator's columns
// (2t, 2t + 1) of lane t are the k columns (t, t + 4) of a tf32 A
// fragment: P and scale * dS go from the accumulators of S and dP, split
// in registers, straight into the A operands of dV += P^T dO and
// dK += dS^T Q (K9-dkv) or dQ += dS K (K9-dq), and never touch shared
// memory. Then the kernel: a block per (own tile, head) of NWG consumer
// warpgroups of 64 own rows each (two at D <= 64, one at D 128), which
// split their own rows once, row-major, and a producer warpgroup (in
// K9-dq at D 16 a warp, so that two blocks share an SM). The own
// tile's [min, max] segment range marks the visited 64-row tiles in a
// shared bitmask (segment_attention_bwd.cuh), so every segment layout stays
// exact; a visited tile is taken VIS rows at a time (32; 16 at D 128). One
// thread of the producer copies each visited step into the ring
// as two units, its row-major tiles with the ids (and lse, di), then its
// transposed tiles, each by bulk copies (TMA, no tensor map) that complete
// on a slot's full mbarrier; the rest of it leaves at once, so at D 32
// and 64 it hands all but 40 registers a thread to the consumers
// (setmaxnreg). A consumer frees a step's row-major unit once S and dP are
// read (half a step early) and its transposed unit after the second
// products, on the slot's empty mbarrier: units, not whole steps, so that
// three slots of 32 KiB (D 64: 128 KiB of own tiles beside them) keep one
// unit in flight while the other two are read. With only mbarriers between
// them (no block barrier in the walk), the consumers drift apart and one's
// products run while the other's exp2 and splits run. When every own and
// visited row of a step is valid and in one segment (a warp's vote), the
// mask is skipped. Each block writes only its own rows: no atomics,
// deterministic. Scratch: (8 D + 3) VIS * 4 bytes a K9-dkv step and head,
// (6 D + 1) VIS * 4 a K9-dq one. At D 128 (one warpgroup, 255 registers a
// thread) K9-dkv spills; no main path runs it.
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
constexpr int SPLIT_NT = 256;         // threads of a pre-pass block
constexpr size_t kMaxSmem = 232448;   // bytes a block may use on sm_90

template <int D>
struct Cfg {
  static constexpr int NWG = D > 64 ? 1 : 2;    // consumer warpgroups, 64 own rows each
  static constexpr int VIS = D > 64 ? 16 : 32;  // visited rows a step
  // The producer: a warpgroup, or in K9-dq at D 16 a warp, so that two
  // blocks fit an SM (80 registers a thread). Chosen while every block at
  // PTv3's patch shapes scanned all of its scene's segment ids (two blocks
  // scanned with more threads; K9-dkv spills at 80 registers and scanned
  // faster with the warpgroup than with a warp).
  __host__ __device__ static constexpr bool paired(bool dkv) { return D <= 16 && !dkv; }
  __host__ __device__ static constexpr int nt(bool dkv) {  // the consumers, then the producer
    return NWG * WG + (paired(dkv) ? 32 : WG);
  }
  __host__ __device__ static constexpr int min_blocks(bool dkv) { return paired(dkv) ? 2 : 1; }
  static constexpr int OWN = NWG * TILE;
  using Own = Tile<D, 4>;        // [64][D]: own rows, K-major A of S and dP
  using Row = Tile<D, 4, VIS>;   // [VIS][D]: visited rows, K-major B of S and dP
  using Tr = Tile<VIS, 4, D>;    // [D][VIS]: visited rows transposed, K-major B of the rest
  static_assert(Row::BYTES == Tr::BYTES && Row::BYTES % 1024 == 0 && Own::BYTES % 1024 == 0,
                "tiles keep 1024-byte alignment");
  static_assert(VIS <= 32, "a warp votes on a step's visited rows");
  // Registers a thread (setmaxnreg, at two consumers and a producer
  // warpgroup): the launch gives each 168; the producer's one copying
  // thread needs few: 128 x 40 + 256 x 232 = 384 x 168.
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  // A step's image, in the scratch: the row-major unit (op 0 hi, lo, op 1
  // hi, lo), the transposed unit (DKV op 0 hi, lo, op 1 hi, lo; dq op 0
  // hi, lo), then the extras: VIS segment ids and, DKV, VIS lse log2(e)
  // and VIS di. A ring slot holds either unit (and a row-major one's
  // extras beside it).
  static constexpr uint32_t ROWS = 4 * Row::BYTES;
  __host__ __device__ static constexpr uint32_t trs(bool dkv) {
    return (dkv ? 4 : 2) * Row::BYTES;
  }
  __host__ __device__ static constexpr uint32_t extras(bool dkv) {
    return (dkv ? 3 : 1) * VIS * 4;
  }
  __host__ __device__ static constexpr uint32_t step_bytes(bool dkv) {
    return ROWS + trs(dkv) + extras(dkv);
  }
  // Ring slots: three at D >= 64, as many as fit beside the own tiles
  // (two where a long walk's bitmask leaves no room for the third); six
  // below.
  static constexpr int SLOTS = D >= 64 ? 3 : 6;

  // 1024 bytes to align the tiles; own tiles (NWG x 2 operands x hi, lo);
  // the slots' tiles, then their extras; each slot's full and empty
  // mbarriers; then seg_own, range (padded to 4) and the bitmask.
  static size_t smem_bytes(bool dkv, int slots, int nwords) {
    return 1024 + size_t(NWG) * 4 * Own::BYTES + slots * (size_t(ROWS) + extras(dkv)) +
           2 * slots * sizeof(uint64_t) + (OWN + 4 + size_t(nwords)) * sizeof(int);
  }
  // Scratch of a pass of nh heads over `rows` visited rows: [nh][steps].
  __host__ __device__ static int64_t steps(int rows) { return (int64_t(rows) + VIS - 1) / VIS; }
  static int64_t scratch_bytes(int nh, int rows, bool dkv) {
    return int64_t(nh) * steps(rows) * step_bytes(dkv);
  }
};

// The pre-pass: block (v, y) splits visited step v of head h0 + y of scene
// b into its image (rows past the end zero, their ids 0, DKV their lse
// +inf and di 0). Row-major chunk (r, c), 4 columns of row r, goes straight
// through, c fastest across threads; the transposed operands' rows pass
// through shared memory (rows padded by a float against bank conflicts),
// whence chunk (d, c), visited positions 4 c .. 4 c + 3 of column d (rows
// 8 (c / 2) + c % 2 + 2 j), is taken with the chunks of a 128-byte row
// fastest, so that a warp's loads and stores both cover whole lines.
template <int D, bool DKV>
__global__ void __launch_bounds__(SPLIT_NT)
    seg_attn_bwd_split_tf32(Args a, int b, int h0, unsigned char* split) {
  using C = Cfg<D>;
  using Row = typename C::Row;
  using Tr = typename C::Tr;
  constexpr int VIS = C::VIS;
  constexpr int NTR = DKV ? 2 : 1;  // operands also stored transposed
  __shared__ float sv[NTR][VIS][D + 1];
  const int v = blockIdx.x, hh = h0 + blockIdx.y;
  const int64_t nsteps = gridDim.x;
  unsigned char* img = split + (int64_t(blockIdx.y) * nsteps + v) * C::step_bytes(DKV);
  const int n_oth = DKV ? a.sq : a.skv;
  // The visited operands: op 0 DKV Q / dq K, op 1 DKV dO / dq V.
  const float* x[2] = {
      static_cast<const float*>(DKV ? a.q : a.k) + int64_t(b) * (DKV ? a.q_sb : a.k_sb) +
          int64_t(hh) * D,
      static_cast<const float*>(DKV ? a.dout : a.v) + int64_t(b) * (DKV ? a.do_sb : a.v_sb) +
          int64_t(hh) * D};
  const int64_t ss[2] = {DKV ? a.q_ss : a.k_ss, DKV ? a.do_ss : a.v_ss};
  const int r0 = v * VIS;
  for (int idx = threadIdx.x; idx < VIS * D / 4; idx += SPLIT_NT) {
    const int r = idx / (D / 4), c = idx % (D / 4);
    const bool ok = r0 + r < n_oth;
#pragma unroll
    for (int op = 0; op < 2; ++op) {
      const float4 val = load4(x[op] + int64_t(ok ? r0 + r : 0) * ss[op] + 4 * c, ok);
      uint32_t hi[4], lo[4];
      split4(val, hi, lo);
      st_global4(img + 2 * op * Row::BYTES + Row::chunk(r, c), hi);
      st_global4(img + (2 * op + 1) * Row::BYTES + Row::chunk(r, c), lo);
      if (op < NTR) {
        sv[op][r][4 * c] = val.x;
        sv[op][r][4 * c + 1] = val.y;
        sv[op][r][4 * c + 2] = val.z;
        sv[op][r][4 * c + 3] = val.w;
      }
    }
  }
  __syncthreads();
  constexpr int CPR = VIS / 4;           // 16-byte chunks of a transposed row
  constexpr int G = CPR < 8 ? CPR : 8;   // of them in one 128-byte line
#pragma unroll
  for (int op = 0; op < NTR; ++op)
    for (int idx = threadIdx.x; idx < D * CPR; idx += SPLIT_NT) {
      const int c = (idx / (G * D)) * G + idx % G, d = idx / G % D;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_tf32<false>(sv[op][8 * (c / 2) + c % 2 + 2 * j][d], hi[j], lo[j]);
      st_global4(img + C::ROWS + 2 * op * Row::BYTES + Tr::chunk(d, c), hi);
      st_global4(img + C::ROWS + (2 * op + 1) * Row::BYTES + Tr::chunk(d, c), lo);
    }
  int32_t* ids = reinterpret_cast<int32_t*>(img + C::ROWS + C::trs(DKV));
  const int32_t* soth = (DKV ? a.seg_q : a.seg_kv) + int64_t(b) * n_oth;
  const int64_t row0 = (int64_t(b) * a.h + hh) * a.sq;  // lse, di
  for (int i = threadIdx.x; i < VIS; i += SPLIT_NT) {
    const int r = r0 + i;
    ids[i] = r < n_oth ? soth[r] : 0;
    if constexpr (DKV) {
      reinterpret_cast<float*>(ids)[VIS + i] = r < a.sq ? a.lse[row0 + r] * LOG2E : INFINITY;
      reinterpret_cast<float*>(ids)[2 * VIS + i] = r < a.sq ? a.di[row0 + r] : 0.f;
    }
  }
}

// DKV: own rows are kv rows (K, V), visited rows query rows (Q, dO, lse,
// di); dV += P^T dO, dK += dS^T Q. Otherwise (dq): own rows are query rows
// (Q, dO, lse, di), visited rows kv rows (K, V); dQ += dS K. Warp-
// specialised: one thread of the producer (the threads after the
// consumers' warpgroups) copies each visited step's two units into free
// slots, completing on their full mbarriers; the others consume. Thread t
// of a consumer warpgroup holds, in every [64 x N] accumulator, own rows
// 16 (t / 32) + (t % 32) / 4 and that + 8, columns 8 i + 2 (t % 4) +
// {0, 1} of each 8-column group i (wgmma's accumulator layout). The
// block's scene is b + blockIdx.z, its head h0 + blockIdx.y, whose images
// are those of pass head blockIdx.y in `split`; `slots` the ring's slots;
// `staged` (or null) counts the visited rows copied in.
template <int D, bool DKV>
__global__ void __launch_bounds__(Cfg<D>::nt(DKV), Cfg<D>::min_blocks(DKV))
    seg_attn_bwd_tf32(Args a, int b, int h0, int slots, const unsigned char* split,
                      unsigned long long* staged) {
  using C = Cfg<D>;
  using Own = typename C::Own;
  using Row = typename C::Row;
  using Tr = typename C::Tr;
  constexpr int NWG = C::NWG, VIS = C::VIS, OWN = C::OWN;
  constexpr int SUBS = TILE / VIS;            // steps a visited tile
  constexpr int NB = D > 64 ? D / 64 : 1;     // 64-row blocks of the [D][VIS] tiles (N of a sum)
  constexpr int NW = (D > 64 ? 64 : D) / 2;   // a sum's fp32 registers a thread, per block
  constexpr int KS = VIS / 8;                 // k-steps of the second products
  constexpr uint32_t EXT = C::extras(DKV);
  constexpr bool REALLOC = NWG == 2 && !C::paired(DKV);  // setmaxnreg
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t tiles = (raw + 1023u) & ~1023u;
  // op 0: DKV K / dq Q, op 1: DKV V / dq dO; part 0 hi, 1 lo.
  auto own_t = [&](int w, int op, int part) {
    return tiles + ((w * 2 + op) * 2 + part) * Own::BYTES;
  };
  // Tile j of the unit in slot st: row-major op 0 (DKV Q / dq K) hi, lo,
  // op 1 (DKV dO / dq V) hi, lo; transposed op 0 (DKV Q^T / dq K^T) hi,
  // lo, DKV op 1 (dO^T) hi, lo.
  const uint32_t ring = tiles + NWG * 4 * Own::BYTES;
  auto unit_t = [&](int st, int j) { return ring + st * C::ROWS + j * Row::BYTES; };
  const uint32_t ext0 = ring + slots * C::ROWS;
  const uint32_t bars = ext0 + slots * EXT;
  auto full_bar = [&](int st) { return bars + st * 8; };
  auto empty_bar = [&](int st) { return bars + (slots + st) * 8; };
  // A row-major unit's extras: ids [VIS], DKV lse log2(e) [VIS], di [VIS].
  auto ext = [&](int st) {
    return reinterpret_cast<const int32_t*>(smem_raw + (ext0 - raw) + st * EXT);
  };
  int32_t* seg_own = reinterpret_cast<int32_t*>(smem_raw + (bars - raw) +
                                                2 * slots * sizeof(uint64_t));  // [OWN]
  int* range = seg_own + OWN;
  unsigned* bits = reinterpret_cast<unsigned*>(range + 4);

  const int t = threadIdx.x;
  const int wg = t / WG, tw = t % WG;  // warpgroup, thread in it
  const int g = tw % 32 / 4, tq = tw % 4;
  const int own0 = blockIdx.x * OWN;
  const int hh = h0 + blockIdx.y;
  const int bs = b + blockIdx.z;
  const int n_own = DKV ? a.skv : a.sq, n_oth = DKV ? a.sq : a.skv;
  const int32_t* sown = (DKV ? a.seg_kv : a.seg_q) + int64_t(bs) * n_own;
  const int32_t* soth = (DKV ? a.seg_q : a.seg_kv) + int64_t(bs) * n_oth;
  mark_tiles<C::nt(DKV), OWN>(sown, n_own, own0, soth, n_oth, a.nwords,
                              scene_visit(a.visit, bs, n_own, OWN), a.visits, seg_own, bits,
                              range);
  // A full step (every own and visited row valid, one segment) needs no
  // mask: the own rows must be uniform, the visited rows are voted on.
  const int own_lo = range[0];
  const bool own_uniform = own_lo == range[1] && own0 + OWN <= n_own;

  // Visited steps: step v is rows [v VIS, v VIS + VIS), in the bitmask's
  // tile v / SUBS; steps wholly past the end are skipped. Step i of the
  // walk is units 2 i (row-major) and 2 i + 1 (transposed); unit u lies in
  // slot u % slots.
  auto next_step = [&](int v) {
    if (v >= 0 && (v + 1) % SUBS != 0 && (v + 1) * VIS < n_oth) return v + 1;
    const int tile = next_tile(bits, a.nwords, v < 0 ? -1 : v / SUBS);
    return tile < 0 ? -1 : tile * SUBS;
  };
  int cur = next_step(-1);
  // The next unit's slot and the parity of its round; `lap`: the ring has
  // gone round, so a slot must be released before it is filled again.
  int st = 0;
  unsigned ph = 0;
  bool lap = false;
  auto advance = [&]() {
    if (++st == slots) {
      st = 0;
      ph ^= 1u;
      lap = true;
    }
  };

  if (t == 0) {
    for (int i = 0; i < slots; ++i) {
      mbar_init(full_bar(i), 1);
      mbar_init(empty_bar(i), NWG * WG);
    }
    fence_barrier_init();
  }
  __syncthreads();  // the mbarriers

  if (wg == NWG) {
    if constexpr (REALLOC) set_max_regs<C::PRODUCER_REGS, false>();
    if (tw != 0) return;
    // Producer: this head's step images.
    const unsigned char* img = split + int64_t(blockIdx.y) * C::steps(n_oth) * C::step_bytes(DKV);
    unsigned long long copied = 0;
    for (; cur >= 0; cur = next_step(cur)) {
      const unsigned char* src = img + cur * int64_t(C::step_bytes(DKV));
      if (lap) mbar_wait(empty_bar(st), ph ^ 1u);
      mbar_expect_tx(full_bar(st), C::ROWS + EXT);
      bulk_copy(unit_t(st, 0), src, C::ROWS, full_bar(st));
      bulk_copy(ext0 + st * EXT, src + C::ROWS + C::trs(DKV), EXT, full_bar(st));
      advance();
      if (lap) mbar_wait(empty_bar(st), ph ^ 1u);
      mbar_expect_tx(full_bar(st), C::trs(DKV));
      bulk_copy(unit_t(st, 0), src + C::ROWS, C::trs(DKV), full_bar(st));
      advance();
      copied += VIS;
    }
    if (staged != nullptr) atomicAdd(staged, copied);
    return;
  }

  // Consumer warpgroup wg.
  if constexpr (REALLOC) set_max_regs<C::CONSUMER_REGS, true>();
  const float* qb = static_cast<const float*>(a.q) + int64_t(bs) * a.q_sb + int64_t(hh) * D;
  const float* kb = static_cast<const float*>(a.k) + int64_t(bs) * a.k_sb + int64_t(hh) * D;
  const float* vb = static_cast<const float*>(a.v) + int64_t(bs) * a.v_sb + int64_t(hh) * D;
  const float* dob = static_cast<const float*>(a.dout) + int64_t(bs) * a.do_sb + int64_t(hh) * D;
  const float* lse_b = a.lse + (int64_t(bs) * a.h + hh) * a.sq;
  const float* di_b = a.di + (int64_t(bs) * a.h + hh) * a.sq;
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

  if (cur >= 0) {
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
    fence_async_proxy();
    wg_bar(1 + wg);
  }
  const int lane = t & 31;

  while (cur >= 0) {
    const int o0 = cur * VIS;
    const int rs = st;  // the step's row-major unit
    const unsigned rph = ph;
    advance();
    const int ts = st;  // its transposed unit
    const unsigned tph = ph;
    advance();
    mbar_wait(full_bar(rs), rph);
    const int32_t* seg_oth = ext(rs);                                    // [VIS]
    const float* row_lse = reinterpret_cast<const float*>(seg_oth) + VIS;  // DKV
    const float* row_di = row_lse + VIS;                                   // DKV
    // Lane c votes whether visited row c is valid and in the own rows'
    // one segment.
    const bool mine = lane >= VIS || (o0 + lane < n_oth && seg_oth[lane] == own_lo);
    const bool full = own_uniform && __all_sync(0xffffffffu, mine);

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
        const uint64_t bh = Row::k_major(unit_t(rs, 2 * op), ks);
        const uint64_t bl = Row::k_major(unit_t(rs, 2 * op + 1), ks);
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
    // A B over the step's VIS rows, B transposed op's tiles of the unit in
    // slot ts, rows [64 cb, 64 cb + 64). The tensor cores' fp32 sums drift
    // when left to add a whole walk: so summed over the 38.6k rows of the
    // Volt-s trunk, dq, dk and dv were 1.9e-4 off a float64 backward (the
    // plain fp32 backward: 4.2e-6). So each step's product starts from
    // zero, and `add` folds it into the gradient on the CUDA cores.
    float part[NW];
    auto second = [&](const uint32_t (&hi)[KS][4], const uint32_t (&lo)[KS][4], int op,
                      int cb) {
#pragma unroll
      for (int i = 0; i < NW; ++i) part[i] = 0.f;
      hold(part);
      wg_fence();
      const uint32_t bh = unit_t(ts, 2 * op) + cb * 64 * Tr::ROWB;
      const uint32_t bl = unit_t(ts, 2 * op + 1) + cb * 64 * Tr::ROWB;
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
      mbar_wait(full_bar(ts), tph);
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
    mbar_arrive(empty_bar(rs));  // S and dP are done, the extras read
    split_frags(dp, da_hi, da_lo);
    if constexpr (DKV) {
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) {
        if constexpr (NB > 1) second(pa_hi, pa_lo, 1, cb);
        wg_wait<0>();
        add(acc0[cb]);
      }
    } else {
      mbar_wait(full_bar(ts), tph);
    }
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      second(da_hi, da_lo, 0, cb);  // dK += dS^T Q; dQ += dS K
      wg_wait<0>();
      add(acc1[cb]);
    }
    mbar_arrive(empty_bar(ts));  // the transposed unit is read
    cur = next_step(cur);
  }

  // Own rows of the gradients.
  auto write = [&](void* out, const float (&acc)[NB][NW], int n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg0 + rows[h];
      if (r >= n) continue;
      float* row = static_cast<float*>(out) + ((int64_t(bs) * n + r) * a.h + hh) * D;
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
int launch(const Args& a, int b, void* split, int per_pass, unsigned long long* staged,
           cudaStream_t stream) {
  using C = Cfg<D>;
  int slots = C::SLOTS;
  size_t bytes = C::smem_bytes(DKV, slots, a.nwords);
  if (bytes > kMaxSmem) bytes = C::smem_bytes(DKV, slots = 2, a.nwords);
  if (bytes > kMaxSmem || per_pass < 1) return int(cudaErrorInvalidValue);
  auto kernel = seg_attn_bwd_tf32<D, DKV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(bytes));
  if (err != cudaSuccess) return int(err);
  const int n_own = DKV ? a.skv : a.sq, n_oth = DKV ? a.sq : a.skv;
  const int rc = launch_visit(DKV ? a.seg_kv : a.seg_q, n_own, DKV ? a.seg_q : a.seg_kv, n_oth, b,
                              C::OWN, a.visit, stream);
  if (rc != 0) return rc;
  auto* scratch = static_cast<unsigned char*>(split);
  for (int bs = 0; bs < b; ++bs)
    for (int h0 = 0; h0 < a.h; h0 += per_pass) {
      const int nh = a.h - h0 < per_pass ? a.h - h0 : per_pass;
      if (n_oth > 0)
        seg_attn_bwd_split_tf32<D, DKV><<<dim3(unsigned(C::steps(n_oth)), nh, 1), SPLIT_NT, 0,
                                          stream>>>(a, bs, h0, scratch);
      const dim3 grid((n_own + C::OWN - 1) / C::OWN, nh, 1);
      kernel<<<grid, C::nt(DKV), bytes, stream>>>(a, bs, h0, slots, scratch, staged);
      err = cudaGetLastError();
      if (err != cudaSuccess) return int(err);
    }
  return 0;
}

template <bool DKV>
int launch_dir(const Args& a, int b, int d, void* split, int per_pass,
               unsigned long long* staged, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16, DKV>(a, b, split, per_pass, staged, stream);
    case 32: return launch<32, DKV>(a, b, split, per_pass, staged, stream);
    case 64: return launch<64, DKV>(a, b, split, per_pass, staged, stream);
    case 128: return launch<128, DKV>(a, b, split, per_pass, staged, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

int launch_tf32(const Args& a, int b, int d, bool dkv, void* split, int per_pass,
                unsigned long long* staged, cudaStream_t stream) {
  return dkv ? launch_dir<true>(a, b, d, split, per_pass, staged, stream)
             : launch_dir<false>(a, b, d, split, per_pass, staged, stream);
}

int64_t split_bytes_tf32(int nh, int rows, int d, bool dkv) {
  switch (d) {
    case 16: return Cfg<16>::scratch_bytes(nh, rows, dkv);
    case 32: return Cfg<32>::scratch_bytes(nh, rows, dkv);
    case 64: return Cfg<64>::scratch_bytes(nh, rows, dkv);
    case 128: return Cfg<128>::scratch_bytes(nh, rows, dkv);
    default: return -1;
  }
}

}  // namespace wct::seg_bwd
