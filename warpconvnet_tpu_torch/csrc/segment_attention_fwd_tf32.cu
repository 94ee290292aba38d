// Segment-masked attention forward (K9) on fp32 inputs: Hopper's TF32
// tensor cores with 3xTF32 split products (wgmma, sm_90a).
//
// The function is segment_attention.cu's: out = softmax(scale * Q K^T) V
// over the pairs of equal segments, per (scene, head), fp32 in and out, and
// (when asked) the rows' natural-log log-sum-exp, +inf on rows that match
// nothing (whose out is exactly 0).
//
// Replaces: `_flash_attention_kernel` (:331, body :342-482) of jax 0.9.0's
// jax/experimental/pallas/ops/tpu/flash_attention.py, the stock forward
// that warpconvnet_tpu/nn/functional/flash_attention.py `segment_attention`
// runs with SegmentIds, here for the fp32 trunk.
//
// Arithmetic (3xTF32, as the fp32 backward's in
// segment_attention_bwd_tf32.cu): every fp32 operand x enters the products
// as hi = tf32(x) and lo = tf32(x - hi), and every product a b as
// a_lo b_hi + a_hi b_lo + a_hi b_hi on the TF32 tensor cores with fp32
// sums, the small terms first: fp32-class error, where one TF32 product
// errs by about 2^-11. The tensor cores' fp32 sums drift over long runs,
// so they sum only one step's products; out's sum over the whole walk is
// kept on the CUDA cores (O = alpha O + step, the online softmax's
// rescale), as is the row sum l (of the unsplit fp32 P).
//
// What bounds it on the card: the tensor cores. 4 * D FLOPs per (query,
// kv) pair of one head with equal segments (S and P V), each three times,
// against 494.7 TFLOP/s of dense TF32: 165 TFLOP/s of fp32-accurate work.
// Beside the products each pair costs one exp2 and a TF32 split of P on
// the CUDA cores.
//
// Design: K9-dq's (segment_attention_bwd_tf32.cu) with an online softmax,
// warp-specialised, in two launches a pass (a pass: as many scenes as the
// caller's scratch holds). First a pre-pass (seg_attn_fwd_split_tf32)
// splits every kv row of the pass once, for all query blocks, into TF32 hi
// and lo and writes them as the byte image of the forward's shared-memory
// stages: per (scene, head, kv step of VIS rows) one contiguous block of K
// hi and lo tiles row-major (the K-major B of S) and V hi and lo tiles
// transposed (tf32 wgmma reads both operands K-major only), swizzled as
// wgmma reads them, the rows of each group of 8 of V's tiles in the order
// 0 2 4 6 1 3 5 7, so that S's accumulator columns (2t, 2t + 1) of lane t
// are the k columns (t, t + 4) of a tf32 A fragment: P, split in registers,
// goes straight into the A operand of P V and never touches shared memory.
// The steps' segment ids follow, padded. Then the forward: a block per (own
// query tile, head, scene) of NWG consumer warpgroups of 64 own query rows
// each (two at D <= 64, one at D 128) and one producer warpgroup, walking
// the kv tiles. The own tile's [min, max] segment range marks the visited
// 64-row kv tiles in a shared bitmask (mark_kv_tiles,
// segment_attention_fwd.cuh: from the visit pre-pass's range where the kv
// ids are sorted, else by a scan), so every segment layout stays exact; a
// visited tile is taken VIS rows at a time (64; 32 at D 128, where Q's
// tiles take a third of shared memory). One thread of the producer
// warpgroup copies each visited step's image and ids into a free stage of
// the ring by bulk copies (TMA, no tensor map) that complete on the stage's
// full mbarrier; the rest of its warpgroup leaves at once, so at D <= 64 it
// hands all but 40 registers a thread to the consumers (setmaxnreg), which
// hold Q split once into hi and lo A fragments (at D 128, where they do not
// fit, hi and lo tiles). Shared memory bandwidth bounds the products, so Q
// from registers (one third of S's operand reads) matters. A warpgroup
// issuing wgmma waits while the tensor cores are busy, so a consumer does
// its CUDA-core work (softmax, splits, fold) only between its own products:
// with only the stages' mbarriers between them (no block barrier), the
// consumers drift apart and one's products run while the other's softmax
// runs. When every own and visited row of a step is valid and in one
// segment (a warp's vote), the mask is skipped. Each block writes only its
// own rows: deterministic. Shared memory at D 64: 3 stages x 64 KiB.
// Scratch: 16 D bytes a (kv row, head), one pass's scenes at a time.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "hopper.cuh"
#include "segment_attention_fwd.cuh"

namespace wct::seg_fwd {
namespace {

using namespace wct::hopper;

constexpr int WG = 128;               // threads of a warpgroup
constexpr int SPLIT_NT = 256;         // threads of a pre-pass block
constexpr size_t kMaxSmem = 232448;   // bytes a block may use on sm_90

template <int D>
struct Cfg {
  static constexpr int NWG = D > 64 ? 1 : 2;   // consumer warpgroups, 64 own rows each
  static constexpr int VIS = D > 64 ? 32 : 64;  // visited rows a step
  static constexpr int NT = (NWG + 1) * WG;     // the consumers, then the producer warpgroup
  static constexpr int OWN = NWG * TILE;
  // Q as A fragments in registers (hi and lo: D registers a thread), or
  // at D 128, where they would not fit, as tiles in shared memory.
  static constexpr bool QREG = D <= 64;
  using Own = Tile<D, 4>;        // [64][D]: own Q rows, K-major A of S
  using Row = Tile<D, 4, VIS>;   // [VIS][D]: visited K rows, K-major B of S
  using Tr = Tile<VIS, 4, D>;    // [D][VIS]: visited V rows transposed, K-major B of P V
  static_assert(Row::BYTES == Tr::BYTES && Row::BYTES % 1024 == 0 && Own::BYTES % 1024 == 0,
                "tiles keep 1024-byte alignment");
  // A step's image, in the scratch and in a stage: K hi, K lo, V^T hi,
  // V^T lo; its VIS segment ids apart.
  static constexpr uint32_t STEP = 4 * Row::BYTES;
  static constexpr uint32_t IDS = VIS * sizeof(int32_t);
  // Registers a thread (setmaxnreg, at two consumers): the launch gives
  // each 168; the producer's one copying thread needs few, the consumers
  // hold Q's fragments, S and P's: 128 x 40 + 256 x 232 = 384 x 168.
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  // Visited steps in shared memory: as many as fit beside Q's tiles.
  static constexpr int STAGES = D == 128 ? 2 : D == 64 ? 3 : 4;

  // 1024 bytes to align the tiles; own Q tiles (!QREG: NWG x hi, lo);
  // STAGES step images; the stages' segment ids (STAGES x VIS); the full
  // and empty mbarriers of each stage; then seg_own, range (padded to 4)
  // and the bitmask.
  static constexpr size_t OWN_BYTES = QREG ? 0 : size_t(NWG) * 2 * Own::BYTES;
  static constexpr size_t TILE_BYTES = OWN_BYTES + STAGES * size_t(STEP);
  static size_t smem_bytes(int nwords) {
    return 1024 + TILE_BYTES + STAGES * IDS + 2 * STAGES * sizeof(uint64_t) +
           (OWN + 4 + size_t(nwords)) * sizeof(int);
  }
  // Scratch of a pass of nb scenes: the step images [nb][h][steps], then
  // the ids [nb][steps][VIS].
  __host__ __device__ static int64_t steps(int skv) { return (int64_t(skv) + VIS - 1) / VIS; }
  static int64_t scratch_bytes(int nb, int skv, int h) {
    return int64_t(nb) * steps(skv) * (int64_t(h) * STEP + IDS);
  }
};

// The pre-pass: block (v, head, z) splits kv step v of that head of scene
// b0 + z into its image (rows past Skv zero), and at head 0 writes the
// step's segment ids (0 past Skv). K chunk (r, c), 4 columns of row r,
// goes straight through, c fastest across threads; V's rows pass through
// shared memory (rows padded by a float against bank conflicts), whence
// V^T chunk (d, c), visited positions 4 c .. 4 c + 3 of column d (rows
// 8 (c / 2) + c % 2 + 2 j), is taken with the 8 chunks of a 128-byte row
// fastest, so that a warp's loads and stores both cover whole lines.
template <int D>
__global__ void __launch_bounds__(SPLIT_NT)
    seg_attn_fwd_split_tf32(Args a, int b0, unsigned char* split) {
  using C = Cfg<D>;
  using Row = typename C::Row;
  using Tr = typename C::Tr;
  constexpr int VIS = C::VIS;
  __shared__ float sv[VIS][D + 1];
  const int v = blockIdx.x, hh = blockIdx.y, z = blockIdx.z, b = b0 + z;
  const int64_t nsteps = gridDim.x;
  unsigned char* img = split + ((int64_t(z) * a.h + hh) * nsteps + v) * C::STEP;
  const float* kb = static_cast<const float*>(a.k) + int64_t(b) * a.k_sb + int64_t(hh) * D;
  const float* vb = static_cast<const float*>(a.v) + int64_t(b) * a.v_sb + int64_t(hh) * D;
  const int r0 = v * VIS;
  for (int idx = threadIdx.x; idx < VIS * D / 4; idx += SPLIT_NT) {
    const int r = idx / (D / 4), c = idx % (D / 4);
    const bool ok = r0 + r < a.skv;
    uint32_t hi[4], lo[4];
    split4(load4(kb + int64_t(ok ? r0 + r : 0) * a.k_ss + 4 * c, ok), hi, lo);
    st_global4(img + Row::chunk(r, c), hi);
    st_global4(img + Row::BYTES + Row::chunk(r, c), lo);
    const float4 x = load4(vb + int64_t(ok ? r0 + r : 0) * a.v_ss + 4 * c, ok);
    sv[r][4 * c] = x.x;
    sv[r][4 * c + 1] = x.y;
    sv[r][4 * c + 2] = x.z;
    sv[r][4 * c + 3] = x.w;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < D * VIS / 4; idx += SPLIT_NT) {
    const int c = (idx / (8 * D)) * 8 + idx % 8, d = idx / 8 % D;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split_tf32<false>(sv[8 * (c / 2) + c % 2 + 2 * j][d], hi[j], lo[j]);
    st_global4(img + 2 * Row::BYTES + Tr::chunk(d, c), hi);
    st_global4(img + 3 * Row::BYTES + Tr::chunk(d, c), lo);
  }
  if (hh == 0) {
    int32_t* ids = reinterpret_cast<int32_t*>(split + int64_t(gridDim.z) * a.h * nsteps * C::STEP) +
                   (int64_t(z) * nsteps + v) * VIS;
    for (int i = threadIdx.x; i < VIS; i += SPLIT_NT)
      ids[i] = r0 + i < a.skv ? a.seg_kv[int64_t(b) * a.skv + r0 + i] : 0;
  }
}

// Warp-specialised: one thread of the last warpgroup produces (copies each
// visited step's image and ids into a free stage, completing on its full
// mbarrier), the others consume (each on its own 64 query rows: S, the
// online softmax, P V and the fold, then marks the stage empty). Nothing
// but the stages' mbarriers ties the warpgroups after the start, so one
// consumer's products run on the tensor cores while the other's softmax
// runs on the CUDA cores. Thread t of a consumer warpgroup holds, in every
// [64 x N] accumulator, own rows 16 (t / 32) + (t % 32) / 4 and that + 8,
// columns 8 i + 2 (t % 4) + {0, 1} of each 8-column group i (wgmma's
// accumulator layout). The block's scene is b0 + blockIdx.z, its images
// those of pass scene blockIdx.z in `split`; `staged` (or null) counts the
// kv rows copied in.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::NT, 1)
    seg_attn_fwd_tf32(Args a, int b0, const unsigned char* split, unsigned long long* staged) {
  using C = Cfg<D>;
  using Own = typename C::Own;
  using Row = typename C::Row;
  using Tr = typename C::Tr;
  constexpr int NWG = C::NWG, VIS = C::VIS, OWN = C::OWN, STAGES = C::STAGES;
  constexpr int SUBS = TILE / VIS;            // steps a visited tile
  constexpr int NB = D > 64 ? D / 64 : 1;     // 64-row blocks of the [D][VIS] tiles (N of P V)
  constexpr int NW = (D > 64 ? 64 : D) / 2;   // fp32 registers of out a thread, per block
  constexpr int KS = VIS / 8;                 // k-steps of P V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t tiles = (raw + 1023u) & ~1023u;
  // part 0 hi, 1 lo.
  auto own_t = [&](int w, int part) { return tiles + (w * 2 + part) * Own::BYTES; };
  const uint32_t vis0 = tiles + uint32_t(C::OWN_BYTES);
  auto row_t = [&](int st, int part) { return vis0 + st * C::STEP + part * Row::BYTES; };  // K
  auto tr_t = [&](int st, int part) {  // V^T
    return vis0 + st * C::STEP + (2 + part) * Row::BYTES;
  };
  const uint32_t ids0 = tiles + uint32_t(C::TILE_BYTES);
  const uint32_t bars = ids0 + STAGES * C::IDS;
  auto full_bar = [&](int st) { return bars + st * 8; };
  auto empty_bar = [&](int st) { return bars + (STAGES + st) * 8; };
  // [STAGES][VIS]
  const int32_t* seg_oth = reinterpret_cast<const int32_t*>(smem_raw + (ids0 - raw));
  int32_t* seg_own = reinterpret_cast<int32_t*>(smem_raw + (bars - raw) +
                                                2 * STAGES * sizeof(uint64_t));  // [OWN]
  int* range = seg_own + OWN;
  unsigned* bits = reinterpret_cast<unsigned*>(range + 4);

  const int t = threadIdx.x;
  const int wg = t / WG, tw = t % WG;  // warpgroup, thread in it
  const int g = tw % 32 / 4, tq = tw % 4;
  const int own0 = blockIdx.x * OWN;
  const int hh = blockIdx.y;
  const int z = blockIdx.z, b = b0 + z;
  const int32_t* skv = a.seg_kv + int64_t(b) * a.skv;
  mark_kv_tiles<C::NT, OWN>(a.seg_q + int64_t(b) * a.sq, a.sq, own0, skv, a.skv, a.nwords,
                            scene_visit(a.visit, b, a.sq, OWN), a.visits, seg_own, bits, range);
  // A full step (every own and visited row valid, one segment) needs no
  // mask: the own rows must be uniform, the visited rows are voted on.
  const int own_lo = range[0];
  const bool own_uniform = own_lo == range[1] && own0 + OWN <= a.sq;

  const float* qb = static_cast<const float*>(a.q) + int64_t(b) * a.q_sb + int64_t(hh) * D;

  // Visited steps: step v is kv rows [v VIS, v VIS + VIS), in the
  // bitmask's tile v / SUBS; steps wholly past the end are skipped. Step i
  // of the walk lies in stage i % STAGES.
  auto next_step = [&](int v) {
    if (v >= 0 && (v + 1) % SUBS != 0 && (v + 1) * VIS < a.skv) return v + 1;
    const int tile = next_tile(bits, a.nwords, v < 0 ? -1 : v / SUBS);
    return tile < 0 ? -1 : tile * SUBS;
  };
  int cur = next_step(-1);

  if (t == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), NWG * WG);
    }
    fence_barrier_init();
  }
  const int rows[2] = {16 * (tw / 32) + g, 16 * (tw / 32) + g + 8};  // own rows in the warpgroup
  const int wg0 = own0 + wg * TILE;  // this warpgroup's first own row
  if (!C::QREG && wg < NWG && cur >= 0) {
    // This consumer's own Q rows, split, row-major.
#pragma unroll 4
    for (int idx = tw; idx < TILE * D / 4; idx += WG) {
      const int r = idx / (D / 4), c = idx % (D / 4);
      const bool ok = wg0 + r < a.sq;
      uint32_t hi[4], lo[4];
      split4(load4(qb + int64_t(ok ? wg0 + r : 0) * a.q_ss + 4 * c, ok), hi, lo);
      st_shared4(own_t(wg, 0) + Own::chunk(r, c), hi);
      st_shared4(own_t(wg, 1) + Own::chunk(r, c), lo);
    }
    fence_async_proxy();
  }
  __syncthreads();  // the mbarriers (and Q tiles)

  if (wg == NWG) {
    if constexpr (NWG == 2) set_max_regs<C::PRODUCER_REGS, false>();
    if (tw != 0) return;
    // Producer: this scene's and head's step images, then the ids.
    const int64_t nsteps = C::steps(a.skv);
    const unsigned char* img = split + (int64_t(z) * a.h + hh) * nsteps * C::STEP;
    const unsigned char* ids = split + int64_t(gridDim.z) * a.h * nsteps * C::STEP +
                               int64_t(z) * nsteps * C::IDS;
    unsigned long long copied = 0;
    for (int it = 0; cur >= 0; ++it) {
      const int st = it % STAGES;
      if (it >= STAGES) mbar_wait(empty_bar(st), (it / STAGES - 1) & 1);
      mbar_expect_tx(full_bar(st), C::STEP + C::IDS);
      bulk_copy(row_t(st, 0), img + cur * int64_t(C::STEP), C::STEP, full_bar(st));
      bulk_copy(ids0 + st * C::IDS, ids + cur * int64_t(C::IDS), C::IDS, full_bar(st));
      copied += VIS;
      cur = next_step(cur);
    }
    if (staged != nullptr) atomicAdd(staged, copied);
    return;
  }

  // Consumer warpgroup wg.
  if constexpr (NWG == 2) set_max_regs<C::CONSUMER_REGS, true>();
  int my_seg[2];
  bool my_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    my_seg[h] = seg_own[wg * TILE + rows[h]];
    my_ok[h] = wg0 + rows[h] < a.sq;
  }
  // Q's A fragments, split (QREG): k-step ks holds rows rows[0], rows[1]
  // at columns 8 ks + tq and that + 4 (zero past Sq).
  uint32_t qa_hi[C::QREG ? D / 8 : 1][4], qa_lo[C::QREG ? D / 8 : 1][4];
  if constexpr (C::QREG) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* qrow = qb + int64_t(my_ok[h] ? wg0 + rows[h] : 0) * a.q_ss + tq;
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          split_tf32<false>(my_ok[h] ? qrow[8 * ks + 4 * half] : 0.f, qa_hi[ks][2 * half + h],
                            qa_lo[ks][2 * half + h]);
    }
  }
  // Online softmax state of the thread's two rows (log2 units; l the
  // thread's share of the row sum, summed over the quad at the end) and
  // out's running sum.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NB][NW];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < NW; ++i) o[cb][i] = 0.f;
  const int lane = t & 31;

  for (int it = 0; cur >= 0; ++it) {
    const int st = it % STAGES;
    const int o0 = cur * VIS;
    mbar_wait(full_bar(st), (it / STAGES) & 1);
    // Lane c votes whether visited rows c and c + 32 (VIS 64) are valid
    // and in the own rows' one segment.
    static_assert(VIS % 32 == 0, "a warp votes on whole rounds of visited rows");
    bool mine = true;
#pragma unroll
    for (int c = lane; c < VIS; c += 32)
      mine = mine && o0 + c < a.skv && seg_oth[st * VIS + c] == own_lo;
    const bool full = own_uniform && __all_sync(0xffffffffu, mine);

    // S = Q K^T as lo hi + hi lo + hi hi.
    float s[VIS / 2];
#pragma unroll
    for (int i = 0; i < VIS / 2; ++i) s[i] = 0.f;
    hold(s);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const uint64_t bh = Row::k_major(row_t(st, 0), ks);
      const uint64_t bl = Row::k_major(row_t(st, 1), ks);
      if constexpr (C::QREG) {
        wgmma_tf32_rs(s, qa_lo[ks], bh);
        wgmma_tf32_rs(s, qa_hi[ks], bl);
        wgmma_tf32_rs(s, qa_hi[ks], bh);
      } else {
        const uint64_t ah = Own::k_major(own_t(wg, 0), ks);
        const uint64_t al = Own::k_major(own_t(wg, 1), ks);
        wgmma_tf32_ss(s, al, bh, 1);
        wgmma_tf32_ss(s, ah, bl, 1);
        wgmma_tf32_ss(s, ah, bh, 1);
      }
    }
    wg_commit();
    wg_wait<0>();
    hold(s);

    // Online softmax over equal segments of valid rows (MASKED; a full
    // step has no other): visited row c of register 4 i + 2 h + e is
    // 8 i + 2 tq + e. The max runs on the raw scores (the scale is
    // positive); P = exp2(S scale log2(e) - m) replaces S; alpha rescales
    // what came before.
    float alpha[2];
    auto softmax = [&](auto masked) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < VIS / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * i + 2 * h + e, c = 8 * i + 2 * tq + e;
            if constexpr (decltype(masked)::value)
              s[x] = my_ok[h] && o0 + c < a.skv && seg_oth[st * VIS + c] == my_seg[h]
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
        for (int i = 0; i < VIS / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * i + 2 * h + e;
            s[x] = exp2_ftz(fmaf(s[x], a.scale_log2, -m_use));
            sum += s[x];
          }
        l[h] = l[h] * alpha[h] + sum;
      }
    };
    if (full)
      softmax(std::false_type{});
    else
      softmax(std::true_type{});

    // P split into A fragments: k-step kk takes the 8-column group kk, its
    // columns 2 tq and 2 tq + 1 at the fragment's k columns tq and tq + 4
    // (the transposed tile's row order).
    uint32_t pa_hi[KS][4], pa_lo[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      split_tf32<true>(s[4 * kk], pa_hi[kk][0], pa_lo[kk][0]);
      split_tf32<true>(s[4 * kk + 2], pa_hi[kk][1], pa_lo[kk][1]);
      split_tf32<true>(s[4 * kk + 1], pa_hi[kk][2], pa_lo[kk][2]);
      split_tf32<true>(s[4 * kk + 3], pa_hi[kk][3], pa_lo[kk][3]);
    }
    // The step's P V, for out's columns [64 cb, 64 cb + 64), starts from
    // zero on the tensor cores and is folded into out on the CUDA cores.
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      float part[NW];
#pragma unroll
      for (int i = 0; i < NW; ++i) part[i] = 0.f;
      hold(part);
      wg_fence();
      const uint32_t bh = tr_t(st, 0) + cb * 64 * Tr::ROWB;
      const uint32_t bl = tr_t(st, 1) + cb * 64 * Tr::ROWB;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        wgmma_tf32_rs(part, pa_lo[kk], Tr::k_major(bh, kk));
        wgmma_tf32_rs(part, pa_hi[kk], Tr::k_major(bl, kk));
        wgmma_tf32_rs(part, pa_hi[kk], Tr::k_major(bh, kk));
      }
      wg_commit();
      wg_wait<0>();
      hold(part);
      if (cb == NB - 1) mbar_arrive(empty_bar(st));  // the stage is read
#pragma unroll
      for (int i = 0; i < NW; ++i) o[cb][i] = fmaf(o[cb][i], alpha[(i >> 1) & 1], part[i]);
    }
    cur = next_step(cur);
  }

  // Own rows of out (O / l) and lse.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = wg0 + rows[h];
    if (r >= a.sq) continue;
    if (a.lse != nullptr && tq == 0)  // m and the reduced l are the same on a quad
      a.lse[(int64_t(b) * a.h + hh) * a.sq + r] = row_lse(m[h], l[h]);
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    float* row = static_cast<float*>(a.out) + ((int64_t(b) * a.sq + r) * a.h + hh) * D;
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int i = 0; i < NW / 4; ++i)
        *reinterpret_cast<float2*>(row + 64 * cb + 8 * i + 2 * tq) =
            make_float2(o[cb][4 * i + 2 * h] * inv, o[cb][4 * i + 2 * h + 1] * inv);
  }
}

template <int D>
int launch(const Args& a, int b, void* split, int per_pass, unsigned long long* staged,
           cudaStream_t stream) {
  using C = Cfg<D>;
  const size_t bytes = C::smem_bytes(a.nwords);
  if (bytes > kMaxSmem || per_pass < 1) return int(cudaErrorInvalidValue);
  auto kernel = seg_attn_fwd_tf32<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(bytes));
  if (err != cudaSuccess) return int(err);
  const int rc = launch_visit(a.seg_q, a.sq, a.seg_kv, a.skv, b, C::OWN, a.visit, stream);
  if (rc != 0) return rc;
  auto* scratch = static_cast<unsigned char*>(split);
  for (int b0 = 0; b0 < b; b0 += per_pass) {
    const int nb = b - b0 < per_pass ? b - b0 : per_pass;
    if (a.skv > 0)
      seg_attn_fwd_split_tf32<D><<<dim3(unsigned(C::steps(a.skv)), a.h, nb), SPLIT_NT, 0,
                                   stream>>>(a, b0, scratch);
    const dim3 grid((a.sq + C::OWN - 1) / C::OWN, a.h, nb);
    kernel<<<grid, C::NT, bytes, stream>>>(a, b0, scratch, staged);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  return 0;
}

}  // namespace

int launch_tf32(const Args& a, int b, int d, void* split, int per_pass,
                unsigned long long* staged, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16>(a, b, split, per_pass, staged, stream);
    case 32: return launch<32>(a, b, split, per_pass, staged, stream);
    case 64: return launch<64>(a, b, split, per_pass, staged, stream);
    case 128: return launch<128>(a, b, split, per_pass, staged, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

int64_t split_bytes_tf32(int nb, int skv, int h, int d) {
  switch (d) {
    case 16: return Cfg<16>::scratch_bytes(nb, skv, h);
    case 32: return Cfg<32>::scratch_bytes(nb, skv, h);
    case 64: return Cfg<64>::scratch_bytes(nb, skv, h);
    case 128: return Cfg<128>::scratch_bytes(nb, skv, h);
    default: return -1;
  }
}

}  // namespace wct::seg_fwd
