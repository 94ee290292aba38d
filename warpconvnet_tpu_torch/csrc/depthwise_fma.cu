// Depthwise sparse-conv kernels (per-channel weights, no channel mixing):
//   K6 forward   out[b, o, c] = sum_k x[b, table[b, k, o], c] * w[k, c]
//      (dgrad is the same kernel on (g, w, rev): a per-channel weight is its
//      own transpose)
//   K7 wgrad     dw[k, c] = sum_{b, o} x[b, table[b, k, o], c] * g[b, o, c]
//   K8 fused     dx and dw of a symmetric self-map in one launch:
//      dx[b, i, c] = sum_k g[b, table[b, k, i], c] * w[K-1-k, c], dw as K7
// x and g [B, N, C] in fp32 or bf16, w [K, C] fp32, table int32 (-1 adds
// zero), fp32 accumulation; out and dx in x's dtype, dw [K, C] fp32 summed
// over the batch.
//
// Replaces: warpconvnet_tpu/kernels/depthwise_fma.py `_depth_fwd_kernel`
// (:152, entry `depthwise_fma_fwd` :522), `_depth_wgrad_kernel` (:261, entry
// `depthwise_fma_wgrad` :607) and `_depth_bwd_fused_kernel` (:367, entry
// `depthwise_fma_bwd_fused` :692).
//
// What bounds them on the card: bytes. Each valid pair costs one row gather
// (K7 and K8's dw two: x and g) and C FMAs, so there is no arithmetic to
// speak of; a 7^3 map is a [B, 343, N] table of which a few percent is
// valid, and streaming the table sets the floor (360 MB of the 0.14 ms
// bound at the bench's 7^3 map). The TPU kernels' union windows, one-hot
// MXU gathers, offset grouping, 128-lane padding and overflow residual
// pass all exist because Mosaic cannot gather rows by index; here a
// thread gathers a row segment by its index, so none of them carries
// over, and the identity offset is an ordinary table row.
//
// K6 (`depth_fwd`): persistent blocks over tiles of rows.
// - A block owns a tile of 128 output rows (64 above 64 channels) and a
//   chunk of up to 256 channels; `tpr` threads a row (1-8) each own up to
//   4 groups of 8 channels, so the tile's rows do not shrink as C grows.
//   The grid holds as many blocks as fit on the card; each walks the tiles
//   blockIdx, blockIdx + gridDim, ... of all scenes.
// - Rounds of 32 offsets: the table tile [32 offsets][rows] (a 256-512 B
//   run an offset) moves into shared memory by cp.async through a ring of
//   three stages, issued two rounds ahead across tiles, each completing on
//   an mbarrier. One block barrier a round, for the ring: each warp lists
//   its own rows' valid entries (lane k reads offset k, a ballot places
//   them) into per-row lists of up to 64 entries and walks its rows only
//   when a list could overflow and after the tile's last round, so a 7^3
//   row's 15.6 pairs on average are gathered in one or two walks, as a
//   pipeline 2-4 entries deep (8-16 row segments in flight a thread).
// - Each row sums its entries in ascending offset order with fp32 fmaf,
//   the parent design's order: the same bits. The weight rows come from L1.
// K8 (`depth_bwd_fused`): one launch of two kinds of blocks.
// - dx: one persistent block an SM runs K6's walk on g with the weight
//   flipped (w[K-1-k] for offset k): the bits of K6 on (g, w flipped).
// - dw: a block for each (offset k, chunk of 8 x threads rows of a
//   scene) lists the chunk's valid pairs (o, j) in shared memory, sums
//   x[j] * g[o] over them in registers (lanes over pairs and channel
//   groups, 2-4 pairs gathered ahead), meets the lanes' sums in shared
//   memory and adds C floats into dw[k] once, with float4 atomics: 3.7M
//   floats at 7^3 C 96 on the bench pair, where the parent design added
//   200M (one add per 21-row tile and offset). Chunks of 4096 and 8192
//   rows (fewer blocks, fewer adds) were slower. The block counts the
//   floats it adds (`count`), the kernel's own record of its dw traffic.
// - Timed against it (tools/time_k6_k8.py): designs where one
//   gather of g[j] served both halves (dw through the map's mirror pairs,
//   x[i] * g[j] into dw[K-1-k]) with the dw sums in a [K, chunk] partial
//   in shared memory: by shared-memory float atomics (compare-and-swap
//   loops), by per-round column passes, by queues drained by the warp
//   that owns the partial row. All were slower than the parent's 1.55 ms
//   at 7^3 C 96 (2.1-4.3 ms): the 137 KB partial took L1's room from the
//   gathered rows and the weight, and the atomics serialised. Weight
//   slices staged in shared memory and TMA bulk copies of the table were
//   slower for K6 too (all on an H100 SXM at 700 W).
// K7 (`depth_dw`): K8's dw blocks launched alone, on any map (x and g
// with their own row counts): a block for each (offset, chunk of 8 x
// threads output rows of a scene, channel chunk), so the table is read
// once, each pair gathers its x and g rows once, and dw takes C floats per
// (scene, offset, chunk) that holds a pair. The block counts them.
#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_CHANNELS = 1024;
constexpr int MAX_THREADS = 512;    // K6 / K7 / K8 block
constexpr int GMAX = 4;             // 8-channel groups a thread owns in its row
constexpr int CHUNK = 256;          // channels of a K6 / K8 block at most
constexpr int KC = 32;              // offsets of a round (one lane each)
constexpr int NS = 3;               // stages of the table ring
constexpr int LCAP = 64;            // entries a row's list holds before it is walked
constexpr int SMEM_MAX = 232448;    // dynamic shared memory of a block (227 KB)

// 8 consecutive channels into fp32 registers. VEC: the caller checked that
// C % 8 == 0 and the base pointers are 16-byte aligned, so n_ok == 8 and the
// segment moves as 16-byte vectors; otherwise element by element, zero at
// and past n_ok.
template <bool VEC>
__device__ __forceinline__ void load8(const float* __restrict__ p, int n_ok, float (&v)[8]) {
  if (VEC) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < n_ok ? __ldg(p + e) : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void load8(const bf16* __restrict__ p, int n_ok, float (&v)[8]) {
  if (VEC) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      v[2 * q] = f.x;
      v[2 * q + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < n_ok ? __bfloat162float(p[e]) : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store8(float* p, int n_ok, const float (&v)[8]) {
  if (VEC) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < n_ok) p[e] = v[e];
  }
}

template <bool VEC>
__device__ __forceinline__ void store8(bf16* p, int n_ok, const float (&v)[8]) {
  if (VEC) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < n_ok) p[e] = __float2bfloat16(v[e]);
  }
}


// ---- K6, K7 and K8: tiles of rows, rounds of offsets, dw blocks ---------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier in shared memory (its address): init with the arrivals a
// phase takes; an arrival; wait until the phase of the given parity has
// completed.
__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// 16 bytes global -> shared without passing through registers.
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_addr(dst)), "l"(src));
}

// One arrival on the mbarrier once this thread's earlier cp.async copies
// have landed.
__device__ __forceinline__ void cp_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

// 8 channels of a gathered row as loaded (packed until used): 16 bytes of
// bf16 or 32 of fp32 on the vector path, else element by element (zero at
// and past n_ok).
template <typename T, bool VEC>
struct Row8 {
  float v[8];
  __device__ __forceinline__ void load(const T* p, int n_ok) { load8<false>(p, n_ok, v); }
  __device__ __forceinline__ void get(float (&o)[8]) const {
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = v[e];
  }
};

template <>
struct Row8<bf16, true> {
  uint4 u;
  __device__ __forceinline__ void load(const bf16* p, int) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void get(float (&o)[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      o[2 * q] = f.x;
      o[2 * q + 1] = f.y;
    }
  }
};

template <>
struct Row8<float, true> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p, int) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void get(float (&o)[8]) const {
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};

// A tile block's shape and its shared memory (byte offsets): the ring's
// mbarriers, the table ring [NS][kc][ts] int32 (ts = rows + 4: 16-byte rows
// whose columns fall in 8 banks), the row lists' entries lj [rows][LCAP +
// 1] int32, their offsets lk [rows][LCAP + 2] uint16 and counts cnt [rows].
struct Plan {
  int tpr;      // threads a row: 1, 2, 4 or 8
  int groups;   // 8-channel groups a thread owns (<= GMAX)
  int rows;     // rows of a tile
  int threads;  // rows x tpr
  int kc;       // offsets a round (<= 32)
  int ts;       // ints a staged table row (rows + 4)
  int cw;       // channels a chunk (a multiple of 8)
  int chunks;   // channel chunks (grid.y)
  int lgp;      // dw blocks (K7, K8): lanes a pair (the chunk's groups, to a power of 2)
  int dw_rows;  // dw blocks: rows of a chunk (DW_E a thread)
  int dw_smem;  // dw blocks: bytes of their pair list and partial sums
  int o_ring, o_lj, o_lk, o_cnt, smem;
};

constexpr int BARS = 128;  // bytes before the ring: NS mbarriers
constexpr int DW_E = 8;    // dw blocks: table entries a thread lists

// Tiles of 128 rows up to 64 channels a chunk, 64 above; tpr threads a row
// (128-512 threads). A dw block's pair list and partial sums take dw_smem
// bytes (K7's block); for K8 (`fused`) the tile blocks' shared memory also
// holds them.
Plan make_plan(int k_vol, int c, bool fused) {
  Plan p{};
  p.kc = std::max(8, std::min(KC, (k_vol + 7) / 8 * 8));
  const int nc = (c + CHUNK - 1) / CHUNK;
  p.cw = ((c + nc - 1) / nc + 7) / 8 * 8;
  p.chunks = (c + p.cw - 1) / p.cw;
  const int lc = p.cw / 8;
  p.tpr = lc <= 4 ? 1 : lc <= 8 ? 2 : lc <= 16 ? 4 : 8;
  p.groups = (lc + p.tpr - 1) / p.tpr;
  for (p.lgp = 1; p.lgp < lc; p.lgp *= 2) {}
  p.rows = p.tpr <= 2 ? 128 : 64;
  p.threads = p.rows * p.tpr;
  p.ts = p.rows + 4;
  int off = BARS;
  p.o_ring = off;
  off += NS * p.kc * p.ts * 4;
  p.o_lj = off;
  off += p.rows * (LCAP + 1) * 4;
  p.o_lk = off;
  off += p.rows * (LCAP + 2) * 2;
  p.o_cnt = off;
  off += p.rows * 4;
  p.dw_rows = DW_E * p.threads;
  p.dw_smem = (p.dw_rows * 8 + (p.threads / 32) * p.cw * 4 + 128 + 15) / 16 * 16;
  p.smem = (std::max(off, fused ? p.dw_smem : 0) + 15) / 16 * 16;
  return p;
}

template <typename T>
struct Args {
  const T* src;        // the gathered rows: K6 x (dgrad: g), K7 and K8 g
  const T* own;        // dw blocks: x
  const float* w;      // [K, C]
  const int32_t* table;
  T* out;              // K6 out, K8 dx
  float* dw;           // K7 and K8, zeroed
  unsigned long long* count;  // K7 and K8: floats added into dw (may be null)
  int scenes, n_in, n_out, k_vol, c;
  int tiles_per_scene, tiles;
  bool table16;        // table rows move as 16-byte copies (n_out % 4 == 0, aligned)
};

// Stage round q of tile t into ring stage buf, -1 past either end: each
// thread's cp.async copies, then its arrival on the stage's mbarrier once
// they land (or, where the table's rows are not 16-byte multiples, its
// loads and a plain arrival).
template <typename T>
__device__ __forceinline__ void stage(const Args<T>& a, const Plan& p, int32_t* ring,
                                      uint32_t bar, int buf, int t, int q) {
  const int R = p.rows, kc = p.kc, K = a.k_vol;
  const int b = t / a.tiles_per_scene, r0 = (t - b * a.tiles_per_scene) * R;
  const int k0 = q * kc;
  int32_t* ts = ring + buf * kc * p.ts;
  const int32_t* tb = a.table + int64_t(b) * K * a.n_out + r0;
  if (a.table16) {
    const int per = R / 4;
    for (int i = threadIdx.x; i < kc * per; i += blockDim.x) {
      const int kk = i / per, o4 = (i - kk * per) * 4;
      int32_t* d = ts + kk * p.ts + o4;
      if (k0 + kk < K && r0 + o4 < a.n_out) cp16(d, tb + int64_t(k0 + kk) * a.n_out + o4);
      else *reinterpret_cast<int4*>(d) = make_int4(-1, -1, -1, -1);
    }
    cp_arrive(bar);
  } else {
    for (int i = threadIdx.x; i < kc * R; i += blockDim.x) {
      const int kk = i / R, o = i - kk * R;
      ts[kk * p.ts + o] = k0 + kk < K && r0 + o < a.n_out
                              ? __ldg(tb + int64_t(k0 + kk) * a.n_out + o) : -1;
    }
    mbar_arrive(bar);
  }
}

// The row's threads walk its list (m entries, ascending offsets) as a
// pipeline U entries deep: entry e + U is gathered as entry e is summed.
// FLIP (K8's dx) takes weight row K-1-k for offset k; the weight rows come
// from L1.
template <typename T, bool VEC, int G, bool FLIP>
__device__ __forceinline__ void walk_row(const Args<T>& a, const int32_t* lj, const uint16_t* lk,
                                         int m, const T* sb, const float* wb, const int (&chl)[G],
                                         const int (&nok)[G], float (&acc)[G][8]) {
  constexpr int U = VEC && sizeof(T) == 2 ? 4 : 2;
  Row8<T, VEC> v[U][G];
  int k[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u >= m) break;
    const int32_t j = lj[u];
    k[u] = FLIP ? a.k_vol - 1 - lk[u] : lk[u];
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (nok[g] > 0) v[u][g].load(sb + int64_t(j) * a.c + chl[g], nok[g]);
  }
  for (int e0 = 0; e0 < m; e0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (e0 + u >= m) break;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (nok[g] <= 0) continue;
        float gv[8], wv[8];
        v[u][g].get(gv);
        load8<VEC>(wb + int64_t(k[u]) * a.c + chl[g], nok[g], wv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(gv[e], wv[e], acc[g][e]);
      }
      const int en = e0 + u + U;
      if (en < m) {
        const int32_t j = lj[en];
        k[u] = FLIP ? a.k_vol - 1 - lk[en] : lk[en];
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (nok[g] > 0) v[u][g].load(sb + int64_t(j) * a.c + chl[g], nok[g]);
      }
    }
  }
}

// K6 (and K8's dx, FLIP) over the tiles first, first + stride, ... of all
// scenes. The table ring (NS stages, issued NS-1 rounds ahead, each
// completing on its mbarrier) needs one block barrier a round; each warp
// lists its own rows' valid entries (lane k reads offset k, a ballot places
// them) and walks its rows when a list could overflow and after the tile's
// last round.
template <typename T, bool VEC, int G, bool FLIP>
__device__ __forceinline__ void tile_walk(const Args<T>& a, const Plan& p, unsigned char* smem,
                                          int first, int stride) {
  const uint32_t bar0 = smem_addr(smem);
  int32_t* ring = reinterpret_cast<int32_t*>(smem + p.o_ring);
  int32_t* lj = reinterpret_cast<int32_t*>(smem + p.o_lj);
  uint16_t* lk = reinterpret_cast<uint16_t*>(smem + p.o_lk);
  int* cnt = reinterpret_cast<int*>(smem + p.o_cnt);
  constexpr int LJ = LCAP + 1, LK = LCAP + 2;
  const int R = p.rows, kc = p.kc, K = a.k_vol, nr = (K + kc - 1) / kc;
  const int tid = threadIdx.x, lane = tid & 31;
  const int rpw = 32 / p.tpr, wr0 = (tid >> 5) * rpw;  // the warp's rows
  const int c0 = blockIdx.y * p.cw, width = min(p.cw, a.c - c0);
  // Thread (row r, sub) owns groups sub, sub + tpr, ... of row r.
  const int r = tid / p.tpr, sub = tid - r * p.tpr;
  int chl[G], nok[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    chl[g] = (g * p.tpr + sub) * 8;
    nok[g] = max(0, min(8, width - chl[g]));
  }
  for (int i = tid; i < R; i += blockDim.x) cnt[i] = 0;
  if (tid == 0)
    for (int i = 0; i < NS; ++i) mbar_init(bar0 + 8 * i, blockDim.x);
  __syncthreads();
  int it = first, iq = 0, ibuf = 0;  // the next round to stage
  auto advance = [&](int& t, int& q) {
    if (++q == nr) {
      q = 0;
      t += stride;
    }
  };
  for (int i = 0; i < NS - 1; ++i) {
    if (it < a.tiles) stage(a, p, ring, bar0 + 8 * ibuf, ibuf, it, iq);
    advance(it, iq);
    ibuf = (ibuf + 1) % NS;
  }
  float acc[G][8];
  int t = first, q = 0;
  for (int rnd = 0; t < a.tiles; ++rnd) {
    const int buf = rnd % NS;
    const int b = t / a.tiles_per_scene, r0 = (t - b * a.tiles_per_scene) * R;
    if (q == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
    }
    mbar_wait(bar0 + 8 * buf, (rnd / NS) & 1);
    __syncthreads();  // this round's stage has landed; the previous round's stage is free
    if (it < a.tiles) stage(a, p, ring, bar0 + 8 * ibuf, ibuf, it, iq);
    advance(it, iq);
    ibuf = (ibuf + 1) % NS;

    const T* sb = a.src + int64_t(b) * a.n_in * a.c + c0;
    auto walk = [&]() {
      walk_row<T, VEC, G, FLIP>(a, lj + r * LJ, lk + r * LK, cnt[r], sb, a.w + c0, chl, nok, acc);
      __syncwarp();
      if (lane < rpw) cnt[wr0 + lane] = 0;
      __syncwarp();
    };
    if (__any_sync(0xffffffffu, lane < rpw && cnt[wr0 + lane] + kc > LCAP)) walk();
    // The warp lists its rows' valid entries of this round in offset order:
    // lane kk reads offset kk of 8 rows at once, a ballot a row places the
    // valid ones after the row's earlier entries (lane i keeps row i's count).
    const int32_t* tsb = ring + buf * kc * p.ts;
    int mine = lane < rpw ? cnt[wr0 + lane] : 0;
    for (int i0 = 0; i0 < rpw; i0 += 8) {
      int32_t v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = lane < kc && i0 + i < rpw ? tsb[lane * p.ts + wr0 + i0 + i] : -1;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int rr = wr0 + i0 + i;
        const unsigned mask = __ballot_sync(0xffffffffu, v[i] >= 0);
        const int base = __shfl_sync(0xffffffffu, mine, i0 + i);
        if (v[i] >= 0) {
          const int pos = base + __popc(mask & ((1u << lane) - 1u));
          lj[rr * LJ + pos] = v[i];
          lk[rr * LK + pos] = uint16_t(q * kc + lane);
        }
        if (lane == i0 + i) mine = base + __popc(mask);
      }
    }
    if (lane < rpw) cnt[wr0 + lane] = mine;
    __syncwarp();
    if (q + 1 == nr) {  // the tile's last round
      walk();
      if (r0 + r < a.n_out) {
        T* orow = a.out + (int64_t(b) * a.n_out + r0 + r) * a.c + c0;
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (nok[g] > 0) store8<VEC>(orow + chl[g], nok[g], acc[g]);
      }
    }
    advance(t, q);
  }
}

template <typename T, bool VEC, int G>
__global__ void __launch_bounds__(MAX_THREADS)
depth_fwd(const Args<T> a, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  tile_walk<T, VEC, G, false>(a, p, smem, blockIdx.x, gridDim.x);
}

// The dw block d of K7 and K8: offset k = d % K of output rows [o0, o0 +
// dw_rows) of one scene (x at n_in rows a scene, g and the table at
// n_out). The block lists the chunk's valid pairs (o, j = table[k, o]) in
// shared memory, then its lanes, (slot, group) with slots spread over the
// warps, sum x[j] * g[o] over the pairs in registers, gathering U pairs
// ahead; the sums meet over the slots in shared memory and the block adds
// them into dw[k] once, with float4 atomics, and counts the floats added.
template <typename T, bool VEC>
__device__ __forceinline__ void dw_chunk(const Args<T>& a, const Plan& p, unsigned char* smem,
                                         int d) {
  constexpr int U = VEC && sizeof(T) == 2 ? 4 : 2;
  int2* items = reinterpret_cast<int2*>(smem);
  float* red = reinterpret_cast<float*>(smem + p.dw_rows * 8);
  int* part = reinterpret_cast<int*>(red + (blockDim.x >> 5) * p.cw);
  const int K = a.k_vol, n = a.n_out, nrc = (n + p.dw_rows - 1) / p.dw_rows;
  const int k = d % K, b = d / K / nrc, o0 = (d / K - b * nrc) * p.dw_rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const int c0 = blockIdx.y * p.cw, width = min(p.cw, a.c - c0);
  const int32_t* trow = a.table + (int64_t(b) * K + k) * n + o0;
  const int lim = min(p.dw_rows, n - o0);
  // List the valid pairs: each thread takes DW_E consecutive entries.
  int32_t v[DW_E];
#pragma unroll
  for (int e = 0; e < DW_E; ++e) {
    const int o = tid * DW_E + e;
    v[e] = o < lim ? __ldg(trow + o) : -1;
  }
  int mine = 0;
#pragma unroll
  for (int e = 0; e < DW_E; ++e) mine += v[e] >= 0;
  int incl = mine;  // inclusive scan over the warp, then over the warps
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < warps; ++w) {
    const int x = part[w];
    before += w < warp ? x : 0;
    total += x;
  }
  int pos = before + incl - mine;
#pragma unroll
  for (int e = 0; e < DW_E; ++e)
    if (v[e] >= 0) items[pos++] = make_int2(o0 + tid * DW_E + e, v[e]);
  __syncthreads();
  if (total == 0) return;
  // Lane (slot s of the warp, group gl): slot id = warp * slots + s.
  const int slots = 32 / p.lgp, s = lane / p.lgp, gl = lane - s * p.lgp;
  const int nsl = warps * slots, sid = warp * slots + s;
  const int ch = gl * 8, nk = max(0, min(8, width - ch));
  const T* xb = a.own + int64_t(b) * a.n_in * a.c + c0 + ch;
  const T* gb = a.src + int64_t(b) * n * a.c + c0 + ch;
  float sum[8] = {};
  if (nk > 0) {
    Row8<T, VEC> xv[U], gv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = sid + u * nsl;
      if (i >= total) break;
      const int2 pr = items[i];
      xv[u].load(xb + int64_t(pr.y) * a.c, nk);
      gv[u].load(gb + int64_t(pr.x) * a.c, nk);
    }
    for (int i0 = sid; i0 < total; i0 += U * nsl) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u * nsl >= total) break;
        float xf[8], gf[8];
        xv[u].get(xf);
        gv[u].get(gf);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum[e] = fmaf(xf[e], gf[e], sum[e]);
        const int in = i0 + (u + U) * nsl;
        if (in < total) {
          const int2 pr = items[in];
          xv[u].load(xb + int64_t(pr.y) * a.c, nk);
          gv[u].load(gb + int64_t(pr.x) * a.c, nk);
        }
      }
    }
  }
  for (int off = p.lgp; off < 32; off *= 2)
#pragma unroll
    for (int e = 0; e < 8; ++e) sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], off);
  if (s == 0 && nk > 0)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < nk) red[warp * p.cw + ch + e] = sum[e];
  __syncthreads();
  float* dk = a.dw + int64_t(k) * a.c + c0;
  if (VEC) {
    for (int i = tid; i < width / 4; i += blockDim.x) {
      float4 t4 = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w = 0; w < warps; ++w) {
        const float4 r4 = *reinterpret_cast<const float4*>(red + w * p.cw + 4 * i);
        t4.x += r4.x; t4.y += r4.y; t4.z += r4.z; t4.w += r4.w;
      }
      atomicAdd(reinterpret_cast<float4*>(dk) + i, t4);
    }
  } else {
    for (int i = tid; i < width; i += blockDim.x) {
      float t1 = 0.f;
      for (int w = 0; w < warps; ++w) t1 += red[w * p.cw + i];
      atomicAdd(dk + i, t1);
    }
  }
  if (tid == 0 && a.count != nullptr) atomicAdd(a.count, static_cast<unsigned long long>(width));
}

// K8: blocks [0, n_dx) walk the tiles for dx (K6 on g with the weight
// flipped), the rest are dw blocks.
template <typename T, bool VEC, int G>
__global__ void __launch_bounds__(MAX_THREADS)
depth_bwd_fused(const Args<T> a, const Plan p, int n_dx) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (int(blockIdx.x) < n_dx) tile_walk<T, VEC, G, true>(a, p, smem, blockIdx.x, n_dx);
  else dw_chunk<T, VEC>(a, p, smem, blockIdx.x - n_dx);
}

// K7: dw blocks only.
template <typename T, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
depth_dw(const Args<T> a, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  dw_chunk<T, VEC>(a, p, smem, blockIdx.x);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// One 16-byte (or two) vector per 8 channels: C % 8 == 0, aligned bases.
bool vec_ok(int c, const void* a, const void* b, const void* d, const void* e = nullptr) {
  return c % 8 == 0 && aligned16(a) && aligned16(b) && aligned16(d) &&
         (e == nullptr || aligned16(e));
}

int num_sms() {
  static const int sms = [] {
    int device = 0, n = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    return n;
  }();
  return sms;
}

// cudaFuncSetAttribute(KERNEL, max dynamic shared memory), once a kernel
// (a template instance each) and device.
template <auto KERNEL>
cudaError_t allow_smem() {
  static unsigned done = 0;  // a bit per device
  int device = 0;
  cudaGetDevice(&device);
  if (device < 32 && (done >> device) & 1u) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err == cudaSuccess && device < 32) done |= 1u << device;
  return err;
}

// Plan out (may be null): the launch's dw blocks (K for each chunk of
// dw_rows rows of each scene) and the rows of a chunk.
template <typename T>
int64_t dw_blocks(const Args<T>& a, const Plan& p, int* plan_out) {
  const int64_t n_dw = int64_t(a.scenes) * ((a.n_out + p.dw_rows - 1) / p.dw_rows) * a.k_vol;
  if (plan_out != nullptr) {
    plan_out[0] = int(n_dw);
    plan_out[1] = p.dw_rows;
  }
  return n_dw;
}

enum class Mode { fwd, wgrad, fused };

// K6: as many persistent blocks as fit on the card at once, at most one a
// tile. K7: the dw blocks alone. K8: one persistent dx block an SM (at
// most one a tile), then the dw blocks.
template <typename T, bool VEC, int G>
int launch(const Args<T>& a, const Plan& p, Mode mode, cudaStream_t stream, int* plan_out) {
  if (mode == Mode::fwd) {
    auto kernel = depth_fwd<T, VEC, G>;
    cudaError_t err = allow_smem<depth_fwd<T, VEC, G>>();
    if (err != cudaSuccess) return int(err);
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, p.threads, p.smem);
    const int blocks = int(std::min<int64_t>(a.tiles, int64_t(num_sms()) * std::max(per_sm, 1)));
    kernel<<<dim3(blocks, p.chunks), p.threads, p.smem, stream>>>(a, p);
    return int(cudaGetLastError());
  }
  if (mode == Mode::wgrad) {
    cudaError_t err = allow_smem<depth_dw<T, VEC>>();
    if (err != cudaSuccess) return int(err);
    const int64_t n_dw = dw_blocks(a, p, plan_out);
    if (n_dw > 0x7fffffff) return int(cudaErrorInvalidValue);
    depth_dw<T, VEC><<<dim3(unsigned(n_dw), p.chunks), p.threads, p.dw_smem, stream>>>(a, p);
    return int(cudaGetLastError());
  }
  auto kernel = depth_bwd_fused<T, VEC, G>;
  cudaError_t err = allow_smem<depth_bwd_fused<T, VEC, G>>();
  if (err != cudaSuccess) return int(err);
  const int n_dx = std::min(a.tiles, num_sms());
  const int64_t n_dw = dw_blocks(a, p, plan_out);
  if (n_dx + n_dw > 0x7fffffff) return int(cudaErrorInvalidValue);
  kernel<<<dim3(unsigned(n_dx + n_dw), p.chunks), p.threads, p.smem, stream>>>(a, p, n_dx);
  return int(cudaGetLastError());
}

template <typename T>
int run(const void* src, const void* own, const float* w, const int32_t* table, void* out,
        float* dw, unsigned long long* count, int b, int n_in, int n_out, int k_vol, int c,
        bool vec, Mode mode, cudaStream_t stream, int* plan_out) {
  const Plan p = make_plan(k_vol, c, mode == Mode::fused);
  Args<T> a{};
  a.src = static_cast<const T*>(src);
  a.own = static_cast<const T*>(own);
  a.w = w;
  a.table = table;
  a.out = static_cast<T*>(out);
  a.dw = dw;
  a.count = count;
  a.n_in = n_in;
  a.n_out = n_out;
  a.k_vol = k_vol;
  a.c = c;
  a.scenes = b;
  a.tiles_per_scene = (n_out + p.rows - 1) / p.rows;
  a.tiles = b * a.tiles_per_scene;
  a.table16 = n_out % 4 == 0 && aligned16(table);
  if (mode == Mode::wgrad)  // the dw blocks take no group count
    return vec ? launch<T, true, GMAX>(a, p, mode, stream, plan_out)
               : launch<T, false, GMAX>(a, p, mode, stream, plan_out);
  if (!vec) return launch<T, false, GMAX>(a, p, mode, stream, plan_out);
  switch (p.groups) {
    case 1: return launch<T, true, 1>(a, p, mode, stream, plan_out);
    case 2: return launch<T, true, 2>(a, p, mode, stream, plan_out);
    case 3: return launch<T, true, 3>(a, p, mode, stream, plan_out);
    default: return launch<T, true, 4>(a, p, mode, stream, plan_out);
  }
}

bool bad_shape(int b, int k_vol, int c) {
  return b < 0 || k_vol < 0 || c <= 0 || c > MAX_CHANNELS || b > 65535 || k_vol > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, g, out and dx share it); w is fp32.
// dw must be zeroed. C is at most 1024.
extern "C" int wct_depth_fwd(const void* x, const float* w, const int32_t* table, void* out,
                             int b, int n_in, int n_out, int k_vol, int c, int dtype,
                             cudaStream_t stream) {
  if (bad_shape(b, k_vol, c) || dtype < 0 || dtype > 1) return int(cudaErrorInvalidValue);
  if (b == 0 || n_out == 0) return 0;
  if (k_vol == 0)
    return int(cudaMemsetAsync(out, 0, size_t(b) * n_out * c * (dtype == 0 ? 4 : 2), stream));
  const bool vec = vec_ok(c, x, w, out);
  return dtype == 0 ? run<float>(x, nullptr, w, table, out, nullptr, nullptr, b, n_in, n_out,
                                 k_vol, c, vec, Mode::fwd, stream, nullptr)
                    : run<bf16>(x, nullptr, w, table, out, nullptr, nullptr, b, n_in, n_out,
                                k_vol, c, vec, Mode::fwd, stream, nullptr);
}

// count: an int64 counter to which the launch adds the floats its blocks
// add into dw (may be null). plan (may be null): 2 ints written before the
// launch, its blocks (one for each offset and chunk of rows of each scene)
// and the rows of a chunk.
extern "C" int wct_depth_wgrad(const void* x, const void* g, const int32_t* table, float* dw,
                               int b, int n_in, int n_out, int k_vol, int c, int dtype,
                               unsigned long long* count, int* plan, cudaStream_t stream) {
  if (plan != nullptr) plan[0] = plan[1] = 0;
  if (bad_shape(b, k_vol, c) || dtype < 0 || dtype > 1) return int(cudaErrorInvalidValue);
  if (b == 0 || n_out == 0 || k_vol == 0) return 0;
  const bool vec = vec_ok(c, x, g, dw);
  return dtype == 0 ? run<float>(g, x, nullptr, table, nullptr, dw, count, b, n_in, n_out, k_vol,
                                 c, vec, Mode::wgrad, stream, plan)
                    : run<bf16>(g, x, nullptr, table, nullptr, dw, count, b, n_in, n_out, k_vol,
                                c, vec, Mode::wgrad, stream, plan);
}

// count and plan: as wct_depth_wgrad's, for the launch's dw blocks.
extern "C" int wct_depth_bwd_fused(const void* x, const void* g, const float* w,
                                   const int32_t* table, void* dx, float* dw, int b, int n,
                                   int k_vol, int c, int dtype, unsigned long long* count,
                                   int* plan, cudaStream_t stream) {
  if (bad_shape(b, k_vol, c) || k_vol == 0 || dtype < 0 || dtype > 1)
    return int(cudaErrorInvalidValue);
  if (b == 0 || n == 0) return 0;
  const bool vec = vec_ok(c, x, g, w, dx) && aligned16(dw);
  return dtype == 0 ? run<float>(g, x, w, table, dx, dw, count, b, n, n, k_vol, c, vec,
                                 Mode::fused, stream, plan)
                    : run<bf16>(g, x, w, table, dx, dw, count, b, n, n, k_vol, c, vec,
                                Mode::fused, stream, plan);
}
