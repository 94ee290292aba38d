// Shared by the segment-attention backward kernels K9-dkv and K9-dq: their
// arguments, the rule that picks the visited tiles (also K9's, through
// segment_attention_fwd.cuh), and the fp32 and bf16 launchers
// (segment_attention_bwd_tf32.cu, segment_attention_bwd_bf16.cu) that the C
// entry points of segment_attention_bwd.cu call.
//
// The rule: a block visits every other-side tile (TILE rows) that holds a
// row whose segment id lies in [min, max] of its own rows' ids. Where a
// scene's other-side ids rise along the row (patch ids, validity over a
// valid prefix), those rows are one run, found by two binary searches: the
// visit pre-pass (seg_attn_visit_ranges, segment_attention_visit.cu), one
// launch a call and direction over all scenes, writes each own tile's first
// and last visited tile and whether each scene's ids are sorted, and a
// block of a sorted scene sets exactly those bits. A block of any other
// scene scans all of its scene's other-side ids, as before the pre-pass.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace wct::seg_bwd {

constexpr int TILE = 64;  // rows of the own tile and of each visited tile
constexpr float LOG2E = 1.4426950408889634f;
// Slices of a scene's other-side ids the visit pre-pass checks for order,
// one flag each; a block reads them as one warp, a flag a lane.
constexpr int VISIT_CHUNKS = 32;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;       // dO [B, Sq, H, D]
  const float* lse;       // [B, H, Sq], natural log
  const float* di;        // [B, H, Sq]
  const int32_t* seg_q;   // [B, Sq]
  const int32_t* seg_kv;  // [B, Skv]
  void* dq;               // [B, Sq, H, D]  (K9-dq)
  void* dk;               // [B, Skv, H, D] (K9-dkv)
  void* dv;               // [B, Skv, H, D] (K9-dkv)
  int sq, skv, h;
  int64_t q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss;  // elements
  float scale, scale_log2;
  int nwords;  // bitmask words: ceil(other tiles / 32)
  int32_t* visit;                // the visit pre-pass's output (visit_ints ints)
  unsigned long long* visits;    // [2]: blocks that took the range, that scanned; or null
};

// Ints of the visit pre-pass's output for b scenes of n_own own rows and
// own tiles of `own` rows (at most visit_ints(b, n_own, TILE)): per scene,
// VISIT_CHUNKS order flags, then each own tile's first and last visited
// tile (last < first: none).
__host__ __device__ inline int64_t visit_ints(int b, int n_own, int own) {
  return int64_t(b) * (VISIT_CHUNKS + 2 * ((int64_t(n_own) + own - 1) / own));
}

// Scene b's part of the visit pre-pass's output (own tiles of `own` rows).
__device__ __forceinline__ const int32_t* scene_visit(const int32_t* visit, int b, int n_own,
                                                      int own) {
  return visit + visit_ints(b, n_own, own);
}

// The bits of bitmask word w that fall in tiles [first, last].
__device__ __forceinline__ unsigned tile_word(int first, int last, int w) {
  const int lo = first - 32 * w > 0 ? first - 32 * w : 0;
  const int hi = last - 32 * w < 31 ? last - 32 * w : 31;
  return lo > hi ? 0u : (0xffffffffu >> (31 - hi)) & (0xffffffffu << lo);
}

// The first half of the rule, shared by mark_tiles and mark_kv_tiles
// (segment_attention_fwd.cuh). Loads the OWN own rows' segment ids of the
// own tile into seg_own (rows past n_own get INT_MAX and are left out of
// the range) and their [min, max] into range[0], range[1]. Where the visit
// pre-pass found the scene's other-side ids sorted (every flag of `visit`,
// the scene's part of its output), sets exactly the bits of the own tile's
// [first, last] visited tiles and returns true; otherwise leaves the
// bitmask zero for the scan and returns false. `visits` (or null) counts
// the block: slot 0 range, slot 1 scan. NT threads (at least OWN); ends
// with the block synchronised.
template <int NT, int OWN>
__device__ bool mark_range(const int32_t* sown, int n_own, int own0, int nwords,
                           const int32_t* visit, unsigned long long* visits, int32_t* seg_own,
                           unsigned* bits, int* range) {
  static_assert(VISIT_CHUNKS == 32, "one warp reads a scene's order flags");
  const int t = threadIdx.x;
  for (int i = t; i < nwords; i += NT) bits[i] = 0u;
  if (t == 0) {
    range[0] = INT_MAX;
    range[1] = INT_MIN;
  }
  __syncthreads();
  if (t < OWN) {
    const int r = own0 + t;
    int s = INT_MAX;
    if (r < n_own) {
      s = sown[r];
      atomicMin(&range[0], s);
      atomicMax(&range[1], s);
    }
    seg_own[t] = s;
  }
  if (t < 32) {
    const bool sorted = __all_sync(0xffffffffu, visit[t] != 0);
    if (t == 0) range[2] = sorted;
  }
  __syncthreads();
  const bool sorted = range[2] != 0;
  if (t == 0 && visits != nullptr) atomicAdd(visits + (sorted ? 0 : 1), 1ull);
  if (!sorted) return false;
  const int2 fl = *reinterpret_cast<const int2*>(visit + VISIT_CHUNKS + 2 * (own0 / OWN));
  for (int i = t; i < nwords; i += NT) bits[i] = tile_word(fl.x, fl.y, i);
  __syncthreads();
  return true;
}

// Loads the OWN rows' segment ids of the own tile into seg_own and sets bit
// t of `bits` for every other tile t (TILE rows) that holds a row j <
// n_oth with soth[j] in [min, max] of the own tile's segments: from the
// visit pre-pass's range (mark_range) where the scene's ids are sorted,
// else by a scan of all of soth. NT threads (at least OWN); ends with the
// block synchronised.
template <int NT, int OWN = TILE>
__device__ void mark_tiles(const int32_t* sown, int n_own, int own0, const int32_t* soth,
                           int n_oth, int nwords, const int32_t* visit,
                           unsigned long long* visits, int32_t* seg_own, unsigned* bits,
                           int* range) {
  if (mark_range<NT, OWN>(sown, n_own, own0, nwords, visit, visits, seg_own, bits, range)) return;
  const int t = threadIdx.x;
  const int lo = range[0], hi = range[1];
  const int lane = t & 31;
  // Each warp takes 32 consecutive rows at a time, all inside one tile.
  for (int j0 = t & ~31; j0 < n_oth; j0 += NT) {
    const int j = j0 + lane;
    bool hit = false;
    if (j < n_oth) {
      const int s = soth[j];
      hit = s >= lo && s <= hi;
    }
    if (__ballot_sync(0xffffffffu, hit) != 0u && lane == 0) {
      const int tile = j0 / TILE;
      atomicOr(&bits[tile >> 5], 1u << (tile & 31));
    }
  }
  __syncthreads();
}

// K9-dkv (dkv) or K9-dq for head dim d on fp32 inputs (the 3xTF32 kernels
// of segment_attention_bwd_tf32.cu) or bf16 inputs (the kernels of
// segment_attention_bwd_bf16.cu). Return a CUDA error code. fp32 runs a
// pass a scene and per_pass of its heads through `split`, the scratch of
// split_bytes_tf32(per_pass, visited rows, d, dkv) bytes that holds their
// visited rows (K9-dkv: Sq, K9-dq: Skv) split into TF32 hi and lo;
// `staged` (or null) counts the visited rows the blocks copy in.
int launch_tf32(const Args& a, int b, int d, bool dkv, void* split, int per_pass,
                unsigned long long* staged, cudaStream_t stream);
int64_t split_bytes_tf32(int nh, int rows, int d, bool dkv);
int launch_bf16(const Args& a, int b, int d, bool dkv, cudaStream_t stream);

// The visit pre-pass (segment_attention_visit.cu) for b scenes: own rows
// seg_own [B, n_own] in tiles of `own` rows, other rows seg_oth [B, n_oth],
// into `visit` (visit_ints(b, n_own, own) ints). Returns a CUDA error code.
int launch_visit(const int32_t* seg_own, int n_own, const int32_t* seg_oth, int n_oth, int b,
                 int own, int32_t* visit, cudaStream_t stream);

}  // namespace wct::seg_bwd
