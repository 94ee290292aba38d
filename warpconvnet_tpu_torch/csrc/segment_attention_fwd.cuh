// Shared by the segment-attention forward kernels (K9): their arguments, the
// rule that picks the visited kv tiles, the row's log-sum-exp, and the fp32
// and bf16 launchers (segment_attention_fwd_tf32.cu,
// segment_attention_fwd_bf16.cu) that the C entry point of
// segment_attention.cu calls.
#pragma once

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "segment_attention_bwd.cuh"

namespace wct::seg_fwd {

using wct::seg_bwd::launch_visit;
using wct::seg_bwd::mark_range;
using wct::seg_bwd::scene_visit;
using wct::seg_bwd::TILE;  // kv rows of a visited tile

constexpr float LN2 = 0.6931471805599453f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* seg_q;   // [B, Sq]
  const int32_t* seg_kv;  // [B, Skv]
  void* out;              // [B, Sq, H, D], contiguous
  float* lse;             // [B, H, Sq] or null
  int sq, skv, h;
  int64_t q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;  // batch and row strides, elements
  float scale_log2;                            // softmax scale * log2(e)
  int nwords;                                  // bitmask words: ceil(kv tiles / 32)
  int32_t* visit;              // the visit pre-pass's output (seg_bwd::visit_ints ints)
  unsigned long long* visits;  // [2]: blocks that took the range, that scanned; or null
};

// Loads the own query rows' segment ids into seg_own and sets bit t of
// `bits` for every kv tile t that holds a row j < skv with seg_kv[j] in
// [min, max] of the own rows' segments: the backward's rule (mark_tiles of
// segment_attention_bwd.cuh). Where the scene's kv ids are sorted the bits
// come from the visit pre-pass's range (mark_range); otherwise the block
// scans all of seg_kv, each warp reading 128 ids a round, four a lane and
// two rounds' loads in flight. NT threads (at least OWN); ends with the
// block synchronised.
template <int NT, int OWN>
__device__ void mark_kv_tiles(const int32_t* seg_q, int sq, int own0, const int32_t* seg_kv,
                              int skv, int nwords, const int32_t* visit,
                              unsigned long long* visits, int32_t* seg_own, unsigned* bits,
                              int* range) {
  if (mark_range<NT, OWN>(seg_q, sq, own0, nwords, visit, visits, seg_own, bits, range)) return;
  const int t = threadIdx.x;
  const int lo = range[0], hi = range[1];
  const int lane = t & 31;
  const bool vec = (reinterpret_cast<uintptr_t>(seg_kv) & 15) == 0;
  // Whether any of rows j .. j + 3 is in the range.
  auto hit4 = [&](int j) {
    if (vec && j + 4 <= skv) {
      const int4 v = *reinterpret_cast<const int4*>(seg_kv + j);
      return (v.x >= lo && v.x <= hi) || (v.y >= lo && v.y <= hi) ||
             (v.z >= lo && v.z <= hi) || (v.w >= lo && v.w <= hi);
    }
    bool hit = false;
    for (int e = 0; e < 4 && j + e < skv; ++e) hit |= seg_kv[j + e] >= lo && seg_kv[j + e] <= hi;
    return hit;
  };
  // A round of a warp: 128 rows from j0, lanes 0-15 kv tile j0 / TILE,
  // lanes 16-31 the next.
  auto mark = [&](int j0, bool hit) {
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) {
      const int tile = j0 / TILE;
      if ((ballot & 0xffffu) != 0u) atomicOr(&bits[tile >> 5], 1u << (tile & 31));
      if ((ballot >> 16) != 0u) atomicOr(&bits[(tile + 1) >> 5], 1u << ((tile + 1) & 31));
    }
  };
  constexpr int ROUND = NT * 4;  // rows the block reads a round
  for (int j0 = (t & ~31) * 4; j0 < skv; j0 += 2 * ROUND) {
    const bool h0 = hit4(j0 + 4 * lane);
    const bool h1 = j0 + ROUND < skv && hit4(j0 + ROUND + 4 * lane);
    mark(j0, h0);
    if (j0 + ROUND < skv) mark(j0 + ROUND, h1);
  }
  __syncthreads();
}

// Natural-log log-sum-exp of a row from the online softmax's running max m
// (log2 units of the scaled scores) and sum l; +inf for a row with no match.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * LN2 : INFINITY;
}

// K9 for head dim d on fp32 inputs (3xTF32, segment_attention_fwd_tf32.cu)
// or bf16 inputs (segment_attention_fwd_bf16.cu). Return a CUDA error code.
// fp32 runs per_pass scenes at a time through `split`, the scratch of
// split_bytes_tf32(per_pass, skv, h, d) bytes that holds their kv rows
// split into TF32 hi and lo; `staged` (or null) counts the kv rows the
// blocks copy in.
int launch_tf32(const Args& a, int b, int d, void* split, int per_pass,
                unsigned long long* staged, cudaStream_t stream);
int64_t split_bytes_tf32(int nb, int skv, int h, int d);
int launch_bf16(const Args& a, int b, int d, cudaStream_t stream);

}  // namespace wct::seg_fwd
