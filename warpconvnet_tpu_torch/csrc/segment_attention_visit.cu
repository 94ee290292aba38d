// The visit pre-pass of the segment-attention kernels K9, K9-dkv and K9-dq
// (seg_attn_visit_ranges): the visited tiles of every own tile of a call,
// found once, so that a block need not scan its scene's segment ids.
//
// Replaces: nothing of the TPU package. The stock Pallas kernels visit
// every kv block and skip the masked ones by their segment ids; the port's
// kernels visit only the 64-row tiles that hold a row whose id lies in
// [min, max] of the own tile's ids (segment_attention_bwd.cuh). Each block
// used to find them by reading all of its scene's other-side ids: at
// PTv3's level 0 (262144 rows a scene, 1024-row patches) 1 MB a block to
// find about 16 tiles, 8192-16384 blocks a call.
//
// What it does: per scene, whether the other side's ids are non-decreasing
// along the row (VISIT_CHUNKS flags, one a slice of the rows; a block reads
// them all), and per own tile its ids' [min, max] and, by two binary
// searches among the other side's ids, the first and last tile that holds
// one of them. Where a scene is sorted those rows are one run, so the
// tiles between are exactly the scan's; where it is not, the searches'
// answers are never read. One launch a call and direction covers all
// scenes; it reads only segment ids (each own id once, the other side's
// once for the order and a few lines a search).
//
// What bounds it: latency. A warp takes an own tile: a pass over its ids,
// then two searches of four or five dependent rounds at 32 probes a round.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "segment_attention_bwd.cuh"

namespace wct::seg_bwd {
namespace {

constexpr int VISIT_NT = 256;               // threads of a block
constexpr int VISIT_WARPS = VISIT_NT / 32;  // own tiles a block

// The first j in [lo, hi) with pred(s[j]), or hi if there is none, where
// pred is false and then true along j (s sorted). By a whole warp: each
// round probes 32 rows evenly spread over what is left and keeps the span
// between the last false probe and the first true one.
template <class Pred>
__device__ int warp_search(const int32_t* s, int lo, int hi, Pred pred) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int64_t x = lo + int64_t(lane + 1) * step - 1;  // probe lane
    const unsigned hit = __ballot_sync(0xffffffffu, x >= hi || pred(s[x]));
    const int k = hit != 0u ? __ffs(hit) - 1 : 32;  // the first true probe
    const int64_t x_k = lo + int64_t(k + 1) * step - 1;
    lo += k * step;
    if (x_k < hi) hi = int(x_k);
  }
  const unsigned hit = __ballot_sync(0xffffffffu, lo + lane >= hi || pred(s[lo + lane]));
  return hit != 0u ? lo + __ffs(hit) - 1 : hi;
}

// Block (x, b) of scene b: block x < VISIT_CHUNKS flags whether slice x of
// the other side's rows is in order (the pairs (j, j + 1) with j in the
// slice), then warp w takes own tile x VISIT_WARPS + w. Writes scene b's
// part of `visit` (visit_ints).
__global__ void __launch_bounds__(VISIT_NT)
    seg_attn_visit_ranges(const int32_t* seg_own, int n_own, const int32_t* seg_oth, int n_oth,
                          int own, int32_t* visit) {
  const int b = blockIdx.y;
  const int tiles = (n_own + own - 1) / own;
  int32_t* out = visit + visit_ints(b, n_own, own);
  const int32_t* soth = seg_oth + int64_t(b) * n_oth;
  if (blockIdx.x < VISIT_CHUNKS) {
    const int64_t len = (int64_t(n_oth) + VISIT_CHUNKS - 1) / VISIT_CHUNKS;
    const int64_t stop = int64_t(blockIdx.x + 1) * len;
    const int64_t end = stop < n_oth - 1 ? stop : n_oth - 1;
    bool ok = true;
    for (int64_t j = blockIdx.x * len + threadIdx.x; j < end; j += VISIT_NT)
      ok &= soth[j] <= soth[j + 1];
    ok = __syncthreads_and(ok);
    if (threadIdx.x == 0) out[blockIdx.x] = ok;
  }
  const int tile = blockIdx.x * VISIT_WARPS + threadIdx.x / 32;
  if (tile >= tiles) return;
  const int lane = threadIdx.x & 31;
  const int32_t* sown = seg_own + int64_t(b) * n_own;
  const int r1 = min(tile * own + own, n_own);
  int lo = INT_MAX, hi = INT_MIN;
  for (int r = tile * own + lane; r < r1; r += 32) {
    lo = min(lo, sown[r]);
    hi = max(hi, sown[r]);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  const int j0 = warp_search(soth, 0, n_oth, [lo](int s) { return s >= lo; });
  const int j1 = warp_search(soth, j0, n_oth, [hi](int s) { return s > hi; });
  if (lane == 0)
    *reinterpret_cast<int2*>(out + VISIT_CHUNKS + 2 * tile) =
        j0 < j1 ? make_int2(j0 / TILE, (j1 - 1) / TILE) : make_int2(0, -1);
}

}  // namespace

int launch_visit(const int32_t* seg_own, int n_own, const int32_t* seg_oth, int n_oth, int b,
                 int own, int32_t* visit, cudaStream_t stream) {
  const int tiles = (n_own + own - 1) / own;
  const int blocks = (tiles + VISIT_WARPS - 1) / VISIT_WARPS;
  const dim3 grid(blocks > VISIT_CHUNKS ? blocks : VISIT_CHUNKS, b);
  seg_attn_visit_ranges<<<grid, VISIT_NT, 0, stream>>>(seg_own, n_own, seg_oth, n_oth, own, visit);
  return int(cudaGetLastError());
}

}  // namespace wct::seg_bwd

// Ints of the visit pre-pass's output for b scenes of n_own own rows (own
// tiles of TILE rows or more).
extern "C" int64_t wct_segment_attention_visit_ints(int b, int n_own) {
  return wct::seg_bwd::visit_ints(b, n_own, wct::seg_bwd::TILE);
}
