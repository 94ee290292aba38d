// Kernel-map probe: table[b, k, o] = scene-local row i of the input with
// in_coords[b, i] == stride * out_coords[b, o] + offsets[k], or -1.
//
// Replaces: warpconvnet_tpu/kernels/sorted_search.py `_probe_kernel_mz`
// with its entry `sorted_probe_batched_mz` (:288-682), as called from
// warpconvnet_tpu/ops/kernel_map.py `build_pair_tables_batched`, and the
// plain probe `_probe_kernel` (:54) on offsets that form no grid.
//
// What bounds it on the card: writing the table (4 bytes an entry; the 7^3
// self-map of a bench scene pair is 360 MB, 0.107 ms at 3.35 TB/s) and, for
// small K, the latency of the chain a block walks (find its window, stage
// it, search it). So the searches run in shared memory, where a binary
// search in device memory for every entry would wait on ~17 dependent L2
// loads.
//
// Design, as the TPU kernel's: under one offset, consecutive output rows
// give sorted queries, so a tile of rows touches one contiguous window of
// the sorted keys.
//  1. One block takes kTile consecutive output rows of one scene and all K
//     offsets. The block reduces the minimum and maximum valid query key
//     over its rows and offsets (min and max, not first and last, so a
//     tile of unsorted rows stays exact and only widens the window); two
//     warps find the window [lo, hi) with 32-way searches in the scene's
//     first in_nv[b] keys, and the block stages keys[lo:hi) into shared
//     memory when it holds at most kWindow keys.
//  2. The offsets come grouped by (dx, dy) in lexicographic order, each
//     group's dz ascending with its slot k (the host builds this once:
//     `probe_groups` in kernels/sorted_search.py). A thread takes one row.
//     Its targets key(q + (dx, dy, dz)) then rise through the groups and
//     within each, so one pointer moves forward through the window: a
//     binary search where dx changes, a galloping search to the next
//     (x, y) run where only dy does, and a step or two within a run per dz.
//     For 7^3 that is 7 short binary searches a row in place of 343.
//  3. A window larger than kWindow (unsorted rows, a tile across far-apart
//     rows, a plane denser than shared memory) is walked the same way in
//     device memory, so the result stays exact; the block adds one to
//     counts[1] (and every tile with a valid query to counts[0]).
// kTile and kWindow were measured (tools/time_k1.py) against 256 rows and
// 2048 or 8192 keys: within 3% at 7^3 and 6% at 3^3 on the bench pair, but
// 2048 keys send nearly every 7^3 tile of a pair with 1.8x denser planes to
// device memory; 4096 keys keep a block under 48 KB, four blocks of 512
// threads an SM.
// Writes keep o fastest: a warp's stores to one slot k are coalesced. The
// query is formed from full coordinates in int64 and any coordinate outside
// +-(PAD_COORD - 1) gives -1, so a y + dy past the range cannot wrap into
// the next x plane. Pad output rows give -1.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPadCoord = 32767;
constexpr int64_t kLim = kPadCoord - 1;
constexpr int kTile = 512;     // output rows a block, one a thread
constexpr int kWindow = 4096;  // keys a block stages (32 KB)
constexpr int kWarps = kTile / 32;

__device__ __forceinline__ bool in_range(int64_t v) { return v >= -kLim && v <= kLim; }

// key(x, y, z) = row(x, y) + z + 2^31, in the order of ops/keys.py coord_keys:
// (x * 65536 + y + 32768, z) lexicographically.
__device__ __forceinline__ int64_t row_key(int64_t x, int64_t y) {
  return (x * 65536 + y + 32768) * (int64_t(1) << 32) + (int64_t(1) << 31);
}

// First i in [lo, hi) with a[i] >= t, else hi.
__device__ __forceinline__ int lower_bound(const int64_t* a, int lo, int hi, int64_t t) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < t) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// As lower_bound over [p, w), for an answer expected near p: doubling steps
// from p, then a binary search of the last step.
__device__ __forceinline__ int gallop(const int64_t* a, int p, int w, int64_t t) {
  int lo = p, hi = p, step = 1;
  while (hi < w && a[hi] < t) {
    lo = hi + 1;
    hi += step;
    step <<= 1;
  }
  return lower_bound(a, lo, hi < w ? hi : w, t);
}

// lower_bound over [0, n) by one warp: 32 probes a round, ~4 rounds for
// 131k keys in place of 17 dependent loads. Every lane returns the answer.
__device__ __forceinline__ int warp_lower_bound(const int64_t* __restrict__ a, int n,
                                                int64_t t, int lane) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int s = (hi - lo + 31) >> 5;
    const int p = lo + (lane + 1) * s - 1;
    const bool lt = p < hi && a[p] < t;
    const int c = __popc(__ballot_sync(0xffffffffu, lt));
    lo += c * s;
    hi = min(hi, lo + s - 1);
  }
  return lo;
}

// The smallest and the largest valid query key of one row over all groups
// (INT64_MAX / INT64_MIN if none is valid). Without range checks (a row
// whose every query is in range) they are the first group's first slot and
// the last group's last.
template <bool kChecked>
__device__ __forceinline__ void row_extent(int64_t ox, int64_t oy, int64_t oz,
                                           const int4* __restrict__ groups, int n_groups,
                                           const int2* __restrict__ slots, int64_t& mn,
                                           int64_t& mx) {
  for (int g = 0; g < n_groups && mn == LLONG_MAX; ++g) {
    const int4 gd = groups[g];
    const int64_t qx = ox + gd.x, qy = oy + gd.y;
    if (kChecked && (!in_range(qx) || !in_range(qy))) continue;
    for (int j = gd.z; j < gd.z + gd.w; ++j) {
      const int64_t qz = oz + slots[j].x;
      if (!kChecked || in_range(qz)) { mn = row_key(qx, qy) + qz; break; }
    }
  }
  for (int g = n_groups - 1; g >= 0 && mx == LLONG_MIN; --g) {
    const int4 gd = groups[g];
    const int64_t qx = ox + gd.x, qy = oy + gd.y;
    if (kChecked && (!in_range(qx) || !in_range(qy))) continue;
    for (int j = gd.z + gd.w - 1; j >= gd.z; --j) {
      const int64_t qz = oz + slots[j].x;
      if (!kChecked || in_range(qz)) { mx = row_key(qx, qy) + qz; break; }
    }
  }
}

// One output row against the window a[0, w), which holds the scene's keys
// from position base on: every slot's hit (base + i) or -1, written to
// out[k * m]. Targets rise through the groups, so p only moves forward and
// v = a[p] stays in a register. kChecked: test each query's range (only
// rows near the coordinate limit need it).
template <bool kChecked>
__device__ __forceinline__ void probe_row(const int64_t* a, int w, int base, int64_t ox,
                                          int64_t oy, int64_t oz, const int4* groups,
                                          int n_groups, const int2* slots, int32_t* out,
                                          int64_t m) {
  int p = 0;
  int prev_dx = INT_MIN;
  for (int g = 0; g < n_groups; ++g) {
    const int4 gd = groups[g];  // dx, dy, first slot, count
    const bool new_dx = gd.x != prev_dx;
    prev_dx = gd.x;
    const int64_t qx = ox + gd.x, qy = oy + gd.y;
    const bool xy_ok = !kChecked || (in_range(qx) && in_range(qy));
    const int64_t t0 = row_key(qx, qy) + oz;  // key(qx, qy, oz + dz) = t0 + dz
    int64_t v = 0;
    bool searched = false;
    for (int j = gd.z; j < gd.z + gd.w; ++j) {
      const int2 s = slots[j];  // dz, k
      int32_t r = -1;
      if (xy_ok && (!kChecked || in_range(oz + s.x))) {
        const int64_t t = t0 + s.x;
        if (!searched) {
          p = new_dx ? lower_bound(a, p, w, t) : gallop(a, p, w, t);
          v = p < w ? a[p] : LLONG_MAX;
          searched = true;
        }
        while (v < t) {
          ++p;
          v = p < w ? a[p] : LLONG_MAX;
        }
        if (v == t) r = base + p;
      }
      out[s.y * m] = r;
    }
  }
}

// desc: two header int4s, the offsets' extent (dx min, dx max, dy min,
// dy max) and (dz min, dz max, 0, 0); then the groups [G] int4 (dx, dy,
// first slot, count) in (dx, dy) order; then the slots [K] int2 (dz, k),
// by group, dz ascending.
__global__ void __launch_bounds__(kTile)
probe_kernel(const int64_t* __restrict__ keys,        // [B, N]
             const int32_t* __restrict__ in_nv,       // [B]
             int n,
             const int32_t* __restrict__ out_coords,  // [B, M, 3]
             const int32_t* __restrict__ out_nv,      // [B]
             int m,
             const int4* __restrict__ desc, int n_groups, int k_vol,
             int sx, int sy, int sz,
             int32_t* __restrict__ table,             // [B, K, M]
             unsigned long long* __restrict__ counts) {  // [2]: tiles, global tiles
  extern __shared__ int4 smem[];  // groups [G], window [kWindow] int64, slots [K]
  int4* s_groups = smem;
  int64_t* win = reinterpret_cast<int64_t*>(s_groups + n_groups);
  int2* s_slots = reinterpret_cast<int2*>(win + kWindow);
  __shared__ int64_t red_mn[kWarps], red_mx[kWarps];
  __shared__ int win_lo, win_hi;
  const int4* groups = desc + 2;
  const int2* slots = reinterpret_cast<const int2*>(groups + n_groups);
  const int b = blockIdx.y;
  const int o = blockIdx.x * kTile + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool valid = o < out_nv[b] && o < m;
  int64_t ox = 0, oy = 0, oz = 0;
  int64_t mn = LLONG_MAX, mx = LLONG_MIN;
  bool interior = false;
  if (valid) {
    const int32_t* oc = out_coords + (int64_t(b) * m + o) * 3;
    ox = int64_t(sx) * oc[0];
    oy = int64_t(sy) * oc[1];
    oz = int64_t(sz) * oc[2];
    const int4 exy = desc[0], ez = desc[1];
    interior = in_range(ox + exy.x) && in_range(ox + exy.y) && in_range(oy + exy.z) &&
               in_range(oy + exy.w) && in_range(oz + ez.x) && in_range(oz + ez.y);
    if (interior) row_extent<false>(ox, oy, oz, groups, n_groups, slots, mn, mx);
    else row_extent<true>(ox, oy, oz, groups, n_groups, slots, mn, mx);
  }
  for (int d = 16; d > 0; d >>= 1) {
    const int64_t a = __shfl_xor_sync(0xffffffffu, (long long)mn, d);
    const int64_t c = __shfl_xor_sync(0xffffffffu, (long long)mx, d);
    mn = a < mn ? a : mn;
    mx = c > mx ? c : mx;
  }
  if (lane == 0) {
    red_mn[warp] = mn;
    red_mx[warp] = mx;
  }
  __syncthreads();
  if (warp < 2) {
    int64_t v = warp == 0 ? (lane < kWarps ? red_mn[lane] : LLONG_MAX)
                          : (lane < kWarps ? red_mx[lane] : LLONG_MIN);
    for (int d = 16; d > 0; d >>= 1) {
      const int64_t u = __shfl_xor_sync(0xffffffffu, (long long)v, d);
      v = (warp == 0) == (u < v) ? u : v;
    }
    const int64_t* kb = keys + int64_t(b) * n;
    const int nv = in_nv[b];
    // An empty tile (no valid query) gets the empty window [0, 0).
    const int pos = warp == 0 ? (v == LLONG_MAX ? 0 : warp_lower_bound(kb, nv, v, lane))
                              : (v == LLONG_MIN ? 0 : warp_lower_bound(kb, nv, v + 1, lane));
    if (lane == 0) {
      if (warp == 0) win_lo = pos; else win_hi = pos;
      if (counts != nullptr && warp == 0 && v != LLONG_MAX) atomicAdd(counts, 1ull);
    }
  }
  __syncthreads();
  const int lo = win_lo, w = win_hi - lo;
  const int64_t* kb = keys + int64_t(b) * n + lo;
  const bool fits = w <= kWindow;
  if (counts != nullptr && threadIdx.x == 0 && !fits) atomicAdd(counts + 1, 1ull);
  for (int i = threadIdx.x; i < n_groups; i += kTile) s_groups[i] = groups[i];
  for (int i = threadIdx.x; i < k_vol; i += kTile) s_slots[i] = slots[i];
  if (fits) {
#pragma unroll 4
    for (int i = threadIdx.x; i < w; i += kTile) win[i] = kb[i];
  }
  __syncthreads();
  int32_t* out = table + int64_t(b) * k_vol * m + o;
  if (!valid) {
    if (o < m) {
      for (int k = 0; k < k_vol; ++k) out[int64_t(k) * m] = -1;
    }
  } else if (fits) {
    if (interior) probe_row<false>(win, w, lo, ox, oy, oz, s_groups, n_groups, s_slots, out, m);
    else probe_row<true>(win, w, lo, ox, oy, oz, s_groups, n_groups, s_slots, out, m);
  } else {
    if (interior) probe_row<false>(kb, w, lo, ox, oy, oz, s_groups, n_groups, s_slots, out, m);
    else probe_row<true>(kb, w, lo, ox, oy, oz, s_groups, n_groups, s_slots, out, m);
  }
}

}  // namespace

// counts: two counters (tiles with a valid query, tiles walked in device
// memory) to which the launch adds, or null (nothing counted).
extern "C" int wct_kernel_map_probe(const int64_t* keys, const int32_t* in_nv, int n,
                                    const int32_t* out_coords, const int32_t* out_nv,
                                    int m, const int32_t* desc, int n_groups, int k_vol,
                                    int sx, int sy, int sz, int b, int32_t* table,
                                    unsigned long long* counts, cudaStream_t stream) {
  if (int64_t(b) * k_vol * m == 0) return 0;
  const size_t smem = size_t(n_groups) * sizeof(int4) + kWindow * sizeof(int64_t) +
                      size_t(k_vol) * sizeof(int2);
  if (smem > 48 * 1024) {  // past 48 KB a kernel must opt in
    const cudaError_t e = cudaFuncSetAttribute(
        probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const dim3 grid((m + kTile - 1) / kTile, b);
  probe_kernel<<<grid, kTile, smem, stream>>>(keys, in_nv, n, out_coords, out_nv, m,
                                              reinterpret_cast<const int4*>(desc), n_groups,
                                              k_vol, sx, sy, sz, table, counts);
  return int(cudaGetLastError());
}
