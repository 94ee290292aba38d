// Kernel-map probe: table[b, k, o] = scene-local row i of the input with
// in_coords[b, i] == stride * out_coords[b, o] + offsets[k], or -1.
//
// Replaces: warpconvnet_tpu/kernels/sorted_search.py `_probe_kernel_mz`
// with its entry `sorted_probe_batched_mz` (:288-682), as called from
// warpconvnet_tpu/ops/kernel_map.py `build_pair_tables_batched`.
//
// What bounds it on the card: each query is a binary search of ~17 steps
// over one scene's sorted int64 keys (~1 MB for 131k rows), so it is bound
// by dependent L2 load latency, not by bandwidth or arithmetic.
//
// Design: one thread per (b, k, o), o fastest, so a warp probes 32
// neighbouring output rows under one offset. Their queries are nearly
// sorted, so the warp's search paths share their first steps and those
// loads hit the same cache lines. The TPU kernel's window DMA, ones-matmul
// rank, dy occupancy mask and -2 fallback tiles existed because Mosaic
// cannot gather; a Hopper thread loads keys[mid] directly. The query is
// formed from full coordinates in int64 and any coordinate outside
// +-(PAD_COORD - 1) gives -1, so a y + dy past the range cannot wrap into
// the next x plane (the masking kernel_map.py:385-392 needed on the TPU).
// Only the first in_nv[b] keys are searched, so pad rows never match.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPadCoord = 32767;

__device__ __forceinline__ int64_t coord_key(int64_t x, int64_t y, int64_t z) {
  // Same order as ops/keys.py coord_keys: (x * 65536 + y + 32768, z).
  return (x * 65536 + y + 32768) * (int64_t(1) << 32) + (z + (int64_t(1) << 31));
}

__global__ void probe_kernel(const int64_t* __restrict__ keys,     // [B, N]
                             const int32_t* __restrict__ in_nv,    // [B]
                             int n,
                             const int32_t* __restrict__ out_coords,  // [B, M, 3]
                             const int32_t* __restrict__ out_nv,   // [B]
                             int m,
                             const int32_t* __restrict__ offsets,  // [K, 3]
                             int k_vol, int sx, int sy, int sz,
                             int32_t* __restrict__ table,          // [B, K, M]
                             int64_t total) {
  for (int64_t idx = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; idx < total;
       idx += int64_t(gridDim.x) * blockDim.x) {
    const int o = int(idx % m);
    const int64_t bk = idx / m;
    const int k = int(bk % k_vol);
    const int b = int(bk / k_vol);
    int32_t result = -1;
    if (o < out_nv[b]) {
      const int32_t* oc = out_coords + (int64_t(b) * m + o) * 3;
      const int64_t qx = int64_t(sx) * oc[0] + offsets[k * 3 + 0];
      const int64_t qy = int64_t(sy) * oc[1] + offsets[k * 3 + 1];
      const int64_t qz = int64_t(sz) * oc[2] + offsets[k * 3 + 2];
      const int64_t lim = kPadCoord - 1;
      if (qx >= -lim && qx <= lim && qy >= -lim && qy <= lim && qz >= -lim &&
          qz <= lim) {
        const int64_t q = coord_key(qx, qy, qz);
        const int64_t* kb = keys + int64_t(b) * n;
        int lo = 0, hi = in_nv[b];  // lower bound in [0, nv)
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (kb[mid] < q) lo = mid + 1; else hi = mid;
        }
        if (lo < in_nv[b] && kb[lo] == q) result = lo;
      }
    }
    table[idx] = result;
  }
}

}  // namespace

extern "C" int wct_kernel_map_probe(const int64_t* keys, const int32_t* in_nv, int n,
                                    const int32_t* out_coords, const int32_t* out_nv,
                                    int m, const int32_t* offsets, int k_vol, int sx,
                                    int sy, int sz, int b, int32_t* table,
                                    cudaStream_t stream) {
  const int64_t total = int64_t(b) * k_vol * m;
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  const int blocks = int(want < 65535 * 8 ? want : 65535 * 8);
  probe_kernel<<<blocks, threads, 0, stream>>>(keys, in_nv, n, out_coords, out_nv, m,
                                               offsets, k_vol, sx, sy, sz, table, total);
  return int(cudaGetLastError());
}
