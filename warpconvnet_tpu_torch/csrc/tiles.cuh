// Row-segment copies and tile flushes shared by the implicit-GEMM kernels.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace wct {

using bf16 = __nv_bfloat16;

// Copy 16 consecutive bf16 (one row segment) from global to shared memory:
// two 16-byte loads when the caller has checked alignment (VEC), else
// element by element. Elements at and past n_ok (a ragged channel edge, or
// n_ok <= 0 for a missing row) are zero.
template <bool VEC>
__device__ __forceinline__ void copy16(bf16* dst, const bf16* src, int n_ok) {
  if (VEC && n_ok >= 16) {
    reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(src)[0];
    reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(src)[1];
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) dst[j] = j < n_ok ? src[j] : __float2bfloat16(0.f);
  }
}

// True when every row segment of 16 bf16 can move as two 16-byte vectors:
// both row widths are multiples of 8 and the base pointers 16-byte aligned.
inline bool vec_ok(int c0, int c1, const void* p0, const void* p1, const void* p2 = nullptr) {
  auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return c0 % 8 == 0 && c1 % 8 == 0 && al(p0) && al(p1) && (p2 == nullptr || al(p2));
}

// Add a ROWS x COLS fp32 tile staged in shared memory (row stride ld) into
// out (row stride out_ld) with atomicAdd, by the NT threads of the block;
// entries past n_rows or n_cols are skipped. vec4: out_ld is a multiple of
// 4 and out 16-byte aligned, so four columns go as one float4 atomic
// (sm_90), a quarter of the atomic operations.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void atomic_add_tile(float* out, int64_t out_ld, const float* tile,
                                                int ld, int n_rows, int n_cols, bool vec4) {
  const int t = threadIdx.x;
  if (vec4) {
    for (int idx = t; idx < ROWS * COLS / 4; idx += NT) {
      const int r = idx / (COLS / 4), c = (idx % (COLS / 4)) * 4;
      if (r < n_rows && c < n_cols) {
        const float* s = tile + r * ld + c;
        atomicAdd(reinterpret_cast<float4*>(out + r * out_ld + c),
                  make_float4(s[0], s[1], s[2], s[3]));
      }
    }
  } else {
    for (int idx = t; idx < ROWS * COLS; idx += NT) {
      const int r = idx / COLS, c = idx % COLS;
      if (r < n_rows && c < n_cols) atomicAdd(out + r * out_ld + c, tile[r * ld + c]);
    }
  }
}

}  // namespace wct
