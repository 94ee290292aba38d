// Implicit-GEMM sparse-conv forward:
//   out[b, o, :] = sum_k x[b, table[b, k, o], :] @ w[k]      (-1 adds zero)
// x [B, N_in, C_in] and w [K, C_in, C_out] in fp32 or bf16, fp32
// accumulation, out [B, N_out, C_out] in x's dtype.
//
// Replaces: warpconvnet_tpu/kernels/implicit_gemm.py `_igemm_kernel` with
// its entry `implicit_gemm_fwd` (:546-680, :1022-1119).
//
// What bounds it on the card: a block computes every row of its 64-row
// output tile for every offset that has at least one pair in the tile, so
// the work done is (non-empty tile-offset pairs) x 64 x C_in x C_out x 2
// FLOPs, several times the useful pairs on a sparse surface map. bf16 runs
// that on the tensor cores (mma.sync through WMMA, 16x16x16 bf16 ->
// fp32), where the row gathers and shared-memory staging bound it; fp32
// runs it on the CUDA cores, where FMA issue bounds it.
//
// Design: one block per 64-row x 64-column output tile of one scene. It
// walks the K offsets: loads the tile's 64 table entries, skips the offset
// if none is valid, then for each slice of C_in gathers the 64 input rows
// by index into shared memory (zero for -1 and past the ragged C_in edge),
// stages the matching w[k] slice, and accumulates in fp32 registers. The
// TPU kernel's window DMAs, one-hot matmul gathers, overflow residual pass,
// identity fast path and 128-lane channel padding all existed because
// Mosaic cannot gather rows by index; here a row is gathered by its index
// directly and ragged channel edges are masked. wgmma and TMA come later.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int BM = 64;  // output rows per block
constexpr int BN = 64;  // output channels per block

// ---- fp32: CUDA cores, 256 threads, 4x4 outputs a thread -------------------

constexpr int F_BK = 16;  // input channels per shared-memory slice
constexpr int F_THREADS = 256;

__global__ void __launch_bounds__(F_THREADS)
igemm_fwd_f32(const float* __restrict__ x,            // [B, N_in, C_in]
              const float* __restrict__ w,            // [K, C_in, C_out]
              const int32_t* __restrict__ table,      // [B, K, N_out]
              float* __restrict__ out,                // [B, N_out, C_out]
              int n_in, int n_out, int k_vol, int c_in, int c_out) {
  __shared__ int32_t rows[BM];
  __shared__ float As[F_BK][BM];      // gathered x slice, transposed
  __shared__ float Bs[F_BK][BN + 4];  // w[k] slice

  const int t = threadIdx.x;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ty = t / 16, tx = t % 16;  // 16 x 16 threads, 4 x 4 outputs each

  const float* xb = x + int64_t(b) * n_in * c_in;
  float acc[4][4] = {};

  // Loader roles: A (64 rows x 16 ch): 4 threads per row, 4 channels each.
  const int a_row = t / 4, a_col = (t % 4) * 4;
  // B (16 ch x 64 cols): 16 threads per channel row, 4 columns each.
  const int b_row = t / 16, b_col = (t % 16) * 4;

  for (int k = 0; k < k_vol; ++k) {
    int valid = 0;
    if (t < BM) {
      const int o = m0 + t;
      const int32_t r = o < n_out ? table[(int64_t(b) * k_vol + k) * n_out + o] : -1;
      rows[t] = r;
      valid = r >= 0;
    }
    if (!__syncthreads_or(valid)) continue;  // no pair of this offset in the tile

    const int32_t src = rows[a_row];
    const float* xrow = src >= 0 ? xb + int64_t(src) * c_in : nullptr;
    const float* wk = w + int64_t(k) * c_in * c_out;
    for (int c0 = 0; c0 < c_in; c0 += F_BK) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + a_col + j;
        As[a_col + j][a_row] = (xrow != nullptr && c < c_in) ? xrow[c] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + b_row;
        const int col = n0 + b_col + j;
        Bs[b_row][b_col + j] = (c < c_in && col < c_out) ? wk[int64_t(c) * c_out + col] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < F_BK; ++kk) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float* ob = out + int64_t(b) * n_out * c_out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = m0 + ty * 4 + i;
    if (o >= n_out) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < c_out) ob[int64_t(o) * c_out + col] = acc[i][j];
    }
  }
}

// ---- bf16: tensor cores, 4 warps of 32 x 32 outputs -------------------------

using bf16 = __nv_bfloat16;
constexpr int H_BK = 32;  // input channels per shared-memory slice
constexpr int H_THREADS = 128;
constexpr int A_LD = H_BK + 8;  // padded strides (elements), multiples of 8
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;

// Copy 16 consecutive bf16 (one row segment) from global to shared memory:
// two 16-byte loads when the caller has checked alignment (VEC), else
// element by element with the ragged edge and missing rows zeroed.
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

// VEC: C_in and C_out are multiples of 8 and x, w are 16-byte aligned, so
// every full 16-element row segment can move as two 16-byte vectors.
template <bool VEC>
__global__ void __launch_bounds__(H_THREADS)
igemm_fwd_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const int32_t* __restrict__ table, bf16* __restrict__ out,
               int n_in, int n_out, int k_vol, int c_in, int c_out) {
  namespace wmma = nvcuda::wmma;
  __shared__ int32_t rows[BM];
  __shared__ __align__(32) bf16 As[BM][A_LD];    // gathered x slice, row-major
  __shared__ __align__(32) bf16 Bs[H_BK][B_LD];  // w[k] slice, row-major
  __shared__ __align__(32) float Cs[BM][C_LD];   // epilogue staging

  const int t = threadIdx.x;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = t / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;  // warp's 32 x 32 quadrant

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const bf16* xb = x + int64_t(b) * n_in * c_in;
  // Loader roles: A (64 rows x 32 ch): 2 threads per row, 16 channels each.
  const int a_row = t / 2, a_col = (t % 2) * 16;
  // B (32 ch x 64 cols): 4 threads per channel row, 16 columns each.
  const int b_row = t / 4, b_col = (t % 4) * 16;
  const int b_ok = c_out - (n0 + b_col);  // columns of this segment inside C_out

  for (int k = 0; k < k_vol; ++k) {
    int valid = 0;
    if (t < BM) {
      const int o = m0 + t;
      const int32_t r = o < n_out ? table[(int64_t(b) * k_vol + k) * n_out + o] : -1;
      rows[t] = r;
      valid = r >= 0;
    }
    if (!__syncthreads_or(valid)) continue;  // no pair of this offset in the tile

    const int32_t src = rows[a_row];
    const bf16* xrow = xb + int64_t(src < 0 ? 0 : src) * c_in;
    const bf16* wk = w + int64_t(k) * c_in * c_out;
    for (int c0 = 0; c0 < c_in; c0 += H_BK) {
      const int a_ok = src < 0 ? 0 : c_in - (c0 + a_col);
      copy16<VEC>(&As[a_row][a_col], xrow + c0 + a_col, a_ok);
      const int c = c0 + b_row;
      copy16<VEC>(&Bs[b_row][b_col], wk + int64_t(c < c_in ? c : 0) * c_out + n0 + b_col,
                  c < c_in ? b_ok : 0);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < H_BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &As[wm + i * 16][kk], A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], &Bs[kk][wn + j * 16], B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + i * 16][wn + j * 16], acc[i][j], C_LD,
                              wmma::mem_row_major);
  __syncthreads();
  bf16* ob = out + int64_t(b) * n_out * c_out;
  for (int idx = t; idx < BM * BN; idx += H_THREADS) {
    const int r = idx / BN, col = idx % BN;
    const int o = m0 + r, oc = n0 + col;
    if (o < n_out && oc < c_out) ob[int64_t(o) * c_out + oc] = __float2bfloat16(Cs[r][col]);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it).
extern "C" int wct_igemm_fwd(const void* x, const void* w, const int32_t* table, void* out,
                             int b, int n_in, int n_out, int k_vol, int c_in, int c_out,
                             int dtype, cudaStream_t stream) {
  if (b == 0 || n_out == 0 || c_out == 0) return 0;
  const dim3 grid((n_out + BM - 1) / BM, (c_out + BN - 1) / BN, b);
  if (dtype == 0) {
    igemm_fwd_f32<<<grid, F_THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), table,
        static_cast<float*>(out), n_in, n_out, k_vol, c_in, c_out);
  } else if (dtype == 1) {
    const bool vec = c_in % 8 == 0 && c_out % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
    const bf16* xh = static_cast<const bf16*>(x);
    const bf16* wh = static_cast<const bf16*>(w);
    bf16* oh = static_cast<bf16*>(out);
    if (vec)
      igemm_fwd_bf16<true><<<grid, H_THREADS, 0, stream>>>(xh, wh, table, oh, n_in, n_out,
                                                          k_vol, c_in, c_out);
    else
      igemm_fwd_bf16<false><<<grid, H_THREADS, 0, stream>>>(xh, wh, table, oh, n_in, n_out,
                                                           k_vol, c_in, c_out);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
