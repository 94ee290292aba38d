// Implicit-GEMM sparse-conv weight gradient:
//   dw[k] = sum_{b, o} x[b, table[b, k, o], :]^T g[b, o, :]      (-1 adds zero)
// x [B, N_in, C_in] and g [B, N_out, C_out] in fp32 or bf16, fp32
// accumulation, dw [K, C_in, C_out] fp32, summed over the batch.
//
// Replaces: warpconvnet_tpu/kernels/implicit_gemm.py `_igemm_wgrad_kernel`
// with its entry `implicit_gemm_wgrad` (:683-798, :1122-1209).
//
// The reduction runs over rows. The TPU kernel keeps all of dw resident in
// VMEM across a sequential grid; here blocks run in parallel, so each block
// owns one offset k, one 64 x 64 (C_in, C_out) tile of dw[k] and a chunk of
// output rows, accumulates its tile in fp32 registers over the chunk, and
// adds it into the zeroed dw with fp32 atomicAdd once at the end (option
// "atomics" rather than per-block partials and a second reduce launch: the
// flush is one 64 x 64 tile per block, a few thousand atomics per launch,
// and needs no scratch; the sum order, and so the last bits, vary between
// runs).
//
// What bounds it on the card: only the rows with a pair count. A block reads
// its chunk's table entries for offset k 64 at a time and compacts the valid
// (input row, output row) pairs into a shared list; each 32 pairs gather 32
// x rows and 32 g rows into shared memory for one rank-32 update. So the
// work done is the useful pairs (rounded up to 32 per chunk) x C_in x C_out
// x 2 FLOPs, and the row gathers, not the arithmetic, bound it: on a 2^3
// parity map, where each fine row has exactly one valid offset, a row tile
// would otherwise be 7/8 zeros. bf16 runs the updates on the tensor cores
// (WMMA 16x16x16, fp32 accumulation); fp32 on the CUDA cores.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "tiles.cuh"

namespace {

using wct::bf16;
using wct::copy16;

constexpr int TM = 64;        // table entries read per round, and the dw tile edge
constexpr int PAIRS = 32;     // pairs per rank-PAIRS update
constexpr int LIST = TM + PAIRS;  // list capacity: < PAIRS left + TM appended

// Walk rows [lo, hi) of table[b, k, :], compact the valid pairs into
// (src, dst) and call step(base, m) on each full group of PAIRS pairs and on
// the last partial group. Every thread of the block must call it. Returns
// true if any pair was seen.
template <typename Step>
__device__ __forceinline__ bool for_each_pair_group(const int32_t* __restrict__ trow, int lo,
                                                    int hi, int32_t* src, int32_t* dst,
                                                    int* count, Step step) {
  const int t = threadIdx.x;
  bool any = false;
  if (t == 0) *count = 0;
  __syncthreads();
  for (int o0 = lo; o0 < hi; o0 += TM) {
    if (t < TM) {
      const int o = o0 + t;
      const int32_t r = o < hi ? trow[o] : -1;
      if (r >= 0) {
        const int p = atomicAdd(count, 1);
        src[p] = r;
        dst[p] = o;
      }
    }
    __syncthreads();
    int n = *count;
    any |= n > 0;
    for (; n >= PAIRS; n -= PAIRS) step(n - PAIRS, PAIRS);
    __syncthreads();
    if (t == 0) *count = n;
    __syncthreads();
  }
  const int n = *count;
  if (n > 0) step(0, n);
  return any;
}

// ---- fp32: CUDA cores, 256 threads, 4 x 4 of the 64 x 64 dw tile each -------

constexpr int F_THREADS = 256;

__global__ void __launch_bounds__(F_THREADS)
igemm_wgrad_f32(const float* __restrict__ x, const float* __restrict__ g,
                const int32_t* __restrict__ table, float* __restrict__ dw,
                int n_in, int n_out, int k_vol, int c_in, int c_out, int chunk,
                int ci_tiles, int co_tiles) {
  __shared__ int32_t src[LIST], dst[LIST];
  __shared__ int count;
  __shared__ float Xs[PAIRS][TM];      // gathered x rows, [pair][c_in]
  __shared__ float Gs[PAIRS][TM + 4];  // gathered g rows, [pair][c_out]

  const int t = threadIdx.x;
  const int b = blockIdx.z;
  const int k = blockIdx.y / (ci_tiles * co_tiles);
  const int ci0 = (blockIdx.y / co_tiles % ci_tiles) * TM;
  const int co0 = (blockIdx.y % co_tiles) * TM;
  const int lo = blockIdx.x * chunk;
  const int hi = min(lo + chunk, n_out);
  const int ty = t / 16, tx = t % 16;
  const int l_row = t / 8, l_col = (t % 8) * 8;  // loader: 8 channels of one pair
  const float* xb = x + int64_t(b) * n_in * c_in;
  const float* gb = g + int64_t(b) * n_out * c_out;
  float acc[4][4] = {};

  auto step = [&](int base, int m) {
    const bool ok = l_row < m;
    const float* xr = ok ? xb + int64_t(src[base + l_row]) * c_in : nullptr;
    const float* gr = ok ? gb + int64_t(dst[base + l_row]) * c_out : nullptr;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ci = ci0 + l_col + j, co = co0 + l_col + j;
      Xs[l_row][l_col + j] = (ok && ci < c_in) ? xr[ci] : 0.f;
      Gs[l_row][l_col + j] = (ok && co < c_out) ? gr[co] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int p = 0; p < PAIRS; ++p) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[p][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Gs[p][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  };
  const int32_t* trow = table + (int64_t(b) * k_vol + k) * n_out;
  if (!for_each_pair_group(trow, lo, hi, src, dst, &count, step)) return;

  float* dk = dw + int64_t(k) * c_in * c_out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = ci0 + ty * 4 + i;
    if (ci >= c_in) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx * 4 + j;
      if (co < c_out) atomicAdd(dk + int64_t(ci) * c_out + co, acc[i][j]);
    }
  }
}

// ---- bf16: tensor cores, 4 warps of 32 x 32 of the dw tile -------------------

constexpr int H_THREADS = 128;
constexpr int S_LD = TM + 8;  // bf16 row stride of the gathered tiles
constexpr int C_LD = TM + 4;  // fp32 epilogue stride

template <bool VEC>
__global__ void __launch_bounds__(H_THREADS)
igemm_wgrad_bf16(const bf16* __restrict__ x, const bf16* __restrict__ g,
                 const int32_t* __restrict__ table, float* __restrict__ dw,
                 int n_in, int n_out, int k_vol, int c_in, int c_out, int chunk,
                 int ci_tiles, int co_tiles) {
  namespace wmma = nvcuda::wmma;
  __shared__ int32_t src[LIST], dst[LIST];
  __shared__ int count;
  __shared__ __align__(32) bf16 Xs[PAIRS][S_LD];  // [pair][c_in]
  __shared__ __align__(32) bf16 Gs[PAIRS][S_LD];  // [pair][c_out]
  __shared__ __align__(32) float Cs[TM][C_LD];

  const int t = threadIdx.x;
  const int b = blockIdx.z;
  const int k = blockIdx.y / (ci_tiles * co_tiles);
  const int ci0 = (blockIdx.y / co_tiles % ci_tiles) * TM;
  const int co0 = (blockIdx.y % co_tiles) * TM;
  const int lo = blockIdx.x * chunk;
  const int hi = min(lo + chunk, n_out);
  const int warp = t / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;  // (c_in, c_out) quadrant
  const int l_row = t / 4, l_col = (t % 4) * 16;         // loader: 16 channels of one pair
  const bf16* xb = x + int64_t(b) * n_in * c_in;
  const bf16* gb = g + int64_t(b) * n_out * c_out;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  auto step = [&](int base, int m) {
    const bool ok = l_row < m;
    const int32_t s = ok ? src[base + l_row] : 0;
    const int32_t d = ok ? dst[base + l_row] : 0;
    copy16<VEC>(&Xs[l_row][l_col], xb + int64_t(s) * c_in + ci0 + l_col,
                ok ? c_in - (ci0 + l_col) : 0);
    copy16<VEC>(&Gs[l_row][l_col], gb + int64_t(d) * c_out + co0 + l_col,
                ok ? c_out - (co0 + l_col) : 0);
    __syncthreads();
#pragma unroll
    for (int p = 0; p < PAIRS; p += 16) {
      // A = Xs^T (c_in x pairs), read column-major from the [pair][c_in] tile.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &Xs[p][wm + i * 16], S_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], &Gs[p][wn + j * 16], S_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  };
  const int32_t* trow = table + (int64_t(b) * k_vol + k) * n_out;
  if (!for_each_pair_group(trow, lo, hi, src, dst, &count, step)) return;

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + i * 16][wn + j * 16], acc[i][j], C_LD,
                              wmma::mem_row_major);
  __syncthreads();
  wct::atomic_add_tile<TM, TM, H_THREADS>(dw + (int64_t(k) * c_in + ci0) * c_out + co0, c_out,
                                          &Cs[0][0], C_LD, c_in - ci0, c_out - co0,
                                          c_out % 4 == 0);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and g share it). dw must be zeroed.
extern "C" int wct_igemm_wgrad(const void* x, const void* g, const int32_t* table, float* dw,
                               int b, int n_in, int n_out, int k_vol, int c_in, int c_out,
                               int dtype, cudaStream_t stream) {
  if (b == 0 || n_out == 0 || k_vol == 0 || c_in == 0 || c_out == 0) return 0;
  const int ci_tiles = (c_in + TM - 1) / TM, co_tiles = (c_out + TM - 1) / TM;
  // Rows per block: long chunks keep the atomics few; halve them until the
  // grid has about four blocks for each of the card's SMs.
  const int64_t per_chunk = int64_t(b) * k_vol * ci_tiles * co_tiles;
  int chunk = 4096;
  while (chunk > 256 && per_chunk * ((n_out + chunk - 1) / chunk) < 4 * 132) chunk /= 2;
  const dim3 grid((n_out + chunk - 1) / chunk, k_vol * ci_tiles * co_tiles, b);
  if (dtype == 0) {
    igemm_wgrad_f32<<<grid, F_THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), table, dw, n_in, n_out,
        k_vol, c_in, c_out, chunk, ci_tiles, co_tiles);
  } else if (dtype == 1) {
    const bf16* xh = static_cast<const bf16*>(x);
    const bf16* gh = static_cast<const bf16*>(g);
    if (wct::vec_ok(c_in, c_out, x, g))
      igemm_wgrad_bf16<true><<<grid, H_THREADS, 0, stream>>>(
          xh, gh, table, dw, n_in, n_out, k_vol, c_in, c_out, chunk, ci_tiles, co_tiles);
    else
      igemm_wgrad_bf16<false><<<grid, H_THREADS, 0, stream>>>(
          xh, gh, table, dw, n_in, n_out, k_vol, c_in, c_out, chunk, ci_tiles, co_tiles);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
