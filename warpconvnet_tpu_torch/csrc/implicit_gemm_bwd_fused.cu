// Fused backward of a sparse conv over a symmetric self-map (in and out are
// one coordinate set, offsets[K-1-k] == -offsets[k], so rev[k] ==
// table[K-1-k]):
//   dx[b, i] = sum_k g[b, table[b, k, i]] @ w[K-1-k]^T
//   dw[k]    = sum_{b, i} x[b, table[b, k, i]]^T @ g[b, i]     (-1 adds zero)
// x [B, N, C_in], g [B, N, C_out], w [K, C_in, C_out] in fp32 or bf16, fp32
// accumulation; dx [B, N, C_in] in x's dtype (rounded once), dw [K, C_in,
// C_out] fp32.
//
// Replaces: warpconvnet_tpu/kernels/implicit_gemm.py `_igemm_bwd_fused_kernel`
// with its entry `implicit_gemm_bwd_fused` (:801-1020, :1212-1341).
//
// Design: a block walks the K offsets for its rows and one 64-wide slice of
// C_in. For each offset it loads table[b, k, rows] once, skips the offset
// when none of its rows has a pair, and with that one index load gathers
// both g rows (for dx) and x rows (for dw):
//   - dx += G_k @ w[K-1-k]^T, accumulated in fp32 registers across all
//     offsets and written once at the end (rounded once for bf16);
//   - dw[k] += X_k^T @ g over its rows, for its C_in slice, added into the
//     zeroed dw with fp32 atomicAdd.
// bf16 (the training path) runs both products on the tensor cores (WMMA
// 16x16x16) in blocks of 8 warps over a 256-row chunk: dx is dense over the
// chunk (a warp whose 32 rows have no pair skips its products), dw runs
// over the offset's valid pairs only, compacted into a shared list, and is
// flushed once per (chunk, offset, 64-wide C_out slice). fp32 runs on the
// CUDA cores in blocks over one 64-row tile, with dw dense over the tile
// and flushed once per (tile, offset).
// The TPU kernel's window DMAs, shared one-hot gather, identity fast path
// and overflow residual passes served Mosaic's lack of a row gather; here
// rows are gathered by index.
//
// Slicing and what bounds it: the C_in slice of 64 bounds the dx
// accumulator (bf16: 256 x 64 fp32, 64 registers a thread) and C_out is
// streamed in slices (bf16: 32 for dx, 64 for dw; fp32: 16), so the
// operands fit at any width (384 -> 256 included; bf16 asks for 68 KB of
// dynamic shared memory) at the cost of re-gathering the g rows once per
// C_in slice. bf16 is bound by the dense dx tile work (every row of a
// chunk with a pair, as in K2) and the g row gathers; its dw work is the
// useful pairs, and its atomics are (non-empty chunk-offset pairs) x C_in x
// C_out. On a 3^3 surface map the split pair (K2-dgrad + K3) is still a
// little faster: K2 skips empty (64-row tile, offset) pairs, where this
// kernel can only skip 32-row warp slices, and runs more blocks per SM.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "tiles.cuh"

namespace {

using wct::bf16;
using wct::copy16;

constexpr int BM = 64;  // rows per tile
constexpr int BC = 64;  // C_in per block

// Load the tile's table entries of offset k into rows[]; true if any is
// valid. The leading barrier keeps the previous offset's readers of rows[]
// and of the gathered tiles ahead of the overwrite.
__device__ __forceinline__ bool load_rows(const int32_t* __restrict__ table, int32_t* rows,
                                          int b, int k, int k_vol, int n, int m0) {
  const int t = threadIdx.x;
  __syncthreads();
  int valid = 0;
  if (t < BM) {
    const int o = m0 + t;
    const int32_t r = o < n ? table[(int64_t(b) * k_vol + k) * n + o] : -1;
    rows[t] = r;
    valid = r >= 0;
  }
  return __syncthreads_or(valid);
}

// ---- fp32: CUDA cores, 256 threads ------------------------------------------

constexpr int F_THREADS = 256;
constexpr int F_BK = 16;  // C_out per slice

__global__ void __launch_bounds__(F_THREADS)
igemm_bwd_fused_f32(const float* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ w, const int32_t* __restrict__ table,
                    float* __restrict__ dx, float* __restrict__ dw,
                    int n, int k_vol, int c_in, int c_out) {
  __shared__ int32_t rows[BM];
  __shared__ float Xs[BM][BC];           // gathered x rows [row][c_in]
  __shared__ float Ag[F_BK][BM];         // gathered g rows, transposed [c_out][row]
  __shared__ float Gt[BM][F_BK];         // the tile's own g rows [row][c_out]
  __shared__ float Wt[F_BK][BC + 4];     // w[K-1-k]^T slice [c_out][c_in]

  const int t = threadIdx.x;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int ci0 = blockIdx.y * BC;
  const int ty = t / 16, tx = t % 16;    // dx: rows ty*4.., c_in tx*4..
  const int d_co = t % F_BK, d_ci = (t / F_BK) * 4;  // dw: one c_out, 4 c_in
  const int64_t base = int64_t(b) * n;
  float acc[4][4] = {};

  for (int k = 0; k < k_vol; ++k) {
    if (!load_rows(table, rows, b, k, k_vol, n, m0)) continue;
    // x rows of this offset, c_in slice: 16 elements a thread.
    for (int idx = t; idx < BM * BC; idx += F_THREADS) {
      const int r = idx / BC, c = idx % BC;
      const int32_t s = rows[r];
      Xs[r][c] = (s >= 0 && ci0 + c < c_in) ? x[(base + s) * c_in + ci0 + c] : 0.f;
    }
    const float* wk = w + int64_t(k_vol - 1 - k) * c_in * c_out;
    for (int co0 = 0; co0 < c_out; co0 += F_BK) {
      for (int idx = t; idx < BM * F_BK; idx += F_THREADS) {
        const int r = idx / F_BK, c = idx % F_BK;
        const int32_t s = rows[r];
        const int o = m0 + r, co = co0 + c;
        const bool c_ok = co < c_out;
        Ag[c][r] = (s >= 0 && c_ok) ? g[(base + s) * c_out + co] : 0.f;
        Gt[r][c] = (o < n && c_ok) ? g[(base + o) * c_out + co] : 0.f;
      }
      for (int idx = t; idx < F_BK * BC; idx += F_THREADS) {
        const int c = idx / BC, ci = idx % BC;
        Wt[c][ci] = (co0 + c < c_out && ci0 + ci < c_in)
                        ? wk[int64_t(ci0 + ci) * c_out + co0 + c] : 0.f;
      }
      __syncthreads();
      // dx tile += G_k[:, slice] @ w[K-1-k][c_in slice, slice]^T
#pragma unroll
      for (int kk = 0; kk < F_BK; ++kk) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Ag[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Wt[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      // dw[k][c_in slice, slice] += X_k^T @ g_tile[:, slice]
      float part[4] = {};
#pragma unroll 8
      for (int r = 0; r < BM; ++r) {
        const float gv = Gt[r][d_co];
#pragma unroll
        for (int i = 0; i < 4; ++i) part[i] = fmaf(Xs[r][d_ci + i], gv, part[i]);
      }
      const int co = co0 + d_co;
      if (co < c_out) {
        float* dk = dw + int64_t(k) * c_in * c_out;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ci = ci0 + d_ci + i;
          if (ci < c_in) atomicAdd(dk + int64_t(ci) * c_out + co, part[i]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = m0 + ty * 4 + i;
    if (o >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = ci0 + tx * 4 + j;
      if (ci < c_in) dx[(base + o) * c_in + ci] = acc[i][j];
    }
  }
}

// ---- bf16: tensor cores, 8 warps, 256-row chunks -----------------------------
//
// A block owns a chunk of 4 tiles (256 rows) and one 64-wide C_in slice;
// its dx (256 x 64 fp32, 64 registers a thread) stays in registers across
// all offsets. Per offset, one index load of table[b, k, chunk] feeds
//   - dx: the chunk's g rows gathered densely (warps whose 32 rows have no
//     pair skip the products), times w[K-1-k]^T over C_out slices of 32;
//   - dw: the valid (x row, g row) pairs compacted into a list, 32 pairs a
//     rank-32 update per C_out slice of 64, flushed into dw once per
//     (chunk, offset, C_out slice).
// So dw's tile work is the useful pairs, not 64 rows per non-empty tile, and
// its atomics are a quarter of a per-tile flush.

constexpr int V_ROWS = 256;        // rows per chunk
constexpr int V_THREADS = 256;     // 8 warps, 32 chunk rows each for dx
constexpr int V_BK = 32;           // C_out per dx slice
constexpr int V_PAIRS = 32;        // pairs per dw update
constexpr int G_LD = V_BK + 8;     // bf16 strides, multiples of 8
constexpr int P_LD = BC + 8;
constexpr int DW_LD = BC + 4;      // fp32 strides, multiples of 4
constexpr int DX_LD = BC + 4;
// Dynamic shared memory, carved by hand; every piece a multiple of 32 bytes.
constexpr int GG_BYTES = V_ROWS * G_LD * 2;   // gathered g rows [row][c_out]
constexpr int WS_BYTES = BC * G_LD * 2;       // w[K-1-k] slice [c_in][c_out]
constexpr int XS_BYTES = V_PAIRS * P_LD * 2;  // pair x rows [pair][c_in]
constexpr int GT_BYTES = V_PAIRS * P_LD * 2;  // pair g rows [pair][c_out]
constexpr int DW_BYTES = BC * DW_LD * 4;      // dw share [c_in][c_out]
constexpr int OPS_BYTES = GG_BYTES + WS_BYTES + XS_BYTES + GT_BYTES + DW_BYTES;
constexpr int DX_BYTES = V_ROWS * DX_LD * 4;  // dx epilogue, over the operands
constexpr int V_SMEM = OPS_BYTES > DX_BYTES ? OPS_BYTES : DX_BYTES;

template <bool VEC>
__global__ void __launch_bounds__(V_THREADS)
igemm_bwd_fused_bf16(const bf16* __restrict__ x, const bf16* __restrict__ g,
                     const bf16* __restrict__ w, const int32_t* __restrict__ table,
                     bf16* __restrict__ dx, float* __restrict__ dw,
                     int n, int k_vol, int c_in, int c_out) {
  namespace wmma = nvcuda::wmma;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int32_t rows[V_ROWS], src[V_ROWS], dst[V_ROWS];
  __shared__ int count;
  bf16 (*Gg)[G_LD] = reinterpret_cast<bf16 (*)[G_LD]>(smem);
  bf16 (*Ws)[G_LD] = reinterpret_cast<bf16 (*)[G_LD]>(smem + GG_BYTES);
  bf16 (*Xs)[P_LD] = reinterpret_cast<bf16 (*)[P_LD]>(smem + GG_BYTES + WS_BYTES);
  bf16 (*Gt)[P_LD] = reinterpret_cast<bf16 (*)[P_LD]>(smem + GG_BYTES + WS_BYTES + XS_BYTES);
  float (*Dw)[DW_LD] =
      reinterpret_cast<float (*)[DW_LD]>(smem + GG_BYTES + WS_BYTES + XS_BYTES + GT_BYTES);
  float (*Dx)[DX_LD] = reinterpret_cast<float (*)[DX_LD]>(smem);

  const int t = threadIdx.x;
  const int lane = t % 32, warp = t / 32;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * V_ROWS;
  const int ci0 = blockIdx.y * BC;
  const int64_t base = int64_t(b) * n;
  const int wr = warp * 32;                            // dx: the warp's 32 chunk rows
  const int dw_ci = (warp / 2) * 16, dw_co = (warp % 2) * 32;  // dw: 16 c_in x 32 c_out

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k = 0; k < k_vol; ++k) {
    __syncthreads();  // the previous offset's readers of rows, src, dst, count
    if (t == 0) count = 0;
    __syncthreads();
    const int o = m0 + t;
    const int32_t r = o < n ? table[(int64_t(b) * k_vol + k) * n + o] : -1;
    rows[t] = r;
    if (r >= 0) {
      const int p = atomicAdd(&count, 1);
      src[p] = r;
      dst[p] = o;
    }
    if (!__syncthreads_or(r >= 0)) continue;  // no pair of this offset in the chunk
    const bool warp_busy = __any_sync(0xffffffffu, rows[wr + lane] >= 0);
    const int n_pairs = count;

    // dx (chunk rows x c_in slice) += G_k @ w[K-1-k]^T, C_out in slices of 32.
    const bf16* gs = g + (base + (r < 0 ? 0 : r)) * c_out;
    const int w_row = t / 2, w_col = (t % 2) * 16;  // threads < 128 stage Ws
    const bool w_ok = t < 2 * BC && ci0 + w_row < c_in;
    const bf16* wk = w + (int64_t(k_vol - 1 - k) * c_in + ci0 + (w_ok ? w_row : 0)) * c_out;
    for (int co0 = 0; co0 < c_out; co0 += V_BK) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = co0 + h * 16;
        copy16<VEC>(&Gg[t][h * 16], gs + c, r < 0 ? 0 : c_out - c);
      }
      if (t < 2 * BC) copy16<VEC>(&Ws[w_row][w_col], w_ok ? wk + co0 + w_col : w,
                                  w_ok ? c_out - (co0 + w_col) : 0);
      __syncthreads();
      if (warp_busy) {
#pragma unroll
        for (int kk = 0; kk < V_BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &Gg[wr + i * 16][kk], G_LD);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wmma::load_matrix_sync(fb, &Ws[j * 16][kk], G_LD);
#pragma unroll
            for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
          }
        }
      }
      __syncthreads();
    }

    // dw[k] (c_in slice x c_out) += sum over the chunk's pairs of x^T g,
    // C_out in slices of 64, 32 pairs at a time.
    const int p_row = (t % 128) / 4, p_col = (t % 4) * 16;  // loader: 16 channels of a pair
    float* dk = dw + int64_t(k) * c_in * c_out;
    for (int co0 = 0; co0 < c_out; co0 += BC) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> part[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(part[j], 0.f);
      for (int p0 = 0; p0 < n_pairs; p0 += V_PAIRS) {
        const bool ok = p0 + p_row < n_pairs;
        if (t < 128) {
          const int32_t s = ok ? src[p0 + p_row] : 0;
          copy16<VEC>(&Xs[p_row][p_col], x + (base + s) * c_in + ci0 + p_col,
                      ok ? c_in - (ci0 + p_col) : 0);
        } else {
          const int32_t d = ok ? dst[p0 + p_row] : 0;
          copy16<VEC>(&Gt[p_row][p_col], g + (base + d) * c_out + co0 + p_col,
                      ok ? c_out - (co0 + p_col) : 0);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < V_PAIRS; kk += 16) {
          // A = Xs^T (c_in x pairs), read column-major from [pair][c_in].
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
          wmma::load_matrix_sync(fa, &Xs[kk][dw_ci], P_LD);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, &Gt[kk][dw_co + j * 16], P_LD);
            wmma::mma_sync(part[j], fa, fb, part[j]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(&Dw[dw_ci][dw_co + j * 16], part[j], DW_LD,
                                wmma::mem_row_major);
      __syncthreads();
      wct::atomic_add_tile<BC, BC, V_THREADS>(dk + int64_t(ci0) * c_out + co0, c_out, &Dw[0][0],
                                              DW_LD, c_in - ci0, c_out - co0, c_out % 4 == 0);
    }
  }

  __syncthreads();  // the operand tiles are free for the dx epilogue
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(&Dx[wr + i * 16][j * 16], acc[i][j], DX_LD, wmma::mem_row_major);
  __syncthreads();
  for (int idx = t; idx < V_ROWS * BC; idx += V_THREADS) {
    const int rr = idx / BC, c = idx % BC;
    const int oo = m0 + rr, ci = ci0 + c;
    if (oo < n && ci < c_in) dx[(base + oo) * c_in + ci] = __float2bfloat16(Dx[rr][c]);
  }
}

template <bool VEC>
cudaError_t launch_bwd_fused_bf16(const bf16* x, const bf16* g, const bf16* w,
                                  const int32_t* table, bf16* dx, float* dw, int b, int n,
                                  int k_vol, int c_in, int c_out, cudaStream_t stream) {
  // Above 48 KB a block's shared memory must be asked for explicitly.
  const cudaError_t err = cudaFuncSetAttribute(
      igemm_bwd_fused_bf16<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, V_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + V_ROWS - 1) / V_ROWS, (c_in + BC - 1) / BC, b);
  igemm_bwd_fused_bf16<VEC><<<grid, V_THREADS, V_SMEM, stream>>>(x, g, w, table, dx, dw, n,
                                                                 k_vol, c_in, c_out);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, g, w and dx share it). dw must be
// zeroed; every row of dx is written.
extern "C" int wct_igemm_bwd_fused(const void* x, const void* g, const void* w,
                                   const int32_t* table, void* dx, float* dw, int b, int n,
                                   int k_vol, int c_in, int c_out, int dtype,
                                   cudaStream_t stream) {
  if (b == 0 || n == 0 || c_in == 0) return 0;
  const dim3 grid((n + BM - 1) / BM, (c_in + BC - 1) / BC, b);
  if (dtype == 0) {
    igemm_bwd_fused_f32<<<grid, F_THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(w), table, static_cast<float*>(dx), dw, n, k_vol, c_in,
        c_out);
  } else if (dtype == 1) {
    const bf16* xh = static_cast<const bf16*>(x);
    const bf16* gh = static_cast<const bf16*>(g);
    const bf16* wh = static_cast<const bf16*>(w);
    bf16* dxh = static_cast<bf16*>(dx);
    return int(wct::vec_ok(c_in, c_out, x, g, w)
                   ? launch_bwd_fused_bf16<true>(xh, gh, wh, table, dxh, dw, b, n, k_vol,
                                                 c_in, c_out, stream)
                   : launch_bwd_fused_bf16<false>(xh, gh, wh, table, dxh, dw, b, n, k_vol,
                                                  c_in, c_out, stream));
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
