// Implicit-GEMM sparse-conv forward (K2):
//   out[b, o, :] = sum_k x[b, table[b, k, o], :] @ w[k]      (-1 adds zero)
// x [B, N_in, C_in] and w [K, C_in, C_out] in fp32 or bf16, fp32
// accumulation, out [B, N_out, C_out] in x's dtype, rounded once. The
// backward runs it again as dgrad on (g, w^T, rev).
//
// Replaces: warpconvnet_tpu/kernels/implicit_gemm.py `_igemm_kernel` with
// its entry `implicit_gemm_fwd` (:546-680, :1022-1119), and the TPU
// experiments computing the same function (scripts/perf_v4.py
// `_kernel_v4`, scripts/perf_ablate.py `kernel`).
//
// What bounds it on the card: the bytes of the gathered rows (each useful
// pair reads one x row, L2-resident for the most part) and the weight
// slices each tile reads for each of its offsets, against the tile work's
// tensor-core operations, (non-empty tile-offset pairs) x 64 x C_in x C_out
// x 2. A tile of 64 rows in the index order of a sparse surface map meets
// nearly every offset while each row has about three pairs (9.7x the
// useful pairs at the bench's L0 3^3 map); in the map's row order
// (`order`, rows grouped by their offset mask) it meets about 2x.
//
// Design (igemm.cuh): one block per (one or two 64-row tiles in the map's
// order, chunk of up to 256 output columns, scene). It reads the tiles'
// slab of table entries once, lists the offsets with a pair, and walks the
// (offset, 64-channel slice) steps through a ring of shared-memory stages
// into wgmma (bf16: a warpgroup a tile, the whole output width of the
// chunk in registers so each x row is gathered once per tile; two tiles
// share the weight slices above 128 columns). The rows arrive by cp.async
// 16-byte copies; each step's weight slice by one bulk copy (TMA) from a
// weight image that a small kernel lays out first in the ring's swizzled
// layout, in place of 768-2048 cp.async copies a step. The epilogue
// writes each row once through the order, rounded once: no atomics,
// deterministic, and the same bits under any order. fp32 keeps CUDA-core
// FMAs over 64 x 64 tiles with the same rows and offset list. The TPU
// kernel's window DMAs, one-hot matmul gathers, overflow residual pass,
// identity fast path and 128-lane channel padding existed because Mosaic
// cannot gather rows by index; here a row is gathered by its index.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "igemm.cuh"

namespace {

using namespace wct::igemm;

__global__ void __launch_bounds__(F_THREADS)
igemm_fwd_f32(const float* __restrict__ x, const float* __restrict__ w,
              const int32_t* __restrict__ table, const int32_t* __restrict__ order,
              float* __restrict__ out, int n_in, int n_out, int k_vol, int c_in, int c_out,
              bool w_trans, unsigned long long* work) {
  __shared__ Slab<BM> sl;
  __shared__ F32Smem sm;
  gather_gemm_f32(sl, sm, x, w, table, order, out, blockIdx.z, blockIdx.x * BM, blockIdx.y * 64,
                  n_in, n_out, k_vol, c_in, c_out, false, w_trans, work);
}

template <int W, int NWG>
constexpr int kStages = Ring<W, NWG>::stages(3, int(sizeof(Slab<NWG * BM>)));

template <int W, int NWG>
__global__ void __launch_bounds__(NWG * WG, 1)
igemm_fwd_bf16(const bf16* __restrict__ x, const unsigned char* __restrict__ wimg,
               const int32_t* __restrict__ table, const int32_t* __restrict__ order,
               bf16* __restrict__ out, int n_in, int n_out, int k_vol, int c_in, int c_out,
               bool vec, unsigned long long* work) {
  __shared__ Slab<NWG * BM> sl;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024u - smem_addr(smem_raw) % 1024u) % 1024u);
  gather_gemm_bf16<W, NWG, kStages<W, NWG>>(sl, ring, x, wimg, table, order, out, blockIdx.z,
                                            blockIdx.x * NWG * BM, blockIdx.y, gridDim.y, n_in,
                                            n_out, k_vol, c_in, c_out, vec, work);
}

template <int W, int NWG>
cudaError_t launch_bf16(const bf16* x, const unsigned char* w, const int32_t* table,
                        const int32_t* order, bf16* out, int b, int n_in, int n_out, int k_vol,
                        int c_in, int c_out, int n_chunks, bool vec,
                        unsigned long long* work, cudaStream_t stream) {
  const int bytes = 1024 + kStages<W, NWG> * Ring<W, NWG>::STAGE;
  const cudaError_t err = allow_smem<igemm_fwd_bf16<W, NWG>>(bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_out + NWG * BM - 1) / (NWG * BM), n_chunks, b);
  igemm_fwd_bf16<W, NWG><<<grid, NWG * WG, bytes, stream>>>(x, w, table, order, out, n_in,
                                                            n_out, k_vol, c_in, c_out, vec, work);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_width(const bf16* x, const unsigned char* w, const int32_t* table,
                         const int32_t* order, bf16* out, int b, int n_in, int n_out, int k_vol,
                         int c_in, int c_out, int n_chunks, bool vec,
                         unsigned long long* work, cudaStream_t stream) {
  if (warpgroups(W, n_out, n_chunks * b) == 2)
    return launch_bf16<W, 2>(x, w, table, order, out, b, n_in, n_out, k_vol, c_in, c_out,
                             n_chunks, vec, work, stream);
  return launch_bf16<W, 1>(x, w, table, order, out, b, n_in, n_out, k_vol, c_in, c_out,
                           n_chunks, vec, work, stream);
}

}  // namespace

// Bytes of the scratch wct_igemm_fwd needs for bf16 (the weight image) at
// n_out output rows of b scenes.
extern "C" int64_t wct_igemm_image_bytes(int k_vol, int c_in, int c_out, int n_out, int b) {
  int nc = 0;
  const int width = chunk_width(c_out, n_out, b, &nc);
  return image_bytes(k_vol, c_in, width, nc);
}

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it). w: [K, c_in,
// c_out], or with w_trans [K, c_out, c_in], whose transpose the product
// takes (dgrad). order: [B, N_out] int32, each scene's rows in the order
// the tiles take them (a permutation of 0 .. N_out - 1), or null for the
// index order. img: bf16 scratch of wct_igemm_image_bytes bytes, 16-byte
// aligned (null for fp32). work: one counter, to which the launch adds its
// tile work (64 rows for each (tile, offset) computed), or null.
extern "C" int wct_igemm_fwd(const void* x, const void* w, const int32_t* table,
                             const int32_t* order, void* out, void* img, int b, int n_in,
                             int n_out, int k_vol, int c_in, int c_out, int w_trans, int dtype,
                             unsigned long long* work, cudaStream_t stream) {
  if (b == 0 || n_out == 0 || c_out == 0) return 0;
  if (dtype == 0) {
    const dim3 grid((n_out + BM - 1) / BM, (c_out + 63) / 64, b);
    igemm_fwd_f32<<<grid, F_THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), table, order,
        static_cast<float*>(out), n_in, n_out, k_vol, c_in, c_out, w_trans != 0, work);
    return int(cudaGetLastError());
  }
  if (dtype != 1) return int(cudaErrorInvalidValue);
  const bf16* xh = static_cast<const bf16*>(x);
  const bf16* wh = static_cast<const bf16*>(w);
  bf16* oh = static_cast<bf16*>(out);
  const bool vec = wct::igemm::vec_ok(c_in, c_out, x, w, out);
  int nc = 0;
  const int width = chunk_width(c_out, n_out, b, &nc);
  unsigned char* wimg = static_cast<unsigned char*>(img);
  pack_weights<<<k_vol * ((c_in + BK - 1) / BK) * nc, 256, 0, stream>>>(
      wh, wimg, k_vol, c_in, c_out, width, nc, false, w_trans != 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
#define WCT_W(WIDTH)                                                                         \
  case WIDTH:                                                                                \
    return int(launch_width<WIDTH>(xh, wimg, table, order, oh, b, n_in, n_out, k_vol, c_in, \
                                   c_out, nc, vec, work, stream));
  switch (width) {
    WCT_W(32) WCT_W(64) WCT_W(96) WCT_W(128) WCT_W(160) WCT_W(192) WCT_W(224) WCT_W(256)
    default: return int(cudaErrorInvalidValue);
  }
#undef WCT_W
}
