// Fused backward of a sparse conv over a symmetric self-map (K4; in and
// out are one coordinate set, offsets[K-1-k] == -offsets[k], so rev[k] ==
// table[K-1-k]):
//   dx[b, i] = sum_k g[b, table[b, k, i]] @ w[K-1-k]^T
//   dw[k]    = sum_{b, i} x[b, table[b, k, i]]^T @ g[b, i]     (-1 adds zero)
// x [B, N, C_in], g [B, N, C_out], w [K, C_in, C_out] in fp32 or bf16, fp32
// accumulation; dx [B, N, C_in] in x's dtype (rounded once), dw [K, C_in,
// C_out] fp32. dx reads w[K-1-k]^T for offset k: fp32 from w itself,
// bf16 from the weight image that pack_weights lays out from it.
//
// Replaces: warpconvnet_tpu/kernels/implicit_gemm.py `_igemm_bwd_fused_kernel`
// with its entry `implicit_gemm_bwd_fused` (:801-1020, :1212-1341).
//
// What bounds it on the card: as K2 (implicit_gemm.cu), twice: dx's tile
// work over the table in the map's row order, and dw's useful pairs, each
// gathering one row of g or x (and one own row of g) a pair. A dw that
// flushes a C_in x C_out partial per (64-row tile, offset) costs as much
// again in fp32 atomics (about 85M float4 atomics a call at the bench's
// L0 3^3 map, 128 -> 96, in the earlier design).
//
// Design: one launch, blocks in two roles (the first blocks dx, the rest
// dw); both read the same table, neither waits for the other.
//   - dx: K2's block (igemm.cuh gather_gemm_*) on (g, w[K-1-k]^T, table)
//     over the map's row order: one or two 64-row tiles a block (two above
//     128 input channels, as K2 chooses), a warpgroup a tile with all of
//     C_in (up to 256 a chunk) in registers, the slab read once, the
//     non-empty offsets listed, g rows gathered by cp.async and the weight
//     slices (w[K-1-k]^T, laid out first by pack_weights) by one bulk copy
//     a step into a ring of shared-memory stages, wgmma on bf16, rounded
//     once and written once.
//   - dw: one block per (offset k, dx's chunk of input channels, 64 output
//     channels a warpgroup, chunk of 4096 rows of table[b, k] in index
//     order): the chunk's valid pairs are compacted into shared memory,
//     their g and x rows gathered 64 pairs a step through the same ring,
//     summed on the tensor cores as dw^T = G^T X into fp32 accumulators (a
//     warpgroup 64 output channels x the input chunk) over the whole
//     chunk, and added into the zeroed dw once per block through shared
//     memory with float4 atomics (blocks with no pair add nothing). At the
//     bench's L0 3^3 map (128 -> 96, 2 x 131072 rows) that is at most 3456
//     flushes, 5.3M float4 atomics, where earlier flushes per 256-row
//     chunk and offset took 85M.
// Sharing the gathers between the roles would tie dw's flush to dx's tiles
// (one C_in x C_out flush per tile and offset); kept apart, each role's
// gathers read only rows with a pair. The atomics add in a varying order,
// so dw's last bits vary between runs; dx is deterministic. fp32 runs both
// roles on the CUDA cores (64 x 64 FMA tiles, 256 threads).
// The TPU kernel's window DMAs, shared one-hot gather, identity fast path
// and overflow residual passes served Mosaic's lack of a row gather; here
// rows are gathered by index.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "igemm.cuh"

namespace {

using namespace wct::igemm;


__global__ void __launch_bounds__(F_THREADS)
igemm_bwd_fused_f32(const float* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ w, const int32_t* __restrict__ table,
                    const int32_t* __restrict__ order, float* __restrict__ dx,
                    float* __restrict__ dw, int n, int k_vol, int c_in, int c_out, int n_tiles,
                    int n_dx_chunks, int n_dx_blocks, DwGrid dg, unsigned long long* counts) {
  __shared__ union {
    struct {
      Slab<BM> sl;
      F32Smem sm;
    } dx;
    struct {
      int32_t pairs[PairList<F_THREADS, F_DW_ROWS>::bytes(F_DW_ROWS) / 4];
      F32DwSmem sm;
    } dw;
  } u;
  const int bid = blockIdx.x;
  if (bid < n_dx_blocks) {
    const int tile = bid % n_tiles, rest = bid / n_tiles;
    gather_gemm_f32(u.dx.sl, u.dx.sm, g, w, table, order, dx, rest / n_dx_chunks, tile * BM,
                    (rest % n_dx_chunks) * 64, n, n, k_vol, c_out, c_in, true, true, counts);
  } else {
    int k, ci, co0, rc, b;
    dg.decode(bid - n_dx_blocks, k, ci, co0, rc, b);
    const int lo = rc * F_DW_ROWS, hi = lo + F_DW_ROWS < n ? lo + F_DW_ROWS : n;
    PairList<F_THREADS, F_DW_ROWS> pl(reinterpret_cast<unsigned char*>(u.dw.pairs), F_DW_ROWS);
    dw_chunk_f32(pl, u.dw.sm, x, g, table, dw, b, k, ci * 64, co0, lo, hi, n, n, k_vol, c_in,
                 c_out, counts + 1);
  }
}

// The dynamic shared memory behind the ring: the slab (dx) or the pair
// list (dw); ring stages: three for one warpgroup (two blocks an SM up to
// 128 channels beside the 33 KB pair list), else as many as fit.
template <int NWG>
constexpr int kList = PairList<NWG * WG, DW_ROWS>::bytes(DW_ROWS);
template <int NWG>
constexpr int kScratch = int(sizeof(Slab<NWG * BM>)) > kList<NWG> ? int(sizeof(Slab<NWG * BM>))
                                                                  : kList<NWG>;
template <int W, int NWG>
constexpr int kStages = Ring<W, NWG>::stages(3, kScratch<NWG>);

template <int W, int NWG>
__global__ void __launch_bounds__(NWG * WG, 1)
igemm_bwd_fused_bf16(const bf16* __restrict__ x, const bf16* __restrict__ g,
                     const unsigned char* __restrict__ wimg, const int32_t* __restrict__ table,
                     const int32_t* __restrict__ order, bf16* __restrict__ dx,
                     float* __restrict__ dw, int n, int k_vol, int c_in, int c_out, int n_tiles,
                     int n_dx_chunks, int n_dx_blocks, DwGrid dg, bool vec,
                     unsigned long long* counts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024u - smem_addr(smem_raw) % 1024u) % 1024u);
  unsigned char* scratch = ring + kStages<W, NWG> * Ring<W, NWG>::STAGE;
  const int bid = blockIdx.x;
  if (bid < n_dx_blocks) {
    const int tile = bid % n_tiles, rest = bid / n_tiles;
    gather_gemm_bf16<W, NWG, kStages<W, NWG>>(
        *reinterpret_cast<Slab<NWG * BM>*>(scratch), ring, g, wimg, table, order, dx,
        rest / n_dx_chunks, tile * NWG * BM, rest % n_dx_chunks, n_dx_chunks, n, n, k_vol, c_out,
        c_in, vec, counts);
  } else {
    int k, ci, co0, rc, b;
    dg.decode(bid - n_dx_blocks, k, ci, co0, rc, b);
    const int lo = rc * DW_ROWS, hi = lo + DW_ROWS < n ? lo + DW_ROWS : n;
    PairList<NWG * WG, DW_ROWS> pl(scratch, DW_ROWS);
    dw_chunk_bf16<W, NWG, kStages<W, NWG>>(pl, ring, x, g, table, dw, b, k, ci * W, co0, lo, hi,
                                           n, n, k_vol, c_in, c_out, vec, counts + 1);
  }
}

template <int W, int NWG>
cudaError_t launch_bf16(const bf16* x, const bf16* g, const unsigned char* wimg,
                        const int32_t* table, const int32_t* order, bf16* dx, float* dw, int b,
                        int n, int k_vol, int c_in, int c_out, int n_dx_chunks, bool vec,
                        unsigned long long* counts, cudaStream_t stream) {
  const int bytes = 1024 + kStages<W, NWG> * Ring<W, NWG>::STAGE + kScratch<NWG>;
  const cudaError_t err = allow_smem<igemm_bwd_fused_bf16<W, NWG>>(bytes);
  if (err != cudaSuccess) return err;
  const int n_tiles = (n + NWG * BM - 1) / (NWG * BM);  // dx blocks a (chunk, scene)
  const int n_dx = n_tiles * n_dx_chunks * b;
  const DwGrid dg = DwGrid::make(n, DW_ROWS, c_out, 64 * NWG, n_dx_chunks, k_vol);
  const int64_t blocks = n_dx + dg.blocks(b);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  igemm_bwd_fused_bf16<W, NWG><<<unsigned(blocks), NWG * WG, bytes, stream>>>(
      x, g, wimg, table, order, dx, dw, n, k_vol, c_in, c_out, n_tiles, n_dx_chunks, n_dx, dg, vec,
      counts);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_width(const bf16* x, const bf16* g, const unsigned char* wimg,
                         const int32_t* table, const int32_t* order, bf16* dx, float* dw, int b,
                         int n, int k_vol, int c_in, int c_out, int n_dx_chunks, bool vec,
                         unsigned long long* counts, cudaStream_t stream) {
  if (warpgroups(W, n, n_dx_chunks * b) == 2)
    return launch_bf16<W, 2>(x, g, wimg, table, order, dx, dw, b, n, k_vol, c_in, c_out,
                             n_dx_chunks, vec, counts, stream);
  return launch_bf16<W, 1>(x, g, wimg, table, order, dx, dw, b, n, k_vol, c_in, c_out,
                           n_dx_chunks, vec, counts, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, g, w and dx share it). w: [K, C_in,
// C_out]. order: [B, N] int32, the row order of the dx tiles (a
// permutation of each scene's rows), or null for the index order. img:
// bf16 scratch of wct_igemm_image_bytes(K, C_out, C_in, N, B) bytes,
// 16-byte aligned (null for fp32). dw must be zeroed; every row of dx is
// written. counts: two counters, to which the launch adds dx's tile work
// (64 rows for each (tile, offset) computed) and the floats its dw blocks
// add into dw.
extern "C" int wct_igemm_bwd_fused(const void* x, const void* g, const void* w,
                                   const int32_t* table, const int32_t* order, void* dx,
                                   float* dw, void* img, int b, int n, int k_vol, int c_in,
                                   int c_out, int dtype, unsigned long long* counts,
                                   cudaStream_t stream) {
  if (b == 0 || n == 0 || c_in == 0) return 0;
  if (dtype == 0) {
    const int n_tiles = (n + BM - 1) / BM, n_dx_chunks = (c_in + 63) / 64;
    const int n_dx = n_tiles * n_dx_chunks * b;
    const DwGrid dg = DwGrid::make(n, F_DW_ROWS, c_out, 64, (c_in + 63) / 64, k_vol);
    const int64_t blocks = n_dx + dg.blocks(b);
    if (blocks > 0x7fffffff) return int(cudaErrorInvalidValue);
    igemm_bwd_fused_f32<<<unsigned(blocks), F_THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(w), table, order, static_cast<float*>(dx), dw, n, k_vol, c_in,
        c_out, n_tiles, n_dx_chunks, n_dx, dg, counts);
    return int(cudaGetLastError());
  }
  if (dtype != 1) return int(cudaErrorInvalidValue);
  const bf16* xh = static_cast<const bf16*>(x);
  const bf16* gh = static_cast<const bf16*>(g);
  const bf16* wh = static_cast<const bf16*>(w);
  bf16* dxh = static_cast<bf16*>(dx);
  const bool vec = vec_ok(c_in, c_out, x, g, w, dx);
  int nc = 0;
  const int width = chunk_width(c_in, n, b, &nc);
  // dx's weight image: w[K-1-k]^T for offset k.
  unsigned char* wimg = static_cast<unsigned char*>(img);
  pack_weights<<<k_vol * ((c_out + BK - 1) / BK) * nc, 256, 0, stream>>>(
      wh, wimg, k_vol, c_out, c_in, width, nc, true, true);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
#define WCT_W(WIDTH)                                                                           \
  case WIDTH:                                                                                  \
    return int(launch_width<WIDTH>(xh, gh, wimg, table, order, dxh, dw, b, n, k_vol, c_in,    \
                                   c_out, nc, vec, counts, stream));
  switch (width) {
    WCT_W(32) WCT_W(64) WCT_W(96) WCT_W(128) WCT_W(160) WCT_W(192) WCT_W(224) WCT_W(256)
    default: return int(cudaErrorInvalidValue);
  }
#undef WCT_W
}
