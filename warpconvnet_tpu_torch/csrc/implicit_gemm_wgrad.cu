// Implicit-GEMM sparse-conv weight gradient (K3):
//   dw[k] = sum_{b, o} x[b, table[b, k, o], :]^T g[b, o, :]      (-1 adds zero)
// x [B, N_in, C_in] and g [B, N_out, C_out] in fp32 or bf16, fp32
// accumulation, dw [K, C_in, C_out] fp32, summed over the batch. The
// backward of every conv whose map is not a symmetric self-map (the
// strided and transposed convs) takes it beside K2 as dgrad.
//
// Replaces: warpconvnet_tpu/kernels/implicit_gemm.py `_igemm_wgrad_kernel`
// with its entry `implicit_gemm_wgrad` (:683-798, :1122-1209).
//
// What bounds it on the card: bytes. Each valid pair gathers one x row and
// one g row (C_in + C_out values) for 2 C_in C_out FLOPs, far below the
// tensor cores' rate at the MinkUNet18 step's widths; the table is read
// once. On a transposed map (the 2^3 map's reverse) each fine row has one
// valid offset of eight, so per offset 7 rows in 8 carry no pair.
//
// Design: the weight-gradient blocks of igemm.cuh (`dw_chunk_bf16`,
// `dw_chunk_f32`), which also run K4's dw, launched alone: one block per
// (offset k, input-channel chunk of width W, 64 NWG output channels, chunk
// of output rows, scene). A block compacts its chunk's valid pairs into
// shared memory, gathers their g and x rows 64 pairs a step through a
// cp.async ring into wgmma (bf16; fp32: 64 x 64 CUDA-core FMA tiles, the
// FMA numerics of the plain sum), keeps its share of dw[k] in registers
// over the whole chunk and adds it into the zeroed dw once, with float4
// atomics. So x, g and the table are read once per block column, the
// gathers touch only rows with a pair, and dw takes W x 64 NWG floats per
// block that holds a pair. Those flushes bound the wide shapes: at 128-256
// channels a 512-row chunk flushes more floats than it gathers, and the
// float4 atomics then run at a rate the chunk's gathers cannot hide. So
// the launch picks the chunk length from the occupancy of its blocks
// (igemm.cuh `plan_dw`): from DW_ROWS (fp32 F_DW_ROWS) down to 256 rows,
// halving while the grid holds less than one wave of resident blocks or
// while a shorter chunk lets more blocks share an SM. bf16 takes two
// warpgroups (128 output channels a block, so x rows and the table are
// read half as often) above 64 output channels when their grid still
// holds a wave. Timed on the MinkUNet18 step's eight shapes
// (tools/time_k2_k4.py, H100 SXM at 700 W), one wave beat two and four
// waves and the earlier kernel's rule of four blocks an SM, and the
// residency term took the 96 -> 96 transposed conv from 4096-row chunks
// (one block an SM) to 2048 (two), 0.054 to 0.046 ms. The atomics add in
// a varying order, so dw's last bits vary between runs.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "igemm.cuh"

namespace {

using namespace wct::igemm;

constexpr int STAGES = 3;  // ring stages of a bf16 block: a block runs few steps

__global__ void __launch_bounds__(F_THREADS)
igemm_wgrad_f32(const float* __restrict__ x, const float* __restrict__ g,
                const int32_t* __restrict__ table, float* __restrict__ dw, int n_in, int n_out,
                int k_vol, int c_in, int c_out, int rows, DwGrid dg,
                unsigned long long* dw_floats) {
  using PL = PairList<F_THREADS, F_DW_ROWS>;
  __shared__ int32_t pairs[PL::bytes(F_DW_ROWS) / 4];
  __shared__ F32DwSmem sm;
  PL pl(reinterpret_cast<unsigned char*>(pairs), rows);
  int k, ci, co0, rc, b;
  dg.decode(blockIdx.x, k, ci, co0, rc, b);
  const int lo = rc * rows, hi = lo + rows < n_out ? lo + rows : n_out;
  dw_chunk_f32(pl, sm, x, g, table, dw, b, k, ci * 64, co0, lo, hi, n_in, n_out, k_vol, c_in,
               c_out, dw_floats);
}

// Dynamic shared memory: the ring (1024-aligned), then the pair list of a
// chunk of `rows` rows.
template <int W, int NWG>
constexpr int smem_bytes(int rows) {
  return 1024 + STAGES * Ring<W, NWG>::STAGE + PairList<NWG * WG, DW_ROWS>::bytes(rows);
}

template <int W, int NWG>
__global__ void __launch_bounds__(NWG * WG, 1)
igemm_wgrad_bf16(const bf16* __restrict__ x, const bf16* __restrict__ g,
                 const int32_t* __restrict__ table, float* __restrict__ dw, int n_in, int n_out,
                 int k_vol, int c_in, int c_out, int rows, DwGrid dg, bool vec,
                 unsigned long long* dw_floats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024u - smem_addr(smem_raw) % 1024u) % 1024u);
  PairList<NWG * WG, DW_ROWS> pl(ring + STAGES * Ring<W, NWG>::STAGE, rows);
  int k, ci, co0, rc, b;
  dg.decode(blockIdx.x, k, ci, co0, rc, b);
  const int lo = rc * rows, hi = lo + rows < n_out ? lo + rows : n_out;
  dw_chunk_bf16<W, NWG, STAGES>(pl, ring, x, g, table, dw, b, k, ci * W, co0, lo, hi, n_in, n_out,
                                k_vol, c_in, c_out, vec, dw_floats);
}

// Writes the plan (its blocks, the rows of a chunk) before the launch.
cudaError_t launch_f32(const float* x, const float* g, const int32_t* table, float* dw, int b,
                       int n_in, int n_out, int k_vol, int c_in, int c_out, int* plan,
                       unsigned long long* dw_floats, cudaStream_t stream) {
  const DwPlan p = plan_dw<igemm_wgrad_f32>(b, n_out, F_DW_ROWS, c_out, 64, (c_in + 63) / 64,
                                            k_vol, F_THREADS, [](int) { return 0; });
  if (p.grid.blocks(b) > 0x7fffffff) return cudaErrorInvalidValue;
  plan[0] = int(p.grid.blocks(b));
  plan[1] = p.rows;
  igemm_wgrad_f32<<<unsigned(plan[0]), F_THREADS, 0, stream>>>(
      x, g, table, dw, n_in, n_out, k_vol, c_in, c_out, p.rows, p.grid, dw_floats);
  return cudaGetLastError();
}

template <int W, int NWG>
cudaError_t launch_bf16(const bf16* x, const bf16* g, const int32_t* table, float* dw, int b,
                        int n_in, int n_out, int k_vol, int c_in, int c_out, bool vec,
                        const DwPlan& p, int* plan, unsigned long long* dw_floats,
                        cudaStream_t stream) {
  if (p.grid.blocks(b) > 0x7fffffff) return cudaErrorInvalidValue;
  plan[0] = int(p.grid.blocks(b));
  plan[1] = p.rows;
  igemm_wgrad_bf16<W, NWG><<<unsigned(plan[0]), NWG * WG, smem_bytes<W, NWG>(p.rows), stream>>>(
      x, g, table, dw, n_in, n_out, k_vol, c_in, c_out, p.rows, p.grid, vec, dw_floats);
  return cudaGetLastError();
}

// Two warpgroups (128 output channels a block, so that x rows and the
// table are read half as often) above 64 output channels when their grid
// holds a wave of resident blocks, else one.
template <int W>
cudaError_t launch_width(const bf16* x, const bf16* g, const int32_t* table, float* dw, int b,
                         int n_in, int n_out, int k_vol, int c_in, int c_out, int n_ci, bool vec,
                         int* plan, unsigned long long* dw_floats, cudaStream_t stream) {
  cudaError_t err = allow_smem<igemm_wgrad_bf16<W, 1>>(smem_bytes<W, 1>(DW_ROWS));
  if (err == cudaSuccess) err = allow_smem<igemm_wgrad_bf16<W, 2>>(smem_bytes<W, 2>(DW_ROWS));
  if (err != cudaSuccess) return err;
  if (c_out > 64) {
    const DwPlan two = plan_dw<igemm_wgrad_bf16<W, 2>>(b, n_out, DW_ROWS, c_out, 128, n_ci, k_vol,
                                                      2 * WG, smem_bytes<W, 2>);
    if (two.full)
      return launch_bf16<W, 2>(x, g, table, dw, b, n_in, n_out, k_vol, c_in, c_out, vec, two,
                               plan, dw_floats, stream);
  }
  const DwPlan one = plan_dw<igemm_wgrad_bf16<W, 1>>(b, n_out, DW_ROWS, c_out, 64, n_ci, k_vol,
                                                    WG, smem_bytes<W, 1>);
  return launch_bf16<W, 1>(x, g, table, dw, b, n_in, n_out, k_vol, c_in, c_out, vec, one, plan,
                           dw_floats, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and g share it). dw must be zeroed.
// dw_floats: an int64 counter to which the blocks add the floats they add
// into dw, or null. plan (may be null): 2 ints written before the launch, its
// blocks and the rows of a chunk.
extern "C" int wct_igemm_wgrad(const void* x, const void* g, const int32_t* table, float* dw,
                               int b, int n_in, int n_out, int k_vol, int c_in, int c_out,
                               int dtype, unsigned long long* dw_floats, int* plan,
                               cudaStream_t stream) {
  int unused[2];
  if (plan == nullptr) plan = unused;
  plan[0] = plan[1] = 0;
  if (dtype != 0 && dtype != 1) return int(cudaErrorInvalidValue);
  if (b == 0 || n_out == 0 || k_vol == 0 || c_in == 0 || c_out == 0) return 0;
  if (dtype == 0)
    return int(launch_f32(static_cast<const float*>(x), static_cast<const float*>(g), table, dw,
                          b, n_in, n_out, k_vol, c_in, c_out, plan, dw_floats, stream));
  const bf16* xh = static_cast<const bf16*>(x);
  const bf16* gh = static_cast<const bf16*>(g);
  const bool vec = vec_ok(c_in, c_out, x, g, dw);
  int n_ci = 0;
  const int width = dw_width(c_in, &n_ci);
#define WCT_W(WIDTH)                                                                           \
  case WIDTH:                                                                                  \
    return int(launch_width<WIDTH>(xh, gh, table, dw, b, n_in, n_out, k_vol, c_in, c_out,     \
                                   n_ci, vec, plan, dw_floats, stream));
  switch (width) {
    WCT_W(32) WCT_W(64) WCT_W(96) WCT_W(128) WCT_W(160) WCT_W(192) WCT_W(224) WCT_W(256)
    default: return int(cudaErrorInvalidValue);
  }
#undef WCT_W
}
