// Segment-masked attention backward: K9-dkv and K9-dq, the fp32 kernels and
// the C entry points of both dtypes (bf16 runs the tensor-core kernels of
// segment_attention_bwd_bf16.cu).
//
// With S = scale * Q K^T over the pairs of equal segments, P = exp(S - lse)
// (lse from K9's forward, +inf on rows that match nothing, so their P is
// exactly 0), di = rowsum(O * dO) (computed by the wrapper) and
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - di),
//   dQ = scale * dS K,  dK = scale * dS^T Q,
// per (scene, head). q, dO [B, Sq, H, D] and k, v [B, Skv, H, D] share fp32
// or bf16 and are read through their batch and row strides (each row's
// [H, D] block contiguous, 16-byte aligned), so the slices of a fused QKV
// projection need no copy. lse and di are [B, H, Sq] fp32. dq, dk and dv
// are contiguous [B, S, H, D] in the inputs' dtype; sums are fp32.
//
// Replaces: the backward passes of the stock Pallas TPU flash attention
// (jax.experimental.pallas.ops.tpu.flash_attention) that
// warpconvnet_tpu/nn/functional/flash_attention.py `segment_attention`
// calls with SegmentIds: `_flash_attention_dkv_kernel` (entry
// `_flash_attention_bwd_dkv`) and `_flash_attention_dq_kernel` (entry
// `_flash_attention_bwd_dq`). As there, two kernels, deterministic, with no
// atomics: K9-dkv owns a kv tile and walks the query tiles, K9-dq owns a
// query tile and walks the kv tiles.
//
// What bounds it on the card: operations. K9-dkv does 8 * D FLOPs per
// (query, kv) pair of one head with equal segments (S, dP, dV, dK), K9-dq
// 6 * D (S, dP, dQ); the function needs 10 * D. fp32 runs on the CUDA cores
// with fp32 FMA (no TF32: the JAX trunk is fp32); the FMA rate and
// shared-memory reads bound it.
//
// Design: one block of 256 threads (16 x 16) per (64-row own tile, head,
// scene). It marks, in a shared bitmask, every 64-row tile of the other
// side that holds a row whose segment lies in the own tile's [min, max]
// segment range (the forward's skip rule, in either direction); the other
// tiles hold no pair and are never loaded. The own operands are staged
// once, transposed (d-major); each visited tile is staged row-major. Each
// thread computes a 4 x 4 block of S and of dP (own rows tx * 4 + i, other
// rows ty * 4 + j: one 16-byte read of each operand feeds 16 FMAs), forms P
// and dS in registers, and writes them [other][own] to shared memory; the
// sums over the other rows then run with own rows ty * 4 + i and D / 16
// output columns a thread. wgmma, TMA and fusing the two passes come later.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "segment_attention_bwd.cuh"

namespace {

using wct::seg_bwd::Args;
using wct::seg_bwd::LOG2E;
using wct::seg_bwd::TILE;

constexpr int THREADS = 256;  // 16 x 16
constexpr int LDT = TILE + 4;  // row stride (floats) of d-major and [other][own] tiles

// Eight consecutive values of a row as fp32 (the caller keeps them 16-byte
// aligned), or zeros when !ok (p is then not read).
__device__ __forceinline__ void load8(float (&f)[8], const float* p, bool ok) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
  if (ok) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Rows [r0, r0 + TILE) of one head of x into dst:
// transposed (dst[d * LDT + r]; lanes run along rows, so the stores do not
// conflict) or row-major (dst[r * (D + 4) + d]; lanes run along d, so the
// loads coalesce). Rows past n are zero.
template <int D, bool TRANSPOSED>
__device__ __forceinline__ void stage(float* dst, const float* x, int64_t ss, int r0, int n) {
  for (int idx = threadIdx.x; idx < TILE * (D / 8); idx += THREADS) {
    const int r = TRANSPOSED ? idx % TILE : idx / (D / 8);
    const int c8 = TRANSPOSED ? idx / TILE : idx % (D / 8);
    float f[8];
    const bool ok = r0 + r < n;
    load8(f, x + int64_t(ok ? r0 + r : 0) * ss + c8 * 8, ok);
    if constexpr (TRANSPOSED) {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[(c8 * 8 + e) * LDT + r] = f[e];
    } else {
      float* o = dst + r * (D + 4) + c8 * 8;
      reinterpret_cast<float4*>(o)[0] = make_float4(f[0], f[1], f[2], f[3]);
      reinterpret_cast<float4*>(o)[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  }
}

// s[i][j] = sum_d ownT[d][tx * 4 + i] * oth[ty * 4 + j][d]: ownT d-major
// (a warp's 16 column groups are one 256-byte read), oth row-major (a
// 16-byte broadcast per half warp).
template <int D>
__device__ __forceinline__ void dot_tile(float (&s)[4][4], const float* ownT, const float* oth,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d0 = 0; d0 < D; d0 += 4) {
    float b[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(&oth[(ty * 4 + j) * (D + 4) + d0]);
      b[j][0] = x.x; b[j][1] = x.y; b[j][2] = x.z; b[j][3] = x.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 x = *reinterpret_cast<const float4*>(&ownT[(d0 + e) * LDT + tx * 4]);
      const float a[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j][e], s[i][j]);
    }
  }
}

// acc[i][c] += sum_r at[r][ty * 4 + i] * oth[r][col(c)] over the TILE rows
// r of the visited tile, at [other][own] (a 16-byte broadcast per half
// warp), oth row-major; column c of a thread is ch * 16 * VEC + tx * VEC + e.
template <int D>
__device__ __forceinline__ void acc_tile(float (&acc)[4][D / 16], const float* at,
                                         const float* oth, int ty, int tx) {
  constexpr int VEC = D / 16 < 4 ? D / 16 : 4;
  constexpr int CH = D / 16 / VEC;
#pragma unroll 4
  for (int r = 0; r < TILE; ++r) {
    const float4 x = *reinterpret_cast<const float4*>(&at[r * LDT + ty * 4]);
    const float a[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      float w[VEC];
      const float* src = &oth[r * (D + 4) + ch * 16 * VEC + tx * VEC];
      if constexpr (VEC == 4) {
        const float4 y = *reinterpret_cast<const float4*>(src);
        w[0] = y.x; w[1] = y.y; w[2] = y.z; w[3] = y.w;
      } else if constexpr (VEC == 2) {
        const float2 y = *reinterpret_cast<const float2*>(src);
        w[0] = y.x; w[1] = y.y;
      } else {
        w[0] = src[0];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][ch * VEC + e] = fmaf(a[i], w[e], acc[i][ch * VEC + e]);
    }
  }
}

// Rows ty * 4 + i of the own tile, columns as in acc_tile, times `mul`.
template <int D>
__device__ __forceinline__ void write_rows(float* out, const float (&acc)[4][D / 16], float mul,
                                           int own0, int n, int h, int hh, int b, int ty,
                                           int tx) {
  constexpr int VEC = D / 16 < 4 ? D / 16 : 4;
  constexpr int CH = D / 16 / VEC;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = own0 + ty * 4 + i;
    if (r >= n) continue;
    float* row = out + ((int64_t(b) * n + r) * h + hh) * D;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        row[ch * 16 * VEC + tx * VEC + e] = acc[i][ch * VEC + e] * mul;
  }
}

template <int D>
constexpr size_t smem_floats(bool dkv) {
  // own operands d-major [D][LDT] x 2, visited operands row-major
  // [TILE][D + 4] x 2, dS (and P for dkv) [other][own] [TILE][LDT]
  return 2 * size_t(D) * LDT + 2 * size_t(TILE) * (D + 4) + (dkv ? 2 : 1) * size_t(TILE) * LDT;
}

// DKV: own rows are kv rows (operands K, V), visited rows query rows (Q,
// dO, lse, di); dK = scale * dS^T Q, dV = P^T dO. Otherwise (dq): own rows
// are query rows (Q, dO, lse, di), visited rows kv rows (K, V);
// dQ = scale * dS K.
template <int D, bool DKV>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 2 : 1) seg_attn_bwd(Args a) {
  constexpr int NC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* ownA = smem;               // DKV: K^T, dq: Q^T   [D][LDT]
  float* ownB = ownA + D * LDT;     // DKV: V^T, dq: dO^T
  float* othA = ownB + D * LDT;     // DKV: Q, dq: K       [TILE][D + 4]
  float* othB = othA + TILE * (D + 4);  // DKV: dO, dq: V
  float* dst = othB + TILE * (D + 4);   // dS [other][own]
  float* pt = dst + TILE * LDT;         // P [other][own] (DKV)
  int32_t* seg_own = reinterpret_cast<int32_t*>(pt + (DKV ? TILE * LDT : 0));
  int32_t* seg_oth = seg_own + TILE;
  float* row_lse = reinterpret_cast<float*>(seg_oth + TILE);  // lse * log2(e) of query rows
  float* row_di = row_lse + TILE;
  int* range = reinterpret_cast<int*>(row_di + TILE);
  unsigned* bits = reinterpret_cast<unsigned*>(range + 4);

  const int t = threadIdx.x;
  const int ty = t / 16, tx = t % 16;
  const int own0 = blockIdx.x * TILE;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_own = DKV ? a.skv : a.sq, n_oth = DKV ? a.sq : a.skv;
  const int32_t* sown = (DKV ? a.seg_kv : a.seg_q) + int64_t(b) * n_own;
  const int32_t* soth = (DKV ? a.seg_q : a.seg_kv) + int64_t(b) * n_oth;
  wct::seg_bwd::mark_tiles<THREADS>(sown, n_own, own0, soth, n_oth, a.nwords, seg_own, bits,
                                    range);

  const float* qb = static_cast<const float*>(a.q) + int64_t(b) * a.q_sb + int64_t(hh) * D;
  const float* kb = static_cast<const float*>(a.k) + int64_t(b) * a.k_sb + int64_t(hh) * D;
  const float* vb = static_cast<const float*>(a.v) + int64_t(b) * a.v_sb + int64_t(hh) * D;
  const float* dob = static_cast<const float*>(a.dout) + int64_t(b) * a.do_sb + int64_t(hh) * D;
  const float* lse_b = a.lse + (int64_t(b) * a.h + hh) * a.sq;
  const float* di_b = a.di + (int64_t(b) * a.h + hh) * a.sq;

  // Query-row lse (log2 units) and di of rows [r0, r0 + TILE).
  auto stage_rows = [&](int r0) {
    if (t < TILE) {
      const int r = r0 + t;
      row_lse[t] = r < a.sq ? lse_b[r] * LOG2E : INFINITY;
      row_di[t] = r < a.sq ? di_b[r] : 0.f;
    }
  };
  if constexpr (DKV) {
    stage<D, true>(ownA, kb, a.k_ss, own0, a.skv);
    stage<D, true>(ownB, vb, a.v_ss, own0, a.skv);
  } else {
    stage<D, true>(ownA, qb, a.q_ss, own0, a.sq);
    stage<D, true>(ownB, dob, a.do_ss, own0, a.sq);
    stage_rows(own0);
  }
  __syncthreads();

  // Own rows of the S / dP block: tx * 4 + i.
  int my_seg[4];
  bool my_ok[4];
  float my_lse[4], my_di[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tx * 4 + i;
    my_seg[i] = seg_own[r];
    my_ok[i] = own0 + r < n_own;
    my_lse[i] = DKV ? 0.f : row_lse[r];
    my_di[i] = DKV ? 0.f : row_di[r];
  }
  float acc1[4][NC], acc0[4][NC];  // DKV: dK, dV; dq: dQ in acc1
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc1[i][c] = acc0[i][c] = 0.f;

  for (int w = 0; w < a.nwords; ++w) {
    unsigned word = bits[w];
    while (word != 0u) {
      const int tile = w * 32 + __ffs(word) - 1;
      word &= word - 1;
      const int o0 = tile * TILE;
      if constexpr (DKV) {
        stage<D, false>(othA, qb, a.q_ss, o0, a.sq);
        stage<D, false>(othB, dob, a.do_ss, o0, a.sq);
        stage_rows(o0);
      } else {
        stage<D, false>(othA, kb, a.k_ss, o0, a.skv);
        stage<D, false>(othB, vb, a.v_ss, o0, a.skv);
      }
      if (t < TILE) seg_oth[t] = o0 + t < n_oth ? soth[o0 + t] : 0;
      __syncthreads();

      float s[4][4], dp[4][4];
      dot_tile<D>(s, ownA, othA, ty, tx);   // DKV: S^T = K Q^T; dq: S = Q K^T
      dot_tile<D>(dp, ownB, othB, ty, tx);  // DKV: dP^T = V dO^T; dq: dP = dO V^T
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int oj = ty * 4 + j;
        const bool col_ok = o0 + oj < n_oth;
        const int col_seg = seg_oth[oj];
        const float col_lse = DKV ? row_lse[oj] : 0.f;
        const float col_di = DKV ? row_di[oj] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = my_ok[i] && col_ok && col_seg == my_seg[i];
          const float l2 = DKV ? col_lse : my_lse[i];
          const float p = ok ? exp2f(s[i][j] * a.scale_log2 - l2) : 0.f;
          s[i][j] = p;
          dp[i][j] = p * (dp[i][j] - (DKV ? col_di : my_di[i]));
        }
        *reinterpret_cast<float4*>(&dst[oj * LDT + tx * 4]) =
            make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
        if constexpr (DKV)
          *reinterpret_cast<float4*>(&pt[oj * LDT + tx * 4]) =
              make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      }
      __syncthreads();
      if constexpr (DKV) acc_tile<D>(acc0, pt, othB, ty, tx);  // dV += P^T dO
      acc_tile<D>(acc1, dst, othA, ty, tx);  // DKV: dK += dS^T Q; dq: dQ += dS K
      __syncthreads();  // the next tile overwrites the staged operands
    }
  }

  if constexpr (DKV) {
    write_rows<D>(static_cast<float*>(a.dk), acc1, a.scale, own0, a.skv, a.h, hh, b, ty, tx);
    write_rows<D>(static_cast<float*>(a.dv), acc0, 1.f, own0, a.skv, a.h, hh, b, ty, tx);
  } else {
    write_rows<D>(static_cast<float*>(a.dq), acc1, a.scale, own0, a.sq, a.h, hh, b, ty, tx);
  }
}

constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

template <int D, bool DKV>
int launch(const Args& a, int b, cudaStream_t stream) {
  // seg_own, seg_oth, row_lse, row_di, range (padded to 4 ints) and the
  // tile bitmask follow the tiles.
  const size_t bytes =
      smem_floats<D>(DKV) * sizeof(float) + (4 * TILE + 4 + size_t(a.nwords)) * sizeof(int);
  if (bytes > kMaxSmem) return int(cudaErrorInvalidValue);
  auto kernel = seg_attn_bwd<D, DKV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(bytes));
  if (err != cudaSuccess) return int(err);
  const int n_own = DKV ? a.skv : a.sq;
  const dim3 grid((n_own + TILE - 1) / TILE, a.h, b);
  kernel<<<grid, THREADS, bytes, stream>>>(a);
  return int(cudaGetLastError());
}

template <bool DKV>
int launch_d(const Args& a, int b, int d, int dtype, cudaStream_t stream) {
  if (dtype == 1) return wct::seg_bwd::launch_bf16(a, b, d, DKV, stream);
  if (dtype != 0) return int(cudaErrorInvalidValue);
  switch (d) {
    case 16: return launch<16, DKV>(a, b, stream);
    case 32: return launch<32, DKV>(a, b, stream);
    case 64: return launch<64, DKV>(a, b, stream);
    case 128: return launch<128, DKV>(a, b, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* di, const int32_t* seg_q, const int32_t* seg_kv, void* dq, void* dk,
               void* dv, int sq, int skv, int h, const int64_t* strides, float scale,
               int other_rows) {
  const int tiles = (other_rows + TILE - 1) / TILE;
  return Args{q, k, v, dout, lse, di, seg_q, seg_kv, dq, dk, dv, sq, skv, h,
              strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
              strides[6], strides[7], scale, scale * LOG2E, (tiles + 31) / 32};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients share
// it). strides: the batch and row strides, in elements, of q, k, v and
// dout, in that order; the wrapper checks 16-byte alignment of every row.
// Every row of dk and dv (dq) is written.
extern "C" int wct_segment_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                             const void* dout, const float* lse, const float* di,
                                             const int32_t* seg_q, const int32_t* seg_kv,
                                             void* dk, void* dv, int b, int sq, int skv, int h,
                                             int d, const int64_t* strides, float scale,
                                             int dtype, cudaStream_t stream) {
  if (b == 0 || skv == 0 || h == 0) return 0;
  const Args a = make_args(q, k, v, dout, lse, di, seg_q, seg_kv, nullptr, dk, dv, sq, skv, h,
                           strides, scale, sq);
  return launch_d<true>(a, b, d, dtype, stream);
}

extern "C" int wct_segment_attention_bwd_dq(const void* q, const void* k, const void* v,
                                            const void* dout, const float* lse, const float* di,
                                            const int32_t* seg_q, const int32_t* seg_kv,
                                            void* dq, int b, int sq, int skv, int h, int d,
                                            const int64_t* strides, float scale, int dtype,
                                            cudaStream_t stream) {
  if (b == 0 || sq == 0 || h == 0) return 0;
  const Args a = make_args(q, k, v, dout, lse, di, seg_q, seg_kv, dq, nullptr, nullptr, sq, skv,
                           h, strides, scale, skv);
  return launch_d<false>(a, b, d, dtype, stream);
}
