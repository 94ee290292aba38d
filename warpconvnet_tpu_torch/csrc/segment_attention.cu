// Segment-masked attention forward (K9):
//   out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h]) * v[b, j, h]
// over the kv rows j with seg_kv[b, j] == seg_q[b, i]; a query row with no
// such j gives 0 (the contract of masked_sdpa). q [B, Sq, H, D] and k, v
// [B, Skv, H, D] share fp32 or bf16; D is 16, 32, 64 or 128. Softmax state
// and sums are fp32; out [B, Sq, H, D] is contiguous, in the inputs' dtype.
// q, k and v are read through their batch and row strides (in elements;
// each row's [H, D] block contiguous), so the Q/K/V slices of a fused QKV
// projection need no copy.
//
// Replaces: the stock Pallas TPU flash attention
// (jax.experimental.pallas.ops.tpu.flash_attention) that
// warpconvnet_tpu/nn/functional/flash_attention.py `segment_attention`
// (:73-155) calls with SegmentIds, forward only.
//
// What bounds it on the card: operations, 4 * D FLOPs per (query, kv) pair
// of one head with equal segments. bf16 runs both products on the tensor
// cores (mma.sync m16n8k16, bf16 -> fp32); fp32 runs them on the CUDA cores
// with fp32 FMA (no TF32), where FMA issue and shared-memory reads bound it.
//
// Design (FlashAttention-2 order): one block per (128-query tile, head,
// scene). It first marks, in a shared bitmask, every 64-row kv tile that
// holds a row whose segment lies in the query tile's [min, max] segment
// range; the other tiles hold no pair and are never loaded, so any segment
// layout stays exact and global attention over valid rows never touches a
// valid x pad tile. For each marked tile it stages K and V in shared
// memory, computes S = Q K^T, masks unequal segments and the ragged edge to
// -inf, updates the running row max and sum (online softmax, exp2 with the
// scale folded into log2 units), rescales the accumulator and adds P V.
// fp32: 256 threads, 8 x 4 scores a thread, so that each shared-memory read
// feeds 8 FMAs; K is staged transposed, P goes through shared memory. bf16:
// 8 warps of 16 query rows; K and V move by cp.async into two stages (the
// next tile loads while this one computes) and reach the mma operands by
// ldmatrix, P stays in registers. The TPU kernel's 128-lane head padding,
// block-size sequence padding and extra sentinel kv row do not carry over:
// tiles mask their ragged edges. wgmma, TMA and warp specialisation come
// later.
#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 128;  // query rows per block
constexpr int BKV = 64;  // kv rows per tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;
using wct::hopper::cp_async16;
using wct::hopper::next_tile;
using wct::hopper::pack_bf16;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* seg_q;   // [B, Sq]
  const int32_t* seg_kv;  // [B, Skv]
  void* out;              // [B, Sq, H, D]
  float* lse;             // [B, H, Sq] or null
  int sq, skv, h;
  int64_t q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;  // batch and row strides, elements
  float scale_log2;                            // softmax scale * log2(e)
  int nwords;                                  // bitmask words: ceil(kv tiles / 32)
};

// Loads the query tile's segment ids into segq (rows past Sq get INT_MAX
// and are left out of the range) and sets bit t of `bits` for every kv tile
// t that holds a row j < Skv with seg_kv[j] in [min, max] of the tile's
// segments. Ends with the block synchronised.
__device__ void mark_kv_tiles(const Args& a, int b, int q0, int32_t* segq, unsigned* bits,
                              int* range) {
  const int t = threadIdx.x;
  for (int i = t; i < a.nwords; i += blockDim.x) bits[i] = 0u;
  if (t == 0) {
    range[0] = INT_MAX;
    range[1] = INT_MIN;
  }
  __syncthreads();
  if (t < BQ) {
    const int r = q0 + t;
    int s = INT_MAX;
    if (r < a.sq) {
      s = a.seg_q[int64_t(b) * a.sq + r];
      atomicMin(&range[0], s);
      atomicMax(&range[1], s);
    }
    segq[t] = s;
  }
  __syncthreads();
  const int lo = range[0], hi = range[1];
  const int32_t* skv = a.seg_kv + int64_t(b) * a.skv;
  const int lane = t & 31;
  // Each warp takes 32 consecutive rows at a time, all inside one kv tile.
  for (int j0 = t & ~31; j0 < a.skv; j0 += blockDim.x) {
    const int j = j0 + lane;
    bool hit = false;
    if (j < a.skv) {
      const int s = skv[j];
      hit = s >= lo && s <= hi;
    }
    if (__ballot_sync(0xffffffffu, hit) != 0u && lane == 0) {
      const int tile = j0 / BKV;
      atomicOr(&bits[tile >> 5], 1u << (tile & 31));
    }
  }
  __syncthreads();
}

// Natural-log log-sum-exp of a row from the online softmax's running max m
// (log2 units of the scaled scores) and sum l; +inf for a row with no match.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * LN2 : INFINITY;
}

// ---- fp32: CUDA cores, 256 threads as 16 x 16, 8 x 4 scores a thread --------

constexpr int F_THREADS = 256;
constexpr int LDQ = BQ + 4;  // row stride of Qt and Pt (floats)
constexpr int LDK = BKV + 4;  // row stride of Kt (floats)

template <int D>
constexpr size_t f32_smem_floats() {
  // Qt [D][LDQ], Kt [D][LDK], Vs [BKV][D], Pt [BKV][LDQ]
  return size_t(D) * LDQ + size_t(D) * LDK + size_t(BKV) * D + size_t(BKV) * LDQ;
}

// Stores rows [r0, r0 + ROWS) of one head of x (fp32) transposed into
// dst[d][r] (row stride LD); rows past n are zero. Lanes run along rows,
// so the shared-memory stores do not conflict.
template <int D, int ROWS, int LD>
__device__ __forceinline__ void load_transposed_f32(float* dst, const float* x, int64_t ss,
                                                    int r0, int n) {
  for (int idx = threadIdx.x; idx < ROWS * (D / 4); idx += F_THREADS) {
    const int r = idx % ROWS, c4 = idx / ROWS;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) val = *reinterpret_cast<const float4*>(x + int64_t(r0 + r) * ss + c4 * 4);
    dst[(c4 * 4 + 0) * LD + r] = val.x;
    dst[(c4 * 4 + 1) * LD + r] = val.y;
    dst[(c4 * 4 + 2) * LD + r] = val.z;
    dst[(c4 * 4 + 3) * LD + r] = val.w;
  }
}

// Thread (ty, tx) owns query rows ty*4 + i and 64 + ty*4 + i (i < 4) and kv
// columns tx*4 + j (j < 4) of each score tile: the two lanes' rows of a warp
// are one 16-byte broadcast, its 16 column groups one 256-byte read.
template <int D>
__global__ void __launch_bounds__(F_THREADS, D <= 64 ? 2 : 1) seg_attn_f32(Args a) {
  constexpr int VEC = D / 16 < 4 ? D / 16 : 4;  // consecutive output columns a thread owns
  constexpr int CH = D / 16 / VEC;               // chunks of VEC columns, 16 * VEC apart
  constexpr int OC = CH * VEC;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* Kt = Qt + D * LDQ;
  float* Vs = Kt + D * LDK;
  float* Pt = Vs + BKV * D;
  int32_t* segq = reinterpret_cast<int32_t*>(Pt + BKV * LDQ);
  int32_t* segk = segq + BQ;
  int* range = segk + BKV;
  unsigned* bits = reinterpret_cast<unsigned*>(range + 2);

  const int t = threadIdx.x;
  const int ty = t / 16, tx = t % 16;
  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;

  mark_kv_tiles(a, b, q0, segq, bits, range);
  const float* qb = static_cast<const float*>(a.q) + int64_t(b) * a.q_sb + int64_t(hh) * D;
  const float* kb = static_cast<const float*>(a.k) + int64_t(b) * a.k_sb + int64_t(hh) * D;
  const float* vb = static_cast<const float*>(a.v) + int64_t(b) * a.v_sb + int64_t(hh) * D;
  load_transposed_f32<D, BQ, LDQ>(Qt, qb, a.q_ss, q0, a.sq);

  int my_seg[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) my_seg[i] = segq[(i / 4) * 64 + ty * 4 + i % 4];
  float m[8], l[8], o[8][OC];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) o[i][c] = 0.f;
  }

  for (int w = 0; w < a.nwords; ++w) {
    unsigned word = bits[w];
    while (word != 0u) {
      const int tile = w * 32 + __ffs(word) - 1;
      word &= word - 1;
      const int kv0 = tile * BKV;
      load_transposed_f32<D, BKV, LDK>(Kt, kb, a.k_ss, kv0, a.skv);
      for (int idx = t; idx < BKV * (D / 4); idx += F_THREADS) {
        const int r = idx / (D / 4), c4 = idx % (D / 4);
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kv0 + r < a.skv)
          val = *reinterpret_cast<const float4*>(vb + int64_t(kv0 + r) * a.v_ss + c4 * 4);
        *reinterpret_cast<float4*>(&Vs[r * D + c4 * 4]) = val;
      }
      if (t < BKV) segk[t] = kv0 + t < a.skv ? a.seg_kv[int64_t(b) * a.skv + kv0 + t] : 0;
      __syncthreads();

      float s[8][4] = {};
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 q0v = *reinterpret_cast<const float4*>(&Qt[d * LDQ + ty * 4]);
        const float4 q1v = *reinterpret_cast<const float4*>(&Qt[d * LDQ + 64 + ty * 4]);
        const float4 kv4 = *reinterpret_cast<const float4*>(&Kt[d * LDK + tx * 4]);
        const float qv[8] = {q0v.x, q0v.y, q0v.z, q0v.w, q1v.x, q1v.y, q1v.z, q1v.w};
        const float kv[4] = {kv4.x, kv4.y, kv4.z, kv4.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }

      bool col_ok[4];
      int col_seg[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        col_ok[j] = kv0 + tx * 4 + j < a.skv;
        col_seg[j] = segk[tx * 4 + j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = (col_ok[j] && col_seg[j] == my_seg[i]) ? s[i][j] * a.scale_log2 : -INFINITY;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[i] - m_use);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = exp2f(s[i][j] - m_use);
          sum += s[i][j];
        }
        l[i] = l[i] * alpha + sum;
#pragma unroll
        for (int c = 0; c < OC; ++c) o[i][c] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* prow = &Pt[(tx * 4 + j) * LDQ + ty * 4];
        *reinterpret_cast<float4*>(prow) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        *reinterpret_cast<float4*>(prow + 64) = make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
      }
      __syncthreads();

#pragma unroll 4
      for (int jj = 0; jj < BKV; ++jj) {
        const float4 p0 = *reinterpret_cast<const float4*>(&Pt[jj * LDQ + ty * 4]);
        const float4 p1 = *reinterpret_cast<const float4*>(&Pt[jj * LDQ + 64 + ty * 4]);
        const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) {
          float vv[VEC];
          const float* src = &Vs[jj * D + ch * 16 * VEC + tx * VEC];
          if constexpr (VEC == 4) {
            const float4 x4 = *reinterpret_cast<const float4*>(src);
            vv[0] = x4.x; vv[1] = x4.y; vv[2] = x4.z; vv[3] = x4.w;
          } else if constexpr (VEC == 2) {
            const float2 x2 = *reinterpret_cast<const float2*>(src);
            vv[0] = x2.x; vv[1] = x2.y;
          } else {
            vv[0] = src[0];
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 0; e < VEC; ++e) o[i][ch * VEC + e] = fmaf(pv[i], vv[e], o[i][ch * VEC + e]);
        }
      }
      __syncthreads();
    }
  }

  float* ob = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float sum = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    const int r = q0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (r >= a.sq) continue;
    // m[i] and the reduced sum are the same on the row's 16 threads.
    if (a.lse != nullptr && tx == 0)
      a.lse[(int64_t(b) * a.h + hh) * a.sq + r] = row_lse(m[i], sum);
    float* orow = ob + ((int64_t(b) * a.sq + r) * a.h + hh) * D;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch)
#pragma unroll
      for (int e = 0; e < VEC; ++e) orow[ch * 16 * VEC + tx * VEC + e] = o[i][ch * VEC + e] * inv;
  }
}

// ---- bf16: tensor cores (mma.sync m16n8k16), 8 warps of 16 query rows ------

constexpr int H_THREADS = 256;

template <int D>
constexpr size_t bf16_smem_elems() {
  // Qs [BQ][D + 8], Ks [2][BKV][D + 8], Vs [2][BKV][D + 8]
  return size_t(BQ + 4 * BKV) * (D + 8);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8 (TRANS: each delivered transposed).
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(H_THREADS, D <= 64 ? 2 : 1) seg_attn_bf16(Args a) {
  constexpr int LD = D + 8;   // row stride (elements): ldmatrix rows hit distinct banks
  constexpr int KT = D / 16;  // k-steps of Q K^T
  constexpr int ND = D / 8;   // n-tiles of P V
  extern __shared__ __align__(16) bf16 hsmem[];
  bf16* Qs = hsmem;
  bf16* Ks = Qs + BQ * LD;       // [2][BKV][LD]
  bf16* Vs = Ks + 2 * BKV * LD;    // [2][BKV][LD]
  int32_t* segq = reinterpret_cast<int32_t*>(Vs + 2 * BKV * LD);
  int32_t* segk = segq + BQ;     // [2][BKV]
  int* range = segk + 2 * BKV;
  unsigned* bits = reinterpret_cast<unsigned*>(range + 2);

  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tig = lane % 4;  // mma fragment row group, thread in group
  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;

  mark_kv_tiles(a, b, q0, segq, bits, range);
  const bf16* qb = static_cast<const bf16*>(a.q) + int64_t(b) * a.q_sb + int64_t(hh) * D;
  const bf16* kb = static_cast<const bf16*>(a.k) + int64_t(b) * a.k_sb + int64_t(hh) * D;
  const bf16* vb = static_cast<const bf16*>(a.v) + int64_t(b) * a.v_sb + int64_t(hh) * D;
  for (int idx = t; idx < BQ * (D / 8); idx += H_THREADS) {
    const int r = idx / (D / 8), c8 = idx % (D / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < a.sq)
      val = *reinterpret_cast<const uint4*>(qb + int64_t(q0 + r) * a.q_ss + c8 * 8);
    *reinterpret_cast<uint4*>(Qs + r * LD + c8 * 8) = val;
  }

  // Stage `st` <- kv tile `tile`: K, V (rows past Skv zero) and segment ids.
  auto issue = [&](int tile, int st) {
    const int kv0 = tile * BKV;
    for (int idx = t; idx < BKV * (D / 8); idx += H_THREADS) {
      const int r = idx / (D / 8), c8 = idx % (D / 8);
      const bool ok = kv0 + r < a.skv;
      const int64_t row = ok ? kv0 + r : 0;
      cp_async16(Ks + (st * BKV + r) * LD + c8 * 8, kb + row * a.k_ss + c8 * 8, ok);
      cp_async16(Vs + (st * BKV + r) * LD + c8 * 8, vb + row * a.v_ss + c8 * 8, ok);
    }
    if (t < BKV) segk[st * BKV + t] = kv0 + t < a.skv ? a.seg_kv[int64_t(b) * a.skv + kv0 + t] : 0;
    asm volatile("cp.async.commit_group;\n" ::);
  };

  int cur = next_tile(bits, a.nwords, -1);
  if (cur >= 0) issue(cur, 0);
  __syncthreads();  // Qs

  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's two query rows in the tile
  uint32_t qa[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    qa[kt][0] = ld32(&Qs[r0 * LD + kt * 16 + tig * 2]);
    qa[kt][1] = ld32(&Qs[r1 * LD + kt * 16 + tig * 2]);
    qa[kt][2] = ld32(&Qs[r0 * LD + kt * 16 + tig * 2 + 8]);
    qa[kt][3] = ld32(&Qs[r1 * LD + kt * 16 + tig * 2 + 8]);
  }
  const int seg0 = segq[r0], seg1 = segq[r1];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  // ldmatrix lane roles: matrix lane / 8, its row lane % 8.
  const int lm = lane / 8, lr = lane % 8;

  for (int st = 0; cur >= 0; st ^= 1) {
    const int nxt = next_tile(bits, a.nwords, cur);
    if (nxt >= 0) {
      issue(nxt, st ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int kv0 = cur * BKV;
    const bf16* Kst = Ks + st * BKV * LD;
    const bf16* Vst = Vs + st * BKV * LD;
    const int32_t* sk = segk + st * BKV;

    // S = Q K^T: 8 n-tiles of 8 keys; c[nt][0..1] row r0, [2..3] row r1.
    float c[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        // b0, b1 of n-tiles nt and nt + 1 at k-step kt.
        uint32_t kf[4];
        ldmatrix_x4<false>(kf, &Kst[(nt * 8 + (lm / 2) * 8 + lr) * LD + kt * 16 + (lm % 2) * 8]);
        mma_bf16(c[nt], qa[kt], kf[0], kf[1]);
        mma_bf16(c[nt + 1], qa[kt], kf[2], kf[3]);
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + tig * 2 + e;
        const bool ok = kv0 + col < a.skv;
        const int skc = sk[col];
        c[nt][e] = (ok && skc == seg0) ? c[nt][e] * a.scale_log2 : -INFINITY;
        c[nt][2 + e] = (ok && skc == seg1) ? c[nt][2 + e] * a.scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, c[nt][e]);
        mx1 = fmaxf(mx1, c[nt][2 + e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float u0 = n0 == -INFINITY ? 0.f : n0, u1 = n1 == -INFINITY ? 0.f : n1;
    const float alpha0 = exp2f(m0 - u0), alpha1 = exp2f(m1 - u1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        c[nt][e] = exp2f(c[nt][e] - u0);
        c[nt][2 + e] = exp2f(c[nt][2 + e] - u1);
        sum0 += c[nt][e];
        sum1 += c[nt][2 + e];
      }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= alpha0;
      o[nd][1] *= alpha0;
      o[nd][2] *= alpha1;
      o[nd][3] *= alpha1;
    }
    // P (bf16) as the A operand: the score fragments of n-tiles 2kt and
    // 2kt + 1 are the A fragment of k-step kt.
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      const uint32_t pa[4] = {pack_bf16(c[2 * kt][0], c[2 * kt][1]),
                              pack_bf16(c[2 * kt][2], c[2 * kt][3]),
                              pack_bf16(c[2 * kt + 1][0], c[2 * kt + 1][1]),
                              pack_bf16(c[2 * kt + 1][2], c[2 * kt + 1][3])};
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        // b0, b1 of n-tiles nd and nd + 1 at k-step kt, V transposed.
        uint32_t vf[4];
        ldmatrix_x4<true>(vf, &Vst[(kt * 16 + (lm % 2) * 8 + lr) * LD + nd * 8 + (lm / 2) * 8]);
        mma_bf16(o[nd], pa, vf[0], vf[1]);
        mma_bf16(o[nd + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is reloaded two tiles on
    cur = nxt;
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  bf16* ob = static_cast<bf16*>(a.out);
  const int row0 = q0 + r0, row1 = q0 + r1;
  if (a.lse != nullptr && tig == 0) {  // m and the reduced l are the same on a quad
    float* lrow = a.lse + (int64_t(b) * a.h + hh) * a.sq;
    if (row0 < a.sq) lrow[row0] = row_lse(m0, l0);
    if (row1 < a.sq) lrow[row1] = row_lse(m1, l1);
  }
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = nd * 8 + tig * 2;
    if (row0 < a.sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + ((int64_t(b) * a.sq + row0) * a.h + hh) * D + col) =
          __floats2bfloat162_rn(o[nd][0] * inv0, o[nd][1] * inv0);
    if (row1 < a.sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + ((int64_t(b) * a.sq + row1) * a.h + hh) * D + col) =
          __floats2bfloat162_rn(o[nd][2] * inv1, o[nd][3] * inv1);
  }
}

constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

template <typename Kernel>
int launch(Kernel kernel, const Args& a, int b, int threads, size_t base_bytes,
           cudaStream_t stream) {
  // segq, segk (two stages), range (padded to 4 ints) and the tile bitmask
  // follow the tiles.
  const size_t bytes = base_bytes + (BQ + 2 * BKV + 4 + size_t(a.nwords)) * sizeof(int);
  if (bytes > kMaxSmem) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.sq + BQ - 1) / BQ, a.h, b);
  kernel<<<grid, threads, bytes, stream>>>(a);
  return int(cudaGetLastError());
}

template <int D>
int launch_d(const Args& a, int b, int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return launch(seg_attn_f32<D>, a, b, F_THREADS, f32_smem_floats<D>() * sizeof(float), stream);
  if (dtype == 1)
    return launch(seg_attn_bf16<D>, a, b, H_THREADS, bf16_smem_elems<D>() * sizeof(bf16), stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). Strides are
// in elements; the wrapper checks 16-byte alignment of every row. lse may be
// null.
extern "C" int wct_segment_attention_fwd(const void* q, const void* k, const void* v,
                                         const int32_t* seg_q, const int32_t* seg_kv, void* out,
                                         float* lse, int b, int sq, int skv, int h, int d,
                                         int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                                         int64_t v_sb, int64_t v_ss, float scale, int dtype,
                                         cudaStream_t stream) {
  if (b == 0 || sq == 0 || h == 0) return 0;
  const int kv_tiles = (skv + BKV - 1) / BKV;
  const Args a{q, k, v, seg_q, seg_kv, out, lse, sq, skv, h, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
               scale * LOG2E, (kv_tiles + 31) / 32};
  switch (d) {
    case 16: return launch_d<16>(a, b, dtype, stream);
    case 32: return launch_d<32>(a, b, dtype, stream);
    case 64: return launch_d<64>(a, b, dtype, stream);
    case 128: return launch_d<128>(a, b, dtype, stream);
    default: return int(cudaErrorInvalidValue);
  }
}
