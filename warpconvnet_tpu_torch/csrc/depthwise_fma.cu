// Depthwise sparse-conv kernels (per-channel weights, no channel mixing):
//   K6 forward   out[b, o, c] = sum_k x[b, table[b, k, o], c] * w[k, c]
//      (dgrad is the same kernel on (g, w, rev): a per-channel weight is its
//      own transpose)
//   K7 wgrad     dw[k, c] = sum_{b, o} x[b, table[b, k, o], c] * g[b, o, c]
//   K8 fused     dx and dw of a symmetric self-map in one pass:
//      dx[b, i, c] = sum_k g[b, table[b, k, i], c] * w[K-1-k, c], dw as K7
// x and g [B, N, C] in fp32 or bf16, w [K, C] fp32, table int32 (-1 adds
// zero), fp32 accumulation; out and dx in x's dtype, dw [K, C] fp32 summed
// over the batch.
//
// Replaces: warpconvnet_tpu/kernels/depthwise_fma.py `_depth_fwd_kernel`
// (:152, entry `depthwise_fma_fwd` :522), `_depth_wgrad_kernel` (:261, entry
// `depthwise_fma_wgrad` :607) and `_depth_bwd_fused_kernel` (:367, entry
// `depthwise_fma_bwd_fused` :692).
//
// What bounds them on the card: bytes. Each valid pair costs one row gather
// and C FMAs, so there is no arithmetic to speak of; a 7^3 map is a
// [B, 343, N] table of which a few percent is valid, and streaming the table
// sets the floor. The TPU kernels' union windows, one-hot MXU gathers, offset
// grouping, 128-lane padding and overflow residual pass all exist because
// Mosaic cannot gather rows by index; here a thread gathers a row segment by
// its index, so none of them carries over, and the identity offset is an
// ordinary table row.
//
// Design. A thread owns (row, 8 channels) as one 16-byte (bf16) or two
// 16-byte (fp32) vectors; a block of 256 threads holds `lanes` = ceil(C/8)
// such threads per row and 256 / lanes rows. Sums are fp32 in registers.
// - K6 and K8 work in rounds of up to 128 offsets: the block stages the
//   table tile (offsets x its rows) in shared memory, loaded by all threads
//   in coalesced segments, so each entry is read from memory once; one warp
//   per row then compacts the row's valid entries in offset order (a ballot
//   per 32 offsets), and the row's lanes walk only those, gathering four
//   rows at a time so the loads overlap. (Letting every lane walk all K
//   entries of its row, from global memory or from a staged tile, was
//   several times slower at 7^3: C/8 lanes repeating K tests a row.)
// - K6: the row's sum over all K stays in registers; one store per row.
// - K7: a block owns one offset, one chunk of output rows and all channels;
//   it loads 8 entries ahead, sums its chunk in registers, reduces over its
//   rows in shared memory and adds C values into the zeroed dw with fp32
//   atomics.
// - K8: a block owns K6's rows and all channels. Each staged tile serves
//   both parts: thread (row i, lane) walks its row's valid entries,
//   dx[i] += g[j] * w[K-1-k] in registers across all K; then, with each
//   offset's valid rows also compacted, thread (offset k, lane) walks them,
//   sums dw[k] += x[j] * g[i] (g[i] staged in shared memory) in registers,
//   and adds the sum into dw with float4 atomics: at most blocks x K x C / 4
//   adds, only for offsets with a pair in the tile. Small shared memory and
//   capped registers keep 4 blocks an SM in flight. (Versions that kept a
//   [K, C] dw accumulator in shared memory, filled with shared-memory
//   atomics or by offset owners, held 2 blocks an SM and read the table
//   once per channel span; they were slower than K6-dgrad and K7 together.)
#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;        // lanes x rows a block
constexpr int KB = 8;               // K7: table entries loaded ahead
constexpr int MAX_CHANNELS = 1024;  // lanes <= 128, >= 2 rows a block
constexpr int SMS = 132;            // H100 SXM

// 8 consecutive channels into fp32 registers. VEC: the caller checked that
// C % 8 == 0 and the base pointers are 16-byte aligned, so n_ok == 8 and the
// segment moves as 16-byte vectors; otherwise element by element, zero at
// and past n_ok.
template <bool VEC>
__device__ __forceinline__ void load8(const float* __restrict__ p, int n_ok, float (&v)[8]) {
  if (VEC) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < n_ok ? __ldg(p + e) : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void load8(const bf16* __restrict__ p, int n_ok, float (&v)[8]) {
  if (VEC) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      v[2 * q] = f.x;
      v[2 * q + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < n_ok ? __bfloat162float(p[e]) : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store8(float* p, int n_ok, const float (&v)[8]) {
  if (VEC) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < n_ok) p[e] = v[e];
  }
}

template <bool VEC>
__device__ __forceinline__ void store8(bf16* p, int n_ok, const float (&v)[8]) {
  if (VEC) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < n_ok) p[e] = __float2bfloat16(v[e]);
  }
}

// The valid entries of a staged table tile, row by row in offset order and,
// for K8, offset by offset in row order. Shared-memory layout (kc offsets x
// rows of a round): tile [kc][ts] int32 (ts = rows | 1, odd, so column
// reads hit distinct banks); row lists j [rows][kc] int32 and kk [rows][kc]
// int16 with cnt [rows]; column lists r [kc][rows] int16 with ccnt [kc].
struct Lists {
  int32_t* tile;
  int32_t* j;
  int* cnt;
  int* ccnt;
  int16_t* kk;
  int16_t* r;
  __device__ Lists(void* base, int kc, int rows)
      : tile(static_cast<int32_t*>(base)),
        j(tile + kc * (rows | 1)),
        cnt(j + kc * rows),
        ccnt(cnt + rows),
        kk(reinterpret_cast<int16_t*>(ccnt + kc)),
        r(kk + kc * rows) {}
};

size_t lists_bytes(int kc, int rows) {
  return size_t(kc) * ((rows | 1) * 4 + rows * 8 + 4) + rows * 4;
}

// Offsets staged a round: as many as a `budget`-byte Lists holds, a
// multiple of 8 up to 128, no more than K needs.
int round_offsets(int k_vol, int rows, int budget) {
  const int fit = budget / (12 * rows + 4) / 8 * 8;
  return std::max(8, std::min({128, fit, (k_vol + 7) / 8 * 8}));
}

// Stage table rows [k0, k0 + kc) x columns [r0, r0 + rows) of one scene
// (tb = table + b * k_vol * n), -1 past either end, then compact each row's
// valid entries in offset order (one warp a row, a ballot per 32 offsets)
// and, with COLS, each offset's valid rows in row order. Consecutive threads
// load consecutive columns, so each warp load is one coalesced segment and
// every entry is loaded once. Every thread of the block (a multiple of 32)
// calls it; returns false, with the lists untouched, when the whole tile is
// -1.
template <bool COLS>
__device__ __forceinline__ bool stage_lists(const int32_t* __restrict__ tb, int n, int k_vol,
                                            int k0, int kc, int r0, int rows, Lists L) {
  const int ts = rows | 1;
  int any = 0;
  for (int idx = threadIdx.x; idx < kc * rows; idx += blockDim.x) {
    const int kk = idx / rows, r = idx - kk * rows;
    const int k = k0 + kk, o = r0 + r;
    const int32_t v = (k < k_vol && o < n) ? __ldg(tb + int64_t(k) * n + o) : -1;
    L.tile[kk * ts + r] = v;
    any |= v >= 0;
  }
  if (!__syncthreads_or(any)) return false;
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  for (int r = warp; r < rows; r += blockDim.x / 32) {
    int base = 0;
    for (int kk0 = 0; kk0 < kc; kk0 += 32) {
      const int kk = kk0 + wl;
      const int32_t v = kk < kc ? L.tile[kk * ts + r] : -1;
      const unsigned mask = __ballot_sync(0xffffffffu, v >= 0);
      if (v >= 0) {
        const int pos = base + __popc(mask & ((1u << wl) - 1u));
        L.j[r * kc + pos] = v;
        L.kk[r * kc + pos] = int16_t(kk);
      }
      base += __popc(mask);
    }
    if (wl == 0) L.cnt[r] = base;
  }
  if (COLS) {
    for (int kk = warp; kk < kc; kk += blockDim.x / 32) {
      int base = 0;
      for (int q0 = 0; q0 < rows; q0 += 32) {
        const int q = q0 + wl;
        const bool hit = q < rows && L.tile[kk * ts + q] >= 0;
        const unsigned mask = __ballot_sync(0xffffffffu, hit);
        if (hit) L.r[kk * rows + base + __popc(mask & ((1u << wl) - 1u))] = int16_t(q);
        base += __popc(mask);
      }
      if (wl == 0) L.ccnt[kk] = base;
    }
  }
  __syncthreads();
  return true;
}

// Gather 8 channels of four rows src[j_u] (u < 4; -1 reads row 0, then is
// dropped): the four loads are issued together so their latencies overlap.
template <bool VEC, typename T>
__device__ __forceinline__ void gather4(const T* src, int64_t ld, const int32_t (&j)[4], int n_ok,
                                        float (&v)[4][8]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) load8<VEC>(src + int64_t(max(j[u], 0)) * ld, n_ok, v[u]);
}

// ---- K6: forward (and dgrad through rev) -------------------------------------

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
depth_fwd(const T* __restrict__ x, const float* __restrict__ w,
          const int32_t* __restrict__ table, T* __restrict__ out,
          int n_in, int n_out, int k_vol, int c, int lanes, int kc) {
  extern __shared__ __align__(16) int32_t smem_i[];
  const int rows = THREADS / lanes;  // threads past lanes * rows only stage
  const Lists L(smem_i, kc, rows);
  const int lane = threadIdx.x % lanes, ry = threadIdx.x / lanes;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows, o = r0 + ry;
  const bool active = ry < rows && o < n_out;
  const int ch = lane * 8;
  const int n_ok = min(8, c - ch);
  const T* xb = x + int64_t(b) * n_in * c + ch;
  const int32_t* tb = table + int64_t(b) * k_vol * n_out;
  float acc[8] = {};
  for (int k0 = 0; k0 < k_vol; k0 += kc) {
    if (stage_lists<false>(tb, n_out, k_vol, k0, kc, r0, rows, L) && active) {
      const int m = L.cnt[ry];
      const int32_t* pj = L.j + ry * kc;
      const int16_t* pk = L.kk + ry * kc;
      for (int e0 = 0; e0 < m; e0 += 4) {
        int32_t j[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) j[u] = e0 + u < m ? pj[e0 + u] : -1;
        float xv[4][8];
        gather4<VEC>(xb, c, j, n_ok, xv);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (j[u] < 0) continue;
          float wv[8];
          load8<VEC>(w + int64_t(k0 + pk[e0 + u]) * c + ch, n_ok, wv);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = fmaf(xv[u][e], wv[e], acc[e]);
        }
      }
    }
    __syncthreads();  // the lists are restaged next round
  }
  if (active) store8<VEC>(out + (int64_t(b) * n_out + o) * c + ch, n_ok, acc);
}

// ---- K7: weight gradient ------------------------------------------------------

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
depth_wgrad(const T* __restrict__ x, const T* __restrict__ g,
            const int32_t* __restrict__ table, float* __restrict__ dw,
            int n_in, int n_out, int k_vol, int c, int lanes, int chunk) {
  __shared__ float red[THREADS * 8];  // [row][lane][8]: [row][channel]
  const int rows = blockDim.x / lanes;
  const int lane = threadIdx.x % lanes, ry = threadIdx.x / lanes;
  const int b = blockIdx.z, k = blockIdx.y;
  const int lo = blockIdx.x * chunk, hi = min(lo + chunk, n_out);
  const int ch = lane * 8;
  const int n_ok = min(8, c - ch);
  const T* xb = x + int64_t(b) * n_in * c + ch;
  const T* gb = g + int64_t(b) * n_out * c + ch;
  const int32_t* trow = table + (int64_t(b) * k_vol + k) * n_out;
  float acc[8] = {};
  int any = 0;
  for (int o0 = lo + ry; o0 < hi; o0 += rows * KB) {
    int32_t r[KB];
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      const int o = o0 + u * rows;
      r[u] = o < hi ? __ldg(trow + o) : -1;
    }
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      if (r[u] < 0) continue;
      any = 1;
      float xv[8], gv[8];
      load8<VEC>(xb + int64_t(r[u]) * c, n_ok, xv);
      load8<VEC>(gb + int64_t(o0 + u * rows) * c, n_ok, gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = fmaf(xv[e], gv[e], acc[e]);
    }
  }
  if (!__syncthreads_or(any)) return;  // no pair of offset k in the chunk
#pragma unroll
  for (int e = 0; e < 8; ++e) red[threadIdx.x * 8 + e] = acc[e];
  __syncthreads();
  const int width = lanes * 8;
  for (int cc = threadIdx.x; cc < c; cc += blockDim.x) {
    float s = 0.f;
    for (int y = 0; y < rows; ++y) s += red[y * width + cc];
    if (s != 0.f) atomicAdd(dw + int64_t(k) * c + cc, s);
  }
}

// ---- K8: fused self-map backward ---------------------------------------------

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 4)
depth_bwd_fused(const T* __restrict__ x, const T* __restrict__ g,
                const float* __restrict__ w, const int32_t* __restrict__ table,
                T* __restrict__ dx, float* __restrict__ dw,
                int n, int k_vol, int c, int lanes, int kc) {
  extern __shared__ __align__(16) float smem[];
  const int rows = THREADS / lanes;  // threads past lanes * rows only stage
  const int width = lanes * 8;
  float* g_s = smem;                 // [rows][width]: g of the block's rows
  const Lists L(g_s + rows * width, kc, rows);
  const int lane = threadIdx.x % lanes, ry = threadIdx.x / lanes;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows, i = r0 + ry;
  const bool active = ry < rows && i < n;
  const int ch = lane * 8;
  const int n_ok = min(8, c - ch);
  const T* xb = x + int64_t(b) * n * c;
  const T* gb = g + int64_t(b) * n * c;
  const int32_t* tb = table + int64_t(b) * k_vol * n;
  if (ry < rows) {
    float gi[8] = {};
    if (active) load8<VEC>(gb + int64_t(i) * c + ch, n_ok, gi);
#pragma unroll
    for (int e = 0; e < 8; ++e) g_s[ry * width + ch + e] = gi[e];
  }
  float acc[8] = {};
  for (int k0 = 0; k0 < k_vol; k0 += kc) {
    if (stage_lists<true>(tb, n, k_vol, k0, kc, r0, rows, L)) {
      // dx part: thread (row i, lane) walks its row's valid entries,
      // dx[i] += g[j] * w[K-1-k] (the reverse of a symmetric self-map is
      // its table with K flipped), in registers across all K.
      if (active) {
        const int m = L.cnt[ry];
        const int32_t* pj = L.j + ry * kc;
        const int16_t* pk = L.kk + ry * kc;
        for (int e0 = 0; e0 < m; e0 += 4) {
          int32_t j[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) j[u] = e0 + u < m ? pj[e0 + u] : -1;
          float gv[4][8];
          gather4<VEC>(gb + ch, c, j, n_ok, gv);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (j[u] < 0) continue;
            float wv[8];
            load8<VEC>(w + int64_t(k_vol - 1 - k0 - pk[e0 + u]) * c + ch, n_ok, wv);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[e] = fmaf(gv[u][e], wv[e], acc[e]);
          }
        }
      }
      // dw part: thread (offset k, lane) walks the offset's valid rows,
      // sums x[j] * g[i] in registers and adds the sum into dw.
      for (int p = threadIdx.x; p < lanes * kc; p += blockDim.x) {
        const int ln = p / kc, kk = p % kc;
        const int cnt = L.ccnt[kk];
        if (cnt == 0) continue;
        const int m = min(8, c - ln * 8);
        const int16_t* pr = L.r + kk * rows;
        float sum[8] = {};
        for (int e0 = 0; e0 < cnt; e0 += 4) {
          int32_t j[4], q[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            q[u] = e0 + u < cnt ? pr[e0 + u] : 0;
            j[u] = e0 + u < cnt ? L.tile[kk * (rows | 1) + q[u]] : -1;
          }
          float xv[4][8];
          gather4<VEC>(xb + ln * 8, c, j, m, xv);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (j[u] < 0) continue;
            const float* gr = g_s + q[u] * width + ln * 8;
#pragma unroll
            for (int e = 0; e < 8; ++e) sum[e] = fmaf(xv[u][e], gr[e], sum[e]);
          }
        }
        float* d = dw + int64_t(k0 + kk) * c + ln * 8;
        if (VEC) {
          atomicAdd(reinterpret_cast<float4*>(d), make_float4(sum[0], sum[1], sum[2], sum[3]));
          atomicAdd(reinterpret_cast<float4*>(d) + 1, make_float4(sum[4], sum[5], sum[6], sum[7]));
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (e < m) atomicAdd(d + e, sum[e]);
        }
      }
    }
    __syncthreads();  // the lists are restaged next round
  }
  if (active) store8<VEC>(dx + (int64_t(b) * n + i) * c + ch, n_ok, acc);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// One 16-byte (or two) vector per 8 channels: C % 8 == 0, aligned bases.
bool vec_ok(int c, const void* a, const void* b, const void* d, const void* e = nullptr) {
  return c % 8 == 0 && aligned16(a) && aligned16(b) && aligned16(d) &&
         (e == nullptr || aligned16(e));
}

template <typename T, bool VEC>
int launch_fwd(const void* x, const float* w, const int32_t* table, void* out, int b, int n_in,
               int n_out, int k_vol, int c, cudaStream_t stream) {
  const int lanes = (c + 7) / 8, rows = THREADS / lanes;
  const int kc = round_offsets(k_vol, rows, 32 * 1024);
  const dim3 grid((n_out + rows - 1) / rows, b);
  depth_fwd<T, VEC><<<grid, THREADS, lists_bytes(kc, rows), stream>>>(
      static_cast<const T*>(x), w, table, static_cast<T*>(out), n_in, n_out, k_vol, c, lanes,
      kc);
  return int(cudaGetLastError());
}

template <typename T, bool VEC>
int launch_wgrad(const void* x, const void* g, const int32_t* table, float* dw, int b, int n_in,
                 int n_out, int k_vol, int c, cudaStream_t stream) {
  const int lanes = (c + 7) / 8, rows = THREADS / lanes;
  // Rows per block: long chunks keep the atomics few; halve them until the
  // grid has about four blocks for each SM.
  int chunk = 4096;
  while (chunk > 256 && int64_t(b) * k_vol * ((n_out + chunk - 1) / chunk) < 4 * SMS) chunk /= 2;
  const dim3 grid((n_out + chunk - 1) / chunk, k_vol, b);
  depth_wgrad<T, VEC><<<grid, lanes * rows, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), table, dw, n_in, n_out, k_vol, c,
      lanes, chunk);
  return int(cudaGetLastError());
}

template <typename T, bool VEC>
int launch_bwd_fused(const void* x, const void* g, const float* w, const int32_t* table,
                     void* dx, float* dw, int b, int n, int k_vol, int c, cudaStream_t stream) {
  const int lanes = (c + 7) / 8, rows = THREADS / lanes;
  const int kc = round_offsets(k_vol, rows, 24 * 1024);
  const size_t smem = size_t(rows) * lanes * 8 * sizeof(float) + lists_bytes(kc, rows);
  const dim3 grid((n + rows - 1) / rows, b);
  depth_bwd_fused<T, VEC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), w, table, static_cast<T*>(dx), dw, n,
      k_vol, c, lanes, kc);
  return int(cudaGetLastError());
}

bool bad_shape(int b, int k_vol, int c) {
  return b < 0 || k_vol < 0 || c <= 0 || c > MAX_CHANNELS || b > 65535 || k_vol > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, g, out and dx share it); w is fp32.
// dw must be zeroed. C is at most 1024.
extern "C" int wct_depth_fwd(const void* x, const float* w, const int32_t* table, void* out,
                             int b, int n_in, int n_out, int k_vol, int c, int dtype,
                             cudaStream_t stream) {
  if (bad_shape(b, k_vol, c)) return int(cudaErrorInvalidValue);
  if (b == 0 || n_out == 0) return 0;
  const bool vec = vec_ok(c, x, w, out);
  if (dtype == 0)
    return vec ? launch_fwd<float, true>(x, w, table, out, b, n_in, n_out, k_vol, c, stream)
               : launch_fwd<float, false>(x, w, table, out, b, n_in, n_out, k_vol, c, stream);
  if (dtype == 1)
    return vec ? launch_fwd<bf16, true>(x, w, table, out, b, n_in, n_out, k_vol, c, stream)
               : launch_fwd<bf16, false>(x, w, table, out, b, n_in, n_out, k_vol, c, stream);
  return int(cudaErrorInvalidValue);
}

extern "C" int wct_depth_wgrad(const void* x, const void* g, const int32_t* table, float* dw,
                               int b, int n_in, int n_out, int k_vol, int c, int dtype,
                               cudaStream_t stream) {
  if (bad_shape(b, k_vol, c)) return int(cudaErrorInvalidValue);
  if (b == 0 || n_out == 0 || k_vol == 0) return 0;
  const bool vec = vec_ok(c, x, g, dw);
  if (dtype == 0)
    return vec ? launch_wgrad<float, true>(x, g, table, dw, b, n_in, n_out, k_vol, c, stream)
               : launch_wgrad<float, false>(x, g, table, dw, b, n_in, n_out, k_vol, c, stream);
  if (dtype == 1)
    return vec ? launch_wgrad<bf16, true>(x, g, table, dw, b, n_in, n_out, k_vol, c, stream)
               : launch_wgrad<bf16, false>(x, g, table, dw, b, n_in, n_out, k_vol, c, stream);
  return int(cudaErrorInvalidValue);
}

extern "C" int wct_depth_bwd_fused(const void* x, const void* g, const float* w,
                                   const int32_t* table, void* dx, float* dw, int b, int n,
                                   int k_vol, int c, int dtype, cudaStream_t stream) {
  if (bad_shape(b, k_vol, c) || k_vol == 0) return int(cudaErrorInvalidValue);
  if (b == 0 || n == 0) return 0;
  const bool vec = vec_ok(c, x, g, w, dx) && aligned16(dw);
  if (dtype == 0)
    return vec ? launch_bwd_fused<float, true>(x, g, w, table, dx, dw, b, n, k_vol, c, stream)
               : launch_bwd_fused<float, false>(x, g, w, table, dx, dw, b, n, k_vol, c, stream);
  if (dtype == 1)
    return vec ? launch_bwd_fused<bf16, true>(x, g, w, table, dx, dw, b, n, k_vol, c, stream)
               : launch_bwd_fused<bf16, false>(x, g, w, table, dx, dw, b, n, k_vol, c, stream);
  return int(cudaErrorInvalidValue);
}
