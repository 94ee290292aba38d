// Shared by the segment-attention backward kernels K9-dkv and K9-dq: their
// arguments, the rule that picks the visited tiles, and the fp32 and bf16
// launchers (segment_attention_bwd_tf32.cu, segment_attention_bwd_bf16.cu)
// that the C entry points of segment_attention_bwd.cu call.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace wct::seg_bwd {

constexpr int TILE = 64;  // rows of the own tile and of each visited tile
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;       // dO [B, Sq, H, D]
  const float* lse;       // [B, H, Sq], natural log
  const float* di;        // [B, H, Sq]
  const int32_t* seg_q;   // [B, Sq]
  const int32_t* seg_kv;  // [B, Skv]
  void* dq;               // [B, Sq, H, D]  (K9-dq)
  void* dk;               // [B, Skv, H, D] (K9-dkv)
  void* dv;               // [B, Skv, H, D] (K9-dkv)
  int sq, skv, h;
  int64_t q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss;  // elements
  float scale, scale_log2;
  int nwords;  // bitmask words: ceil(other tiles / 32)
};

// Loads the OWN rows' segment ids of the own tile into seg_own (rows past
// n_own get INT_MAX and are left out of the range) and sets bit t of
// `bits` for every other tile t (TILE rows) that holds a row j < n_oth with
// soth[j] in [min, max] of the own tile's segments. NT threads (at least
// OWN); ends with the block synchronised.
template <int NT, int OWN = TILE>
__device__ void mark_tiles(const int32_t* sown, int n_own, int own0, const int32_t* soth,
                           int n_oth, int nwords, int32_t* seg_own, unsigned* bits, int* range) {
  const int t = threadIdx.x;
  for (int i = t; i < nwords; i += NT) bits[i] = 0u;
  if (t == 0) {
    range[0] = INT_MAX;
    range[1] = INT_MIN;
  }
  __syncthreads();
  if (t < OWN) {
    const int r = own0 + t;
    int s = INT_MAX;
    if (r < n_own) {
      s = sown[r];
      atomicMin(&range[0], s);
      atomicMax(&range[1], s);
    }
    seg_own[t] = s;
  }
  __syncthreads();
  const int lo = range[0], hi = range[1];
  const int lane = t & 31;
  // Each warp takes 32 consecutive rows at a time, all inside one tile.
  for (int j0 = t & ~31; j0 < n_oth; j0 += NT) {
    const int j = j0 + lane;
    bool hit = false;
    if (j < n_oth) {
      const int s = soth[j];
      hit = s >= lo && s <= hi;
    }
    if (__ballot_sync(0xffffffffu, hit) != 0u && lane == 0) {
      const int tile = j0 / TILE;
      atomicOr(&bits[tile >> 5], 1u << (tile & 31));
    }
  }
  __syncthreads();
}

// K9-dkv (dkv) or K9-dq for head dim d on fp32 inputs (the 3xTF32 kernels
// of segment_attention_bwd_tf32.cu) or bf16 inputs (the kernels of
// segment_attention_bwd_bf16.cu). Return a CUDA error code. fp32 runs a
// pass a scene and per_pass of its heads through `split`, the scratch of
// split_bytes_tf32(per_pass, visited rows, d, dkv) bytes that holds their
// visited rows (K9-dkv: Sq, K9-dq: Skv) split into TF32 hi and lo;
// `staged` (or null) counts the visited rows the blocks copy in.
int launch_tf32(const Args& a, int b, int d, bool dkv, void* split, int per_pass,
                unsigned long long* staged, cudaStream_t stream);
int64_t split_bytes_tf32(int nh, int rows, int d, bool dkv);
int launch_bf16(const Args& a, int b, int d, bool dkv, cudaStream_t stream);

}  // namespace wct::seg_bwd
