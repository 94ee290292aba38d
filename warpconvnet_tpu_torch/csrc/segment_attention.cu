// Segment-masked attention forward (K9):
//   out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h]) * v[b, j, h]
// over the kv rows j with seg_kv[b, j] == seg_q[b, i]; a query row with no
// such j gives 0 (the contract of masked_sdpa), and its log-sum-exp, when
// asked for, is +inf. q [B, Sq, H, D] and k, v [B, Skv, H, D] share fp32 or
// bf16; D is 16, 32, 64 or 128. Softmax state and sums are fp32; out
// [B, Sq, H, D] is contiguous, in the inputs' dtype. q, k and v are read
// through their batch and row strides (in elements; each row's [H, D] block
// contiguous), so the Q/K/V slices of a fused QKV projection need no copy.
//
// Replaces: the stock Pallas TPU flash attention
// (jax.experimental.pallas.ops.tpu.flash_attention) that
// warpconvnet_tpu/nn/functional/flash_attention.py `segment_attention`
// (:73-155) calls with SegmentIds, forward only.
//
// Both dtypes run on Hopper's tensor cores (wgmma): fp32 as 3xTF32 split
// products in segment_attention_fwd_tf32.cu, bf16 in
// segment_attention_fwd_bf16.cu. This file holds the C entry point.
#include <cstdint>
#include <cuda_runtime.h>

#include "segment_attention_fwd.cuh"

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). Strides are
// in elements; the wrapper checks 16-byte alignment of every row. lse may be
// null. `visit` is scratch of wct_segment_attention_visit_ints(b, sq) ints
// for the visit pre-pass (segment_attention_visit.cu), and `visits` (or
// null) two int64 counters: the blocks that took their visited tiles from
// it, and those that scanned. fp32 only: `split` is scratch of
// wct_segment_attention_fwd_split_bytes(per_pass, skv, h, d) bytes, 16-byte
// aligned, through which per_pass scenes run at a time, and `staged` (or
// null) an int64 counter of the kv rows the blocks copy in; bf16 ignores
// the three.
extern "C" int wct_segment_attention_fwd(const void* q, const void* k, const void* v,
                                         const int32_t* seg_q, const int32_t* seg_kv, void* out,
                                         float* lse, int b, int sq, int skv, int h, int d,
                                         int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                                         int64_t v_sb, int64_t v_ss, float scale, int dtype,
                                         void* split, int per_pass, int64_t* staged,
                                         int32_t* visit, int64_t* visits, cudaStream_t stream) {
  if (b == 0 || sq == 0 || h == 0) return 0;
  const int kv_tiles = (skv + wct::seg_fwd::TILE - 1) / wct::seg_fwd::TILE;
  const wct::seg_fwd::Args a{q, k, v, seg_q, seg_kv, out, lse, sq, skv, h,
                             q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale * wct::seg_bwd::LOG2E,
                             (kv_tiles + 31) / 32, visit,
                             reinterpret_cast<unsigned long long*>(visits)};
  if (dtype == 0)
    return wct::seg_fwd::launch_tf32(a, b, d, split, per_pass,
                                     reinterpret_cast<unsigned long long*>(staged), stream);
  if (dtype == 1) return wct::seg_fwd::launch_bf16(a, b, d, stream);
  return int(cudaErrorInvalidValue);
}

// Bytes of the fp32 forward's scratch for nb scenes (-1 for a head dim the
// kernel does not take).
extern "C" int64_t wct_segment_attention_fwd_split_bytes(int nb, int skv, int h, int d) {
  return wct::seg_fwd::split_bytes_tf32(nb, skv, h, d);
}
