// Segment-masked attention backward: the C entry points of K9-dkv and
// K9-dq. fp32 runs the 3xTF32 tensor-core kernels of
// segment_attention_bwd_tf32.cu, bf16 those of
// segment_attention_bwd_bf16.cu; segment_attention_bwd.cuh holds their
// arguments and the rule that picks the visited tiles.
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
// query tile and walks the kv tiles. What bounds each kernel and how it is
// built is in its own file.
#include <cstdint>
#include <cuda_runtime.h>

#include "segment_attention_bwd.cuh"

namespace {

using wct::seg_bwd::Args;
using wct::seg_bwd::LOG2E;
using wct::seg_bwd::TILE;

template <bool DKV>
int launch_d(const Args& a, int b, int d, int dtype, void* split, int per_pass, int64_t* staged,
             cudaStream_t stream) {
  if (dtype == 0)
    return wct::seg_bwd::launch_tf32(a, b, d, DKV, split, per_pass,
                                     reinterpret_cast<unsigned long long*>(staged), stream);
  if (dtype == 1) return wct::seg_bwd::launch_bf16(a, b, d, DKV, stream);
  return int(cudaErrorInvalidValue);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* di, const int32_t* seg_q, const int32_t* seg_kv, void* dq, void* dk,
               void* dv, int sq, int skv, int h, const int64_t* strides, float scale,
               int other_rows, int32_t* visit, int64_t* visits) {
  const int tiles = (other_rows + TILE - 1) / TILE;
  return Args{q, k, v, dout, lse, di, seg_q, seg_kv, dq, dk, dv, sq, skv, h,
              strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
              strides[6], strides[7], scale, scale * LOG2E, (tiles + 31) / 32, visit,
              reinterpret_cast<unsigned long long*>(visits)};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients share
// it). strides: the batch and row strides, in elements, of q, k, v and
// dout, in that order; the wrapper checks 16-byte alignment of every row.
// Every row of dk and dv (dq) is written. `visit` is scratch of
// wct_segment_attention_visit_ints(b, own rows) ints (own rows: Skv for
// K9-dkv, Sq for K9-dq) for the visit pre-pass, and `visits` (or null) two
// int64 counters of the blocks that took their visited tiles from it and
// of those that scanned. fp32 only: `split` is scratch of
// wct_segment_attention_bwd_split_bytes(per_pass, rows, d, dkv) bytes
// (rows: Sq for K9-dkv, Skv for K9-dq), 16-byte aligned, through which
// one scene and per_pass of its heads run at a time, and `staged` (or
// null) an int64 counter of the visited rows the blocks copy in; bf16
// ignores the three.
extern "C" int wct_segment_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                             const void* dout, const float* lse, const float* di,
                                             const int32_t* seg_q, const int32_t* seg_kv,
                                             void* dk, void* dv, int b, int sq, int skv, int h,
                                             int d, const int64_t* strides, float scale,
                                             int dtype, void* split, int per_pass,
                                             int64_t* staged, int32_t* visit, int64_t* visits,
                                             cudaStream_t stream) {
  if (b == 0 || skv == 0 || h == 0) return 0;
  const Args a = make_args(q, k, v, dout, lse, di, seg_q, seg_kv, nullptr, dk, dv, sq, skv, h,
                           strides, scale, sq, visit, visits);
  return launch_d<true>(a, b, d, dtype, split, per_pass, staged, stream);
}

extern "C" int wct_segment_attention_bwd_dq(const void* q, const void* k, const void* v,
                                            const void* dout, const float* lse, const float* di,
                                            const int32_t* seg_q, const int32_t* seg_kv,
                                            void* dq, int b, int sq, int skv, int h, int d,
                                            const int64_t* strides, float scale, int dtype,
                                            void* split, int per_pass, int64_t* staged,
                                            int32_t* visit, int64_t* visits, cudaStream_t stream) {
  if (b == 0 || sq == 0 || h == 0) return 0;
  const Args a = make_args(q, k, v, dout, lse, di, seg_q, seg_kv, dq, nullptr, nullptr, sq, skv,
                           h, strides, scale, skv, visit, visits);
  return launch_d<false>(a, b, d, dtype, split, per_pass, staged, stream);
}

// Bytes of the fp32 backward's scratch for nh heads of one scene whose
// visited rows number `rows` (K9-dkv when dkv, else K9-dq); -1 for a head
// dim the kernels do not take.
extern "C" int64_t wct_segment_attention_bwd_split_bytes(int nh, int rows, int d, int dkv) {
  return wct::seg_bwd::split_bytes_tf32(nh, rows, d, dkv != 0);
}
