// Throughput of the Hopper wgmma shapes that the segment-attention forward
// (K9, warpconvnet_tpu_torch/csrc/segment_attention_fwd_{tf32,bf16}.cu)
// issues, alone: one block of 1-3 warpgroups on each of the card's 132 SMs
// loops over one commit group of products against zeroed shared-memory
// tiles (A from registers or shared memory, B K-major or MN-major), waiting
// for each group. Prints the card's name and TFLOP/s per shape.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//     -o warpconvnet_tpu_torch/_build/wgmma_rates tools/wgmma_rates.cu
//   warpconvnet_tpu_torch/_build/wgmma_rates
#include <cstdio>
#include <cuda_runtime.h>

#include "../warpconvnet_tpu_torch/csrc/hopper.cuh"

using namespace wct::hopper;

constexpr int ITER = 4096;      // commit groups a warpgroup issues
constexpr int SMEM = 66560;     // the tiles' bytes (the largest, tf32 A at 32 KiB)

enum Kind {
  BF16_RS_KMAJOR,   // S = Q K^T, Q from registers: m64n64k16 x 4
  BF16_SS,          // S with Q in shared memory: m64n64k16 x 4
  BF16_RS_MNMAJOR,  // P V: m64n64k16 x 4, B MN-major
  TF32_SS_N32,      // fp32 S, both operands in shared memory: m64n32k8 x 24
  TF32_RS_N32,      // fp32 S, Q from registers: m64n32k8 x 24
  TF32_RS_N64,      // fp32 P V at 32-row steps: m64n64k8 x 12
  TF32_RS_N64_S,    // fp32 S at 64-row steps, Q from registers: m64n64k8 x 24
};

template <Kind KIND, int NWG>
__global__ void __launch_bounds__(NWG * 128, 1) rates(float* out) {
  extern __shared__ __align__(1024) unsigned char sm[];
  const uint32_t tb = (static_cast<uint32_t>(__cvta_generic_to_shared(sm)) + 1023u) & ~1023u;
  for (int i = threadIdx.x; i < SMEM / 4; i += blockDim.x) reinterpret_cast<float*>(sm)[i] = 0.f;
  fence_async_proxy();
  __syncthreads();
  float d[32];
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  float (&d16)[16] = *reinterpret_cast<float(*)[16]>(d);
  const uint32_t a[4] = {0u, 0u, 0u, 0u};
  for (int it = 0; it < ITER; ++it) {
    hold(d);
    wg_fence();
    if constexpr (KIND == BF16_RS_KMAJOR) {
      for (int k = 0; k < 4; ++k) wgmma_rs_kmajor(d, a, Tile<64>::k_major(tb, k));
    } else if constexpr (KIND == BF16_SS) {
      for (int k = 0; k < 4; ++k)
        wgmma_ss(d, Tile<64>::k_major(tb + 16384, k), Tile<64>::k_major(tb, k), 1);
    } else if constexpr (KIND == BF16_RS_MNMAJOR) {
      for (int k = 0; k < 4; ++k) wgmma_rs(d, a, Tile<64>::mn_major(tb, k, 0));
    } else if constexpr (KIND == TF32_SS_N32) {
      for (int k = 0; k < 24; ++k)
        wgmma_tf32_ss(d16, Tile<64, 4>::k_major(tb + 32768, k % 8),
                      Tile<64, 4, 32>::k_major(tb, k % 8), 1);
    } else if constexpr (KIND == TF32_RS_N32) {
      for (int k = 0; k < 24; ++k) wgmma_tf32_rs(d16, a, Tile<64, 4, 32>::k_major(tb, k % 8));
    } else if constexpr (KIND == TF32_RS_N64) {
      for (int k = 0; k < 12; ++k) wgmma_tf32_rs(d, a, Tile<32, 4, 64>::k_major(tb, k % 4));
    } else {
      for (int k = 0; k < 24; ++k) wgmma_tf32_rs(d, a, Tile<64, 4>::k_major(tb, k % 8));
    }
    wg_commit();
    wg_wait<0>();
  }
  hold(d);
  float acc = 0.f;
  for (int i = 0; i < 32; ++i) acc += d[i];
  if (acc == 12345.f) out[0] = acc;  // keeps the products live
}

template <Kind KIND, int NWG>
void run(const char* name, double flop_per_group) {
  float* out;
  cudaMalloc(&out, sizeof(float));
  auto kernel = rates<KIND, NWG>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM + 1024);
  kernel<<<132, NWG * 128, SMEM + 1024>>>(out);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  for (int r = 0; r < 3; ++r) kernel<<<132, NWG * 128, SMEM + 1024>>>(out);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  ms /= 3;
  const double flop = flop_per_group * ITER * NWG * 132;
  printf("%-36s %d warpgroups: %.3f ms, %.1f TFLOP/s (%s)\n", name, NWG, ms, flop / ms / 1e9,
         cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("%s\n", prop.name);
  const double s64 = 4.0 * 64 * 64 * 16 * 2, t32 = 24.0 * 64 * 32 * 8 * 2,
               t64 = 12.0 * 64 * 64 * 8 * 2;
  run<BF16_RS_KMAJOR, 1>("bf16 RS m64n64k16 K-major x4", s64);
  run<BF16_RS_KMAJOR, 3>("bf16 RS m64n64k16 K-major x4", s64);
  run<BF16_SS, 3>("bf16 SS m64n64k16 x4", s64);
  run<BF16_RS_MNMAJOR, 3>("bf16 RS m64n64k16 MN-major x4", s64);
  run<TF32_SS_N32, 2>("tf32 SS m64n32k8 x24", t32);
  run<TF32_RS_N32, 2>("tf32 RS m64n32k8 x24", t32);
  run<TF32_RS_N64, 2>("tf32 RS m64n64k8 x12", t64);
  run<TF32_RS_N64_S, 2>("tf32 RS m64n64k8 x24 (S, 64 rows)", 2 * t64);
  return 0;
}
