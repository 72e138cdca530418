// The whole SimNet C3 conv trunk in one kernel, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/cnn_trunk.py
// (_trunk_kernel / cnn_trunk_pallas): three k2s2 GEMM + bias + ReLU layers
// on an assembled (B, N, C) input, -> (B, N/8, C3), with the activations
// kept on chip between the layers. The engine reaches it for the roll
// layout and for a bf16 state; the wrapper hands it f32, as the reference's
// wrapper does.
//
// What bounds it on this card: arithmetic. At the main path's shape
// (B = 1024, N = 72, C = 50, channels 64/128/128) one launch does ~1.7 GFLOP
// of f32 FMAs against ~20 MB read and written once: ~25 us of FMAs at the
// H100 SXM's ~67 TFLOP/s f32, ~6 us of bytes at 3.35 TB/s.
//
// What the design does about it: the TPU kernel kept a 64-lane tile and all
// weights in VMEM, which does not fit a block's 227 KB of shared memory in
// f32. Here a block of 256 threads loads 4 lanes' inputs into shared memory
// (coalesced, no channel pad), runs the three layers from shared memory
// with register tiles of f32 FMAs, and reads the weights through the
// read-only cache (L2-resident, shared by all blocks); see trunk_common.cuh.

#include <cuda_runtime.h>

#include "trunk_common.cuh"

namespace {

__global__ void __launch_bounds__(trunk::kThreads, 2)
cnn_trunk_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, const float* __restrict__ w3,
                 const float* __restrict__ b3, float* __restrict__ out, int B, int S, int C0,
                 int C1, int C2, int C3, int TB) {
  extern __shared__ __align__(16) float smem[];
  float* bufA = smem;
  float* bufB = smem + trunk::buf_a_floats(TB, S, C0, C2);
  const int lane0 = blockIdx.x * TB;
  const int n_lanes = min(TB, B - lane0);
  const int per_lane = S * C0;
  const float* src = x + (size_t)lane0 * per_lane;
  const int live = n_lanes * per_lane;
  for (int i = threadIdx.x; i < TB * per_lane; i += blockDim.x) {
    bufA[i] = i < live ? src[i] : 0.f;
  }
  __syncthreads();
  trunk::run_trunk(bufA, bufB, TB, S, C0, C1, C2, C3, w1, b1, w2, b2, w3, b3,
                   out + (size_t)lane0 * (S / 8) * C3, n_lanes);
}

}  // namespace

extern "C" int cnn_trunk_launch(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* b2, const void* w3, const void* b3, void* out,
                                int B, int S, int C0, int C1, int C2, int C3, void* stream) {
  if (B <= 0 || S % 8 != 0 || C0 % 2 != 0 || C1 % 4 != 0 || C2 % 4 != 0 || C3 % 2 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  size_t smem = 0;
  const int TB = trunk::lanes_per_block(S, C0, C1, C2, &smem);
  if (TB == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cnn_trunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + TB - 1) / TB;
  cnn_trunk_kernel<<<blocks, trunk::kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w1, (const float*)b1, (const float*)w2, (const float*)b2,
      (const float*)w3, (const float*)b3, (float*)out, B, S, C0, C1, C2, C3, TB);
  return (int)cudaGetLastError();
}
