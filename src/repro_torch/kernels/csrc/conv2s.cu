// One k2s2 convolution + bias + ReLU, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/conv2s.py
// (_conv2s_kernel / conv2s_pallas): x (B, N, C) -> (B, N/2, Co) with
//   out[b, i, o] = relu(bias[o] + sum_k x2[b, i, k] * W[k, o])
// where x2 is x viewed as (B, N/2, 2C): rows 2i and 2i+1 side by side. It is
// one layer of the C3 trunk, reached through the public kernels.ops.conv2s
// API; the wrapper hands it f32, as the reference's wrapper does.
//
// What bounds it on this card: at the first C3 layer's shape
// ((1024, 72, 50) -> 64 channels) it does ~0.47 GFLOP of f32 FMAs (~7 us at
// the H100 SXM's ~67 TFLOP/s outside the tensor cores) against ~24 MB read
// and written once (~7 us at 3.35 TB/s): operations and bytes about even.
//
// What the design does about it: the same plan as the fused trunk kernels
// (trunk_common.cuh). A 256-thread block loads up to 4 lanes' inputs into
// shared memory with coalesced reads (no lane or channel padding; the
// ragged lane edge is masked), then computes register tiles of 9 rows x 4
// (or 2) output channels with f32 fmaf, k ascending, reading the weights
// through the read-only cache, where every block finds them in L2, and
// writes the outputs straight to device memory.

#include <cuda_runtime.h>

#include "trunk_common.cuh"

namespace {

template <int CN>
__global__ void __launch_bounds__(trunk::kThreads)
conv2s_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ out, int B, int N, int C,
              int Co, int TB) {
  extern __shared__ __align__(16) float smem[];
  const int lane0 = blockIdx.x * TB;
  const int n_lanes = min(TB, B - lane0);
  const int per_lane = N * C;
  const float* src = x + (size_t)lane0 * per_lane;
  const int live = n_lanes * per_lane;
  for (int i = threadIdx.x; i < TB * per_lane; i += blockDim.x) {
    smem[i] = i < live ? src[i] : 0.f;
  }
  __syncthreads();
  trunk::layer<trunk::kRows, CN>(smem, TB * (N / 2), 2 * C, w, bias, Co,
                                 out + (size_t)lane0 * (N / 2) * Co, n_lanes * (N / 2));
}

template <int CN>
cudaError_t launch(const float* x, const float* w, const float* b, float* out, int B, int N,
                   int C, int Co, cudaStream_t stream) {
  int max_smem = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int tb = 4;
  while (tb > 0 && sizeof(float) * (size_t)tb * N * C > (size_t)max_smem) --tb;
  if (tb == 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)tb * N * C;
  cudaError_t err = cudaFuncSetAttribute(conv2s_kernel<CN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + tb - 1) / tb;
  conv2s_kernel<CN><<<blocks, trunk::kThreads, smem, stream>>>(x, w, b, out, B, N, C, Co, tb);
  return cudaGetLastError();
}

}  // namespace

// x (B, N, C), w (2C, Co), b (Co,), out (B, N/2, Co): f32, contiguous, w
// 16-byte aligned. Needs N and C even (rows of 2C floats stay 16-byte
// aligned in shared memory) and Co even (register tiles of 4 or 2 columns).
extern "C" int conv2s_launch(const void* x, const void* w, const void* b, void* out, int B, int N,
                             int C, int Co, void* stream) {
  if (B <= 0 || N <= 0 || N % 2 != 0 || C <= 0 || C % 2 != 0 || Co <= 0 || Co % 2 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* of = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Co % 4 == 0) return (int)launch<4>(xf, wf, bf, of, B, N, C, Co, st);
  return (int)launch<2>(xf, wf, bf, of, B, N, C, Co, st);
}
