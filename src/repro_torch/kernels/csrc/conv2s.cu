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
// What the design does about it: the plan of the first trunk kernels of
// the port. A 256-thread block loads up to 4 lanes' inputs into shared
// memory with coalesced reads (no lane or channel padding; the ragged lane
// edge is masked), then computes register tiles of 9 rows x 4 (or 2)
// output channels with f32 fmaf, k ascending, reading the weights through
// the read-only cache, where every block finds them in L2, and writes the
// outputs straight to device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kRows = 9;       // RM: register-tile rows

template <int CN>
__device__ __forceinline__ void load_w(const float* __restrict__ p, float (&w)[CN]) {
  if constexpr (CN == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (CN == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else {
#pragma unroll
    for (int c = 0; c < CN; ++c) w[c] = __ldg(p + c);
  }
}

// One k2s2 layer for the whole block. A: (M, K) in shared memory, K % 4 == 0
// and 16-byte aligned rows. W: (K, N) global, N % CN == 0, CN-aligned.
// Rows m >= m_store are computed but not stored (the ragged lane edge).
template <int RM, int CN>
__device__ __forceinline__ void layer(const float* __restrict__ A, int M, int K,
                                      const float* __restrict__ W,
                                      const float* __restrict__ bias, int N,
                                      float* __restrict__ out, int m_store) {
  const int ncg = N / CN;
  const int nrg = (M + RM - 1) / RM;
  for (int t = threadIdx.x; t < nrg * ncg; t += blockDim.x) {
    const int n0 = (t % ncg) * CN;
    const int m0 = (t / ncg) * RM;
    const float* arow[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) arow[r] = A + min(m0 + r, M - 1) * K;
    float acc[RM][CN];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < CN; ++c) acc[r][c] = 0.f;

    for (int k = 0; k < K; k += 4) {
      float4 a[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) a[r] = *reinterpret_cast<const float4*>(arow[r] + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float w[CN];
        load_w<CN>(W + (size_t)(k + kk) * N + n0, w);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float av = kk == 0 ? a[r].x : kk == 1 ? a[r].y : kk == 2 ? a[r].z : a[r].w;
#pragma unroll
          for (int c = 0; c < CN; ++c) acc[r][c] = fmaf(av, w[c], acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (m0 + r < m_store) {
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          const float y = acc[r][c] + __ldg(bias + n0 + c);
          // relu that keeps NaN, as max(x, 0) does in the reference
          out[(size_t)(m0 + r) * N + n0 + c] = y < 0.f ? 0.f : y;
        }
      }
    }
  }
}


template <int CN>
__global__ void __launch_bounds__(kThreads)
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
  layer<kRows, CN>(smem, TB * (N / 2), 2 * C, w, bias, Co,
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
  conv2s_kernel<CN><<<blocks, kThreads, smem, stream>>>(x, w, b, out, B, N, C, Co, tb);
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
