// Shared device code of the k2s2 conv kernels (fused_step.cu, cnn_trunk.cu,
// conv2s.cu).
//
// A k2s2 convolution over a (rows, C) activation is one GEMM: rows 2i and
// 2i+1 side by side form row i of a (rows/2, 2C) matrix, which is exactly
// the same memory read with a row stride of 2C. So each layer of the trunk
// is   out[m, n] = relu(b[n] + sum_k A[m, k] * W[k, n])
// with A the block's activations in shared memory (row-major, M x K) and W
// the layer's (K x N) weight in device memory (row-major, read through the
// read-only cache; every block reads the same weights, so they stay in L2).
//
// Each thread owns a register tile of RM rows x CN columns and sums over k
// in ascending order with fmaf, in f32 (no tensor cores: TF32 or bf16 would
// break parity with the f32 reference).
#pragma once

#include <cuda_runtime.h>

namespace trunk {

constexpr int kThreads = 256;  // threads per block
constexpr int kRows = 9;       // RM: register-tile rows (divides 36, 18, 9)

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

// Shared-memory plan for TB lanes of an (S, C0) input and channels C1, C2:
// buffer A holds the input, later layer 2's output; buffer B layer 1's.
// Sizes in floats, rounded to a multiple of 4 so every row stays aligned.
__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int buf_a_floats(int TB, int S, int C0, int C2) {
  const int x = S * C0, h2 = (S / 4) * C2;
  return round4(TB * (x > h2 ? x : h2));
}
__host__ __device__ inline int buf_b_floats(int TB, int S, int C1) {
  return round4(TB * (S / 2) * C1);
}

// The three layers after the block's input is in buffer A: layer 3 writes
// straight to `out` (the block's first output row), storing only the rows
// of the n_lanes live lanes.
__device__ __forceinline__ void run_trunk(float* bufA, float* bufB, int TB, int S, int C0,
                                          int C1, int C2, int C3,
                                          const float* __restrict__ w1, const float* __restrict__ b1,
                                          const float* __restrict__ w2, const float* __restrict__ b2,
                                          const float* __restrict__ w3, const float* __restrict__ b3,
                                          float* __restrict__ out, int n_lanes) {
  layer<kRows, 4>(bufA, TB * (S / 2), 2 * C0, w1, b1, C1, bufB, TB * (S / 2));
  __syncthreads();
  layer<kRows, 4>(bufB, TB * (S / 4), 2 * C1, w2, b2, C2, bufA, TB * (S / 4));
  __syncthreads();
  layer<kRows, 2>(bufA, TB * (S / 8), 2 * C2, w3, b3, C3, out, n_lanes * (S / 8));
}

// Lanes per block: the most (up to 4) whose buffers fit in the shared memory
// a block may take; 0 if not even one lane fits.
inline int lanes_per_block(int S, int C0, int C1, int C2, size_t* smem_bytes) {
  int max_smem = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (int tb = 4; tb >= 1; --tb) {
    const size_t bytes =
        sizeof(float) * (size_t)(buf_a_floats(tb, S, C0, C2) + buf_b_floats(tb, S, C1));
    if (bytes <= (size_t)max_smem) {
      *smem_bytes = bytes;
      return tb;
    }
  }
  return 0;
}

}  // namespace trunk
