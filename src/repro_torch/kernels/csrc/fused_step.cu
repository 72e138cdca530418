// Fused SimNet sim-step inference off the ring-buffer state, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/fused_step.py
// (_fused_step_kernel / fused_step_pallas). Per lane it computes what that
// kernel computes: the dependency flags (addr == cur_addr, cur_addr != 0),
// the 50-wide context rows (static 41 + resid/exec/store * LAT_SCALE + 5
// flags + valid, rows of invalid slots zeroed by multiplying with valid),
// the physical -> recency reorder (recency r lives at slot
// (head - 1 - r) mod Q: index arithmetic, with the head cursor read from
// device memory), the current-instruction row prepended, zero rows up to
// seq_padded, then the three k2s2 GEMM + bias + ReLU layers of the C3 trunk.
// The assembled (L, seq_padded, 50) input never reaches device memory.
//
// What bounds it on this card: arithmetic. At the main path's shape
// (L = 1024, Q = 64, channels 64/128/128) one launch does ~1.7 GFLOP of f32
// FMAs against ~18 MB read and written once, so at the H100 SXM's
// ~67 TFLOP/s f32 and 3.35 TB/s the FMAs need ~25 us and the bytes ~5 us.
//
// What the design does about it: the TPU kernel kept a 64-lane tile and all
// three weights (224 KiB in f32 after its 50 -> 64 channel pad) in VMEM,
// which does not fit in a block's 227 KB of shared memory. Here a block of
// 256 threads takes 4 lanes: it assembles their (72, 50) inputs in shared
// memory (no channel pad: the first GEMM's depth is 100, not 128), runs the
// three layers from shared memory with 9x4 (9x2 in layer 3) register tiles
// of f32 FMAs, and reads the weights through the read-only cache, where
// every block finds them in L2. 94 KB of shared memory per block lets two
// blocks share an SM. Tensor cores (TF32, bf16) would break f32 parity and
// are left for a later change behind an explicit option.

#include <cuda_runtime.h>

#include "trunk_common.cuh"

namespace {

constexpr int kStatic = 41;   // static feature block per instruction
constexpr int kAddr = 5;      // address keys per instruction
constexpr int kFeat = 50;     // model input width: 41 + 3 latencies + 5 flags + valid
constexpr float kLatScale = 1.0f / 64.0f;

__global__ void __launch_bounds__(trunk::kThreads, 2)
fused_step_kernel(const float* __restrict__ feat, const int* __restrict__ addr,
                  const float* __restrict__ resid, const float* __restrict__ exec_lat,
                  const float* __restrict__ store_lat, const unsigned char* __restrict__ valid,
                  const int* __restrict__ head_ptr, const float* __restrict__ cur_feat,
                  const int* __restrict__ cur_addr,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  const float* __restrict__ w3, const float* __restrict__ b3,
                  float* __restrict__ out, int L, int Q, int S, int C1, int C2, int C3, int TB) {
  extern __shared__ __align__(16) float smem[];
  float* bufA = smem;
  float* bufB = smem + trunk::buf_a_floats(TB, S, kFeat, C2);
  const int lane0 = blockIdx.x * TB;
  const int n_lanes = min(TB, L - lane0);
  const int head = *head_ptr;

  // assemble the block's inputs, (TB, S, 50) row-major; channel fastest so
  // neighbouring threads read neighbouring floats of a slot's feature row
  const int per_lane = S * kFeat;
  for (int i = threadIdx.x; i < TB * per_lane; i += blockDim.x) {
    const int lane = i / per_lane;
    const int rem = i - lane * per_lane;
    const int row = rem / kFeat;
    const int ch = rem - row * kFeat;
    const int g = lane0 + lane;
    float v = 0.f;
    if (lane < n_lanes) {
      if (row == 0) {  // current instruction: static block, zero dynamics, valid
        v = ch < kStatic ? cur_feat[(size_t)g * kStatic + ch] : (ch == kFeat - 1 ? 1.f : 0.f);
      } else if (row <= Q) {  // context row of recency r = row - 1
        int s = head - row;
        if (s < 0) s += Q;
        const size_t ls = (size_t)g * Q + s;
        const float vf = valid[ls] ? 1.f : 0.f;
        float raw;
        if (ch < kStatic) {
          raw = feat[ls * kStatic + ch];
        } else if (ch == kStatic) {
          raw = resid[ls] * kLatScale;
        } else if (ch == kStatic + 1) {
          raw = exec_lat[ls] * kLatScale;
        } else if (ch == kStatic + 2) {
          raw = store_lat[ls] * kLatScale;
        } else if (ch < kFeat - 1) {
          const int j = ch - kStatic - 3;
          const int ca = cur_addr[(size_t)g * kAddr + j];
          raw = (addr[ls * kAddr + j] == ca && ca != 0) ? 1.f : 0.f;
        } else {
          raw = vf;
        }
        v = raw * vf;  // multiply (not select), so NaN propagates as in the reference
      }
    }
    bufA[i] = v;
  }
  __syncthreads();
  trunk::run_trunk(bufA, bufB, TB, S, kFeat, C1, C2, C3, w1, b1, w2, b2, w3, b3,
                   out + (size_t)lane0 * (S / 8) * C3, n_lanes);
}

}  // namespace

extern "C" int fused_step_launch(const void* feat, const void* addr, const void* resid,
                                 const void* exec_lat, const void* store_lat, const void* valid,
                                 const void* head, const void* cur_feat, const void* cur_addr,
                                 const void* w1, const void* b1, const void* w2, const void* b2,
                                 const void* w3, const void* b3, void* out, int L, int Q,
                                 int S, int C1, int C2, int C3, void* stream) {
  if (L <= 0 || Q <= 0 || S % 8 != 0 || S < Q + 1 || C1 % 4 != 0 || C2 % 4 != 0 ||
      C3 % 2 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  size_t smem = 0;
  const int TB = trunk::lanes_per_block(S, kFeat, C1, C2, &smem);
  if (TB == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (L + TB - 1) / TB;
  fused_step_kernel<<<blocks, trunk::kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)feat, (const int*)addr, (const float*)resid, (const float*)exec_lat,
      (const float*)store_lat, (const unsigned char*)valid, (const int*)head,
      (const float*)cur_feat, (const int*)cur_addr, (const float*)w1, (const float*)b1,
      (const float*)w2, (const float*)b2, (const float*)w3, (const float*)b3, (float*)out, L,
      Q, S, C1, C2, C3, TB);
  return (int)cudaGetLastError();
}
