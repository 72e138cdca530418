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
// What the design does about it (trunk_common.cuh): a persistent block per
// SM walks tiles of up to 72 (lane, output position) units; a tile's input
// is one contiguous run of units x 8 x C floats, copied into shared memory
// by one bulk copy (cp.async.bulk); the weights stream through a
// shared-memory ring by bulk copies; all warps compute 9 x 8 register tiles
// (5 x 8 in layer 3) of f32 FMAs from shared memory.

#include "trunk_common.cuh"

namespace {

// The tile's input is a contiguous run of units: one bulk copy.
struct DenseInput {
  const float* x;
  int unit_floats;  // 8 x C0

  __device__ void load(int t, long long u0, int n, float* xs, float*, uint64_t* bar) {
    if (threadIdx.x == 0) {
      trunk::bulk_load(xs, x + u0 * unit_floats, (unsigned)(n * unit_floats * sizeof(float)), bar);
    }
    trunk::mbar_wait(bar, t & 1);
  }
};

__global__ void __launch_bounds__(trunk::kBlockThreads, 1)
cnn_trunk_kernel(const float* __restrict__ x, trunk::Weights wt, float* __restrict__ out,
                 long long units, int c0, int umax) {
  extern __shared__ __align__(128) unsigned char smem[];
  DenseInput in{x, 8 * c0};
  trunk::run_tiles(in, smem, trunk::Plan(umax, c0), c0, wt, out, units);
}

trunk::DeviceCache g_cache[trunk::kMaxDevices];

}  // namespace

// x (B, S, C0), out (B, S/8, C3): f32, contiguous, 16-byte aligned; w1
// (2 C0, C1), w2 (2 C1, C2), w3 (2 C2, C3) row-major and the biases, all
// 16-byte aligned. Needs S % 8 == 0, C0 even and the widths the kernel is
// built for (trunk::C1, C2, C3).
extern "C" int cnn_trunk_launch(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* b2, const void* w3, const void* b3, void* out,
                                int B, int S, int C0, int C1, int C2, int C3, void* stream) {
  if (B <= 0 || S <= 0 || S % 8 != 0 || C0 <= 0 || C0 % 2 != 0 || C1 != trunk::C1 ||
      C2 != trunk::C2 || C3 != trunk::C3) {
    return (int)cudaErrorInvalidValue;
  }
  int sms = 0, umax = 0;
  cudaError_t err = trunk::prepare(cnn_trunk_kernel, g_cache, C0, 0, &sms, &umax);
  if (err != cudaSuccess) return (int)err;
  const long long units = (long long)B * (S / 8);
  const int blocks = (int)(units < sms ? units : sms);
  const trunk::Weights wt{{(const float*)w1, (const float*)w2, (const float*)w3},
                          {(const float*)b1, (const float*)b2, (const float*)b3}};
  cnn_trunk_kernel<<<blocks, trunk::kBlockThreads, trunk::Plan(umax, C0).bytes,
                     (cudaStream_t)stream>>>((const float*)x, wt, (float*)out, units, C0, umax);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block (bytes) for input width c0, for the
// build log.
extern "C" int cnn_trunk_smem_bytes(int c0) { return trunk::Plan(trunk::kUnits, c0).bytes; }
