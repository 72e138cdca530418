// Device code shared by the port's persistent sm_90a kernels: the C3 trunk
// (trunk_common.cuh: fused_step.cu, cnn_trunk.cu) and the k2s2 conv
// (conv2s.cu); decode_attn.cu and wkv.cu take its copy helpers.
//
// The persistent kernels run one block per SM of 8 compute warps, which compute
// register tiles of f32 FMAs from shared memory, filled by bulk copies
// (cp.async.bulk) that complete on mbarriers. The trunk kernels add a
// warpgroup whose first thread issues the copies; ptxas then holds every
// thread to 168 registers (setmaxnreg changes what the card allots at run
// time, not what ptxas allocates). The conv kernel issues its copies from
// the compute warps and takes up to 255.
//
// What bounds the FMA loop: the shared-memory pipe. It hands an SM's
// threads 128 bytes a cycle, whatever the broadcast (an LDS.128 takes 4 of
// its cycles for a warp), while the FMA units take 128 FMAs a cycle. A
// thread with a TM x TN register tile takes TM + TN floats per TM * TN
// FMAs, so the pipe keeps up only if 4/TM + 4/TN <= 1: the register tile
// has to be large.
//
// Numerics: f32 outside the tensor cores. Each output's sum stays in one
// thread: the accumulator starts at 0, goes over k in ascending order with
// fmaf (slab_fma), then adds the bias, then ReLU as y < 0 ? 0 : y (NaN
// kept, as max(x, 0) in the reference). So every kernel built on this
// gives the same bits for the same layer input.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace sm90 {

constexpr int kWarps = 8;                      // compute warps
constexpr int kThreads = 32 * kWarps;           // compute threads
constexpr int kSlabFloats = 4096;  // 16 KB: the unit in which weights are copied
constexpr int kMaxDevices = 64;

// ------------------------------------------------------------ PTX wrappers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the mbarrier inits of this thread visible to the async proxy.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A copy that never
// lands would spin forever; past ~2^28 polls (seconds) the kernel traps, so
// the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 28)) __trap();
  }
}

// Orders the block's earlier generic accesses of shared memory before the
// async proxy's (bulk copies) that follow.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Bulk copy of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from device memory to shared memory, completing its bytes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 16 bytes from global to shared memory, asynchronously, through L2 only
// (cp.async.cg); zeros and no read where !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

// One arrival on `bar` once every cp.async this thread issued before has
// landed (the barrier counts it among its expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// One bulk copy that completes the phase of `bar` (one arrival + its bytes).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  fence_async_shared();
  mbar_expect_tx(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

// ------------------------------------------------------------ slab ring

// A ring of SLOTS slabs of kSlabFloats floats in shared memory, each slot
// with a "full" mbarrier (one arrival + the slab's bytes) and an "empty"
// one (kWarps arrivals). An issuing thread copies slab s into slot
// s % SLOTS once every compute warp has released slab s - SLOTS
// (refill_wait); every compute warp reads the slabs in order: wait(), then
// release().
template <int SLOTS>
struct SlabRing {
  float* slots;
  uint64_t* full;
  uint64_t* empty;
  int j;  // the next slab this warp reads

  __device__ const float* wait() {
    mbar_wait(&full[j % SLOTS], (j / SLOTS) & 1);
    return slots + (j % SLOTS) * kSlabFloats;
  }

  // this warp is done with slab j
  __device__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[j % SLOTS]);
    ++j;
  }

  // the issuing thread: slab s's slot, once every warp has released the
  // slab before it there
  __device__ float* refill_wait(int s) const {
    if (s >= SLOTS) mbar_wait(&empty[s % SLOTS], (s / SLOTS - 1) & 1);
    return slots + (s % SLOTS) * kSlabFloats;
  }
};

// ------------------------------------------------------------ the FMA loop

// A row of A in shared memory, given by its float offset in the block's
// dynamic shared memory: a 32-bit address where a pointer takes two
// registers.
struct SmemRow {
  int off;
};

// 4 floats of a row of A from column k (16-byte aligned)
__device__ __forceinline__ float4 load_a4(const float* row, int k) {
  return *reinterpret_cast<const float4*>(row + k);
}
__device__ __forceinline__ float4 load_a4(SmemRow row, int k) {
  extern __shared__ __align__(128) float dynamic_smem[];
  return *reinterpret_cast<const float4*>(dynamic_smem + row.off + k);
}

// acc[i][c] += A[row i, k0 + k] * W[k, col c] over `rows` k, k ascending:
// a TM x 8 register tile, its 8 columns in two float4 groups N / 2 apart.
// arow: the tile's rows (pointers or SmemRow); w points at the thread's
// first column in row k0 of W (row stride N floats, in shared memory);
// rows % 4 == 0.
template <int TM, int N, class Row>
__device__ __forceinline__ void slab_fma(const Row (&arow)[TM], int k0,
                                         const float* __restrict__ w, int rows,
                                         float (&acc)[TM][8]) {
#pragma unroll 2
  for (int k = 0; k < rows; k += 4) {
    float4 a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = load_a4(arow[i], k0 + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 lo = *reinterpret_cast<const float4*>(w + (k + kk) * N);
      const float4 hi = *reinterpret_cast<const float4*>(w + (k + kk) * N + N / 2);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
        acc[i][0] = fmaf(av, lo.x, acc[i][0]);
        acc[i][1] = fmaf(av, lo.y, acc[i][1]);
        acc[i][2] = fmaf(av, lo.z, acc[i][2]);
        acc[i][3] = fmaf(av, lo.w, acc[i][3]);
        acc[i][4] = fmaf(av, hi.x, acc[i][4]);
        acc[i][5] = fmaf(av, hi.y, acc[i][5]);
        acc[i][6] = fmaf(av, hi.z, acc[i][6]);
        acc[i][7] = fmaf(av, hi.w, acc[i][7]);
      }
    }
  }
}

__device__ __forceinline__ float relu(float y) { return y < 0.f ? 0.f : y; }

}  // namespace sm90
