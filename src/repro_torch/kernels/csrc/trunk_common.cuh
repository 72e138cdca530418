// Shared device code of the C3 trunk kernels (fused_step.cu, cnn_trunk.cu):
// a persistent grid over sub-lane tiles, with the weights streamed through
// shared memory by TMA bulk copies.
//
// The trunk is three k2s2 convolutions + bias + ReLU. Each of a lane's S/8
// outputs depends on exactly 8 consecutive input rows, so the work unit is
// (lane, output position p): u = lane * S/8 + p, whose input is rows
// 8p..8p+7 (8 x C0 floats) and whose output is row u of the (L, S/8, C3)
// output. For U units side by side each layer is one GEMM,
//   out[m, n] = relu(b[n] + sum_k A[m, k] * W[k, n]),
// with M = 4U, 2U, U rows and K = 2 C0, 2 C1, 2 C2: row m of a layer's A is
// rows 2m and 2m+1 of the layer below side by side, so the k2s2 pairing is
// an index map that each epilogue applies when it writes the next A.
//
// What bounds the GEMMs: the shared-memory pipe (sm90.cuh): the register
// tile has to be large, and the rows a block holds per pass (M = NRS x TM)
// with it.
//
// Plan of one block (8 compute warps + an issuing warpgroup, one block per
// SM, persistent): the block takes a contiguous range of units (the ranges
// of the G blocks differ by at most one unit) and walks it in tiles of at
// most kUnits = 72 units, split evenly (at the main path's 1024 lanes: one
// tile of 69 or 70 per SM):
//
//   - the tile's input (U x 8 x C0 floats) is copied or assembled into X;
//   - layer 1 reads X and writes h1 (2U rows of 2 C1 + pad floats);
//   - layer 2 reads h1 and writes h2 into X, which it has finished;
//   - layer 3 reads h2 and writes the tile's outputs to device memory;
//   - the weights stream through a ring of kSlots slabs of kSlabFloats
//     (16 KB): whole rows of W (K x N row-major, as the wrapper passes it),
//     64 rows of w1, 32 of w2 or w3 per slab, 14 slabs per tile at the C3
//     widths. The first thread of a warpgroup of its own (which hands its
//     registers to the compute warps) issues each slab as a bulk copy
//     (cp.async.bulk) that completes on the slot's "full" mbarrier; every
//     compute warp reads it from shared memory, then arrives on the slot's
//     "empty" mbarrier, and the slab kSlots ahead goes in once all 8 have:
//     no block-wide barrier stops the FMAs after each slab. The stream runs
//     on across layers and tiles, so the first slabs land while the tile's
//     input is loaded.
//
// Shared memory at the C3 widths (C0 50, C1 64, C2 128, C3 128), U = 72:
//   X    72 x 8 x 50 floats                115,200 B   (h2: 72 x 260 floats
//                                                        = 74,880 B, in X)
//   h1   144 rows x (128 + 4) floats        76,032 B
//   ring 2 x 16 KB                          32,768 B
//   mbarriers                                   64 B
//   total                                  224,064 B (K2); K1 adds an 8 KB
// side area (232,256 B) of the 232,448 a block may take: one block per SM,
// 8 compute warps with up to 232 registers a thread. There is no room for
// a second X buffer at this tile size; a smaller tile with one (36 units,
// 4 warps) measured slower, since its register tiles are half as large.
//
// Register tiles: TN = 8 columns (two float4 groups, at 4 cg and N/2 + 4 cg)
// by TM rows (rows rs, rs + NRS, ...) per thread. A warp covers 8 column
// groups x 4 row slots; NRS = 32 row slots at N = 64, 16 at N = 128. At
// U = 70: TM = 9, 9, 5 in the three layers (4/TM + 4/TN = 0.94, 0.94,
// 1.3). TM = ceil(M / NRS) is chosen per tile.
//
// Numerics: as sm90.cuh says (each output's sum in one thread, k
// ascending with fmaf, then the bias, then ReLU), so both kernels give the
// same bits for the same input.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "sm90.cuh"

namespace trunk {

using namespace sm90;

// and a warpgroup whose first thread issues the weight slabs
constexpr int kBlockThreads = kThreads + 128;
// registers a thread after the start: the issuing warpgroup hands its
// share to the compute warps (65,536 a block at most)
constexpr int kIssueRegs = 40, kComputeRegs = 232;
static_assert(128 * kIssueRegs + kThreads * kComputeRegs <= 65536, "register file");
constexpr int kUnits = 72;         // units per tile, at most
constexpr int kSlots = 2;          // slabs in the ring
constexpr int kBarBytes = 64;      // 2 kSlots + 1 mbarriers, rounded up

// the widths the kernels are built for: the C3 model's
constexpr int C1 = 64, C2 = 128, C3 = 128;

// A row stride (floats) whose 16-byte count is odd, so that 4 consecutive
// rows start in 4 different bank groups.
__host__ __device__ constexpr int padded_ld(int n) { return (n / 4) % 2 ? n : n + 4; }
constexpr int kLd1 = padded_ld(2 * C1);  // h1 as layer 2's A
constexpr int kLd2 = padded_ld(2 * C2);  // h2 as layer 3's A

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Shared-memory layout of a block, in bytes from the start.
// `side` bytes at the end are the input's own (K1's per-lane scratch).
struct Plan {
  int umax;      // units per tile, at most
  int ring_off, x_off, h1_off, side_off;
  int bytes;

  __host__ __device__ Plan(int umax_, int c0, int side = 0) : umax(umax_) {
    const int x = umax * 8 * c0, h2 = umax * kLd2;
    ring_off = kBarBytes;
    x_off = ring_off + 4 * kSlots * kSlabFloats;
    h1_off = x_off + 4 * round4(x > h2 ? x : h2);
    side_off = h1_off + 4 * 2 * umax * kLd1;
    bytes = side_off + side;
  }
};

// ------------------------------------------------------------ roles

template <int N>
__device__ __forceinline__ void set_max_registers_lower() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void set_max_registers_raise() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// A barrier of the compute threads only (the issuing warpgroup is not in it).
__device__ __forceinline__ void sync_compute() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

// ------------------------------------------------------------ weight ring

struct Weights {
  const float* w[3];
  const float* b[3];
};

// The slab stream of one block: per tile, layer 1's slabs (64 rows of w1,
// the last one short where 2 c0 is not a multiple of 64), then layer 2's
// and layer 3's (32 rows each).
struct Ring : SlabRing<kSlots> {
  static constexpr int kRows1 = kSlabFloats / C1, kRows2 = kSlabFloats / C2,
                       kRows3 = kSlabFloats / C3;
  static constexpr int kCount2 = 2 * C1 / kRows2, kCount3 = 2 * C2 / kRows3;
  static_assert(2 * C1 % kRows2 == 0 && 2 * C2 % kRows3 == 0, "whole slabs in layers 2, 3");

  Weights wt;
  int k1, count1;             // layer 1's depth (2 c0) and slabs
  int per_tile, total;        // slabs a tile, in all

  __device__ Ring(float* slots_, uint64_t* full_, uint64_t* empty_, const Weights& wt_, int c0,
                  int tiles)
      : SlabRing<kSlots>{slots_, full_, empty_, 0},
        wt(wt_),
        k1(2 * c0),
        count1((2 * c0 + kRows1 - 1) / kRows1),
        per_tile(count1 + kCount2 + kCount3),
        total(tiles * per_tile) {}

  // one thread: copy slab s of the stream into its slot
  __device__ void issue(int s) {
    int q = s % per_tile;
    const float* src;
    int floats;
    if (q < count1) {
      src = wt.w[0] + q * kRows1 * C1;
      floats = min(kRows1, k1 - q * kRows1) * C1;
    } else if ((q -= count1) < kCount2) {
      src = wt.w[1] + q * kSlabFloats;
      floats = kSlabFloats;
    } else {
      src = wt.w[2] + (q - kCount2) * kSlabFloats;
      floats = kSlabFloats;
    }
    bulk_load(slots + (s % kSlots) * kSlabFloats, src, (unsigned)(floats * sizeof(float)),
              &full[s % kSlots]);
  }

  // the issuing thread: every slab in turn, each once its slot is free
  __device__ void produce() {
    for (int s = 0; s < total; ++s) {
      refill_wait(s);
      issue(s);
    }
  }
};

// ------------------------------------------------------------ one layer

// One layer over M rows of A (row stride lda floats, in shared memory),
// K = the layer's depth, weights from the ring. store(row, col, float4)
// takes 4 outputs of columns col..col+3 of a row < M.
// Row slots of a layer of width N: a warp covers 8 column groups x 4 row
// slots, N / 64 warps side by side across N.
template <int N>
__host__ __device__ constexpr int row_slots() {
  static_assert(N % 64 == 0 && kWarps % (N / 64) == 0, "warps tile N in groups of 64 columns");
  return kWarps / (N / 64) * 4;
}

template <int TM, int N, class Store>
__device__ __forceinline__ void layer_tm(const float* A, int lda, int M, int K, Ring& ring,
                                         const float* __restrict__ bias, Store store) {
  constexpr int WPB = N / 64;  // warps side by side across N
  constexpr int NRS = row_slots<N>();
  constexpr int ROWS = kSlabFloats / N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cg = (warp % WPB) * 8 + (lane & 7);
  const int rs = (warp / WPB) * 4 + (lane >> 3);
  const float* arow[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) arow[i] = A + min(rs + NRS * i, M - 1) * lda;
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += ROWS) {
    const float* w = ring.wait() + cg * 4;
    slab_fma<TM, N>(arow, k0, w, min(ROWS, K - k0), acc);
    ring.release();
  }

  const float4 blo = __ldg(reinterpret_cast<const float4*>(bias + cg * 4));
  const float4 bhi = __ldg(reinterpret_cast<const float4*>(bias + N / 2 + cg * 4));
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = rs + NRS * i;
    if (r < M) {
      store(r, cg * 4,
            make_float4(relu(acc[i][0] + blo.x), relu(acc[i][1] + blo.y),
                        relu(acc[i][2] + blo.z), relu(acc[i][3] + blo.w)));
      store(r, N / 2 + cg * 4,
            make_float4(relu(acc[i][4] + bhi.x), relu(acc[i][5] + bhi.y),
                        relu(acc[i][6] + bhi.z), relu(acc[i][7] + bhi.w)));
    }
  }
}

// TM = ceil(M / NRS) rows per thread, dispatched over 1..MAXTM (the TM of
// the largest tile).
template <int N, int MAXTM, int TM = 1, class Store>
__device__ __forceinline__ void layer(const float* A, int lda, int M, int K, Ring& ring,
                                      const float* __restrict__ bias, Store store) {
  if constexpr (TM < MAXTM) {
    if (M > TM * row_slots<N>()) {
      layer<N, MAXTM, TM + 1>(A, lda, M, K, ring, bias, store);
      return;
    }
  }
  layer_tm<TM, N>(A, lda, M, K, ring, bias, store);
}

// TM of the largest tile in a layer of M = rows_per_unit x kUnits rows
template <int N>
__host__ __device__ constexpr int max_tm(int rows_per_unit) {
  return (rows_per_unit * kUnits + row_slots<N>() - 1) / row_slots<N>();
}

// ------------------------------------------------------------ the tile loop

// Input puts a tile's input into X (layer 1's A, (4n, 2 c0)):
// load(t, u0, n, x, h1, bar) is called by every compute thread and returns
// when every one may read tile t (units u0..u0+n-1). It may use h1's space
// (and what follows it) as scratch and the mbarrier `bar` for its copies.
template <class Input>
__device__ __forceinline__ void run_tiles(Input& in, unsigned char* smem, const Plan& plan,
                                          int c0, const Weights& wt, float* __restrict__ out,
                                          long long units) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // ring full, ring empty, X
  float* x = reinterpret_cast<float*>(smem + plan.x_off);
  float* h1 = reinterpret_cast<float*>(smem + plan.h1_off);

  // the block's units, in `tiles` tiles whose sizes differ by at most one
  const long long u_begin = units * blockIdx.x / gridDim.x;
  const int n_block = (int)(units * (blockIdx.x + 1) / gridDim.x - u_begin);
  const int tiles = (n_block + plan.umax - 1) / plan.umax;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * kSlots + 1; ++i) mbar_init(&bars[i], i / kSlots == 1 ? kWarps : 1);
    fence_mbar_init();
  }
  __syncthreads();
  Ring ring(reinterpret_cast<float*>(smem + plan.ring_off), bars, bars + kSlots, wt, c0, tiles);
  if (threadIdx.x >= kThreads) {  // the issuing warpgroup
    set_max_registers_lower<kIssueRegs>();
    if (threadIdx.x == kThreads) ring.produce();
    return;
  }
  set_max_registers_raise<kComputeRegs>();

  for (int t = 0; t < tiles; ++t) {
    const long long u0 = u_begin + (long long)n_block * t / tiles;
    const int n = (int)(u_begin + (long long)n_block * (t + 1) / tiles - u0);
    if (t > 0) sync_compute();  // X (h2) of the tile before is spent
    in.load(t, u0, n, x, h1, &bars[2 * kSlots]);
    layer<C1, max_tm<C1>(4)>(x, 2 * c0, 4 * n, 2 * c0, ring, wt.b[0], [&](int r, int c, float4 y) {
      *reinterpret_cast<float4*>(h1 + (r >> 1) * kLd1 + (r & 1) * C1 + c) = y;
    });
    sync_compute();
    float* h2 = x;  // the tile's input is spent
    layer<C2, max_tm<C2>(2)>(h1, kLd1, 2 * n, 2 * C1, ring, wt.b[1], [&](int r, int c, float4 y) {
      *reinterpret_cast<float4*>(h2 + (r >> 1) * kLd2 + (r & 1) * C2 + c) = y;
    });
    sync_compute();
    float* o = out + u0 * C3;
    layer<C3, max_tm<C3>(1)>(h2, kLd2, n, 2 * C2, ring, wt.b[2], [&](int r, int c, float4 y) {
      *reinterpret_cast<float4*>(o + (size_t)r * C3 + c) = y;
    });
  }
}

// ------------------------------------------------------------ host side

// Per device, queried once: the SM count and the shared memory a block may
// opt into; and the most dynamic shared memory the kernel was allowed.
struct DeviceCache {
  int sms = 0, max_smem = 0, smem_set = 0;
};

// The largest tile (72, 64, ..., 8 units) whose plan fits; 0 if none does.
inline int tile_units(int c0, int side, int max_smem) {
  for (int u = kUnits; u >= 8; u -= 8) {
    if (Plan(u, c0, side).bytes <= max_smem) return u;
  }
  return 0;
}

// The current device's SM count and the tile size for input width c0, and
// the kernel's dynamic shared-memory limit raised to the plan's if it is
// below. After the first launch of a shape this makes no device query and
// sets nothing.
template <class Kernel>
cudaError_t prepare(Kernel kernel, DeviceCache (&cache)[kMaxDevices], int c0, int side,
                    int* sms, int* umax) {
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  DeviceCache& c = cache[dev];
  if (c.sms == 0) {
    int max_smem = 0, n_sm = 0;
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return err;
    c.max_smem = max_smem;
    c.sms = n_sm;
  }
  *sms = c.sms;
  *umax = tile_units(c0, side, c.max_smem);
  if (*umax == 0) return cudaErrorInvalidValue;
  const int bytes = Plan(*umax, c0, side).bytes;
  if (bytes > c.smem_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    c.smem_set = bytes;
  }
  return cudaSuccess;
}

}  // namespace trunk
