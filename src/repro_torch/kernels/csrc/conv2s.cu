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
// and written once (~7 us at 3.35 TB/s): operations and bytes about even,
// so the input stream has to overlap the FMAs. At the two other C3 layers
// ((1024, 36, 64) -> 128, (1024, 18, 128) -> 128) the FMAs bound it.
//
// What the design does about it: x2 is one row-major (M, K) matrix,
// M = B N / 2, K = 2C, with no lane structure, and the layer is the row
// GEMM out = relu(x2 W + b). One persistent block per SM of 8 warps (no
// issuing warpgroup: with one, ptxas holds every thread to 168 registers,
// and the 9 x 8 tiles spilled) takes a contiguous range of rows, the
// ranges of the blocks differing by at most one row, and cuts it into
// tiles of at most 36 rows, split evenly:
//
//   - The warps form groups of NP / 64 side by side across the output
//     columns (padded to NP = 64, 128 or 256): 8, 4 or 2 groups. Group g
//     takes tiles g, g + groups, ... on its own, so it starts as soon as
//     its own tile has landed, and no block-wide barrier stops the FMAs.
//     At the first C3 layer's shape each of the 8 warps of an SM has one
//     tile of ~35 rows.
//   - A tile of R rows is R K contiguous floats (K = 2C with C even: every
//     row is 16-byte aligned), so one bulk copy (cp.async.bulk) brings it
//     into a slot of its group in shared memory, completing on the slot's
//     "full" mbarrier. The group's first lane issues its copies: its first
//     tiles (1 or 2, as many slots as it has) at the start, then each next
//     one into the slot its group has just finished (the slot's "empty"
//     mbarrier, one arrival a warp), before the stores of the tile before.
//   - W and the bias stay in shared memory for the whole launch where they
//     fit beside a slot a group of the rows it needs: W by bulk copies of
//     16 KB slabs, each on an mbarrier of its own, so the first FMAs wait
//     for the first slab only (by the threads, zero-padded, where Co % 4
//     != 0). A wider W streams slab by slab through a ring of two, every
//     round of tiles; thread 0 refills it once all 8 warps are done with a
//     slab.
//   - Register tiles: a thread keeps TM rows (rows rs, rs + 4, ... of the
//     tile, rs = lane / 8) by 8 columns (two float4 groups, at 4 cg and
//     NP/2 + 4 cg), TM = ceil(R / 4) <= 9 chosen per tile: 9 x 8 at the
//     first two C3 layers (4/TM + 4/TN = 0.94), 5 x 8 at the third, whose
//     ~70 rows an SM give no more. Rows past the tile repeat its last row
//     and are not stored.
//
// Shared memory: 512 B of mbarriers, W (K NP floats, or the 32 KB ring),
// the bias (NP), then 1 or 2 slots a group. At the three C3 layers W stays,
// taking 25,600, 65,536 and 131,072 B, and a block 138,368, 138,240 and
// 205,824 B in all. Any B and N; Co <= 256, and W or its ring beside a
// slot of one row a group (ops.conv2s raises ValueError past that).
//
// Numerics (sm90.cuh): each output's sum in one thread, from 0, k ascending
// with fmaf, then the bias, then ReLU. So three launches over the C3 layers
// give the bits of the fused trunk kernels (cnn_trunk.cu).

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kRowSlots = 4;                      // rows a warp holds side by side (lane / 8)
constexpr int kMaxTM = 9;                         // register-tile rows, at most
constexpr int kMaxTileRows = kRowSlots * kMaxTM;  // 36
constexpr int kMaxGroupSlots = 2;                 // tiles a group has in flight, at most
constexpr int kMaxSlots = kWarps * kMaxGroupSlots;
constexpr int kBarBytes = 512;                    // mbarriers: full, empty a slot; one a W slab
constexpr int kMaxSlabs = kBarBytes / 8 - 2 * kMaxSlots;

// How W comes into shared memory: resident for the whole launch, loaded by
// the threads (Co % 4 != 0) or by bulk copies of its slabs; or streamed,
// slab by slab, through a ring of two (W too large to stay).
enum WMode { kWPlain = 0, kWBulk = 1, kWRing = 2 };
constexpr int kRingSlots = 2;

struct Params {
  const float* x;     // (M, K) row-major
  const float* w;     // (K, Co) row-major
  const float* b;     // (Co,)
  float* out;         // (M, Co)
  long long rows_q;   // M / blocks: rows a block (the first M % blocks have one more)
  int rows_r;         // M % blocks
  int K, Co;
  int tiles;          // tiles a block, at most
  int group_slots;    // ring slots of a group
  int slot_floats;    // floats a slot (the largest tile)
  int w_mode;         // WMode
};

template <int NP>
struct Shape {
  static constexpr int kWPB = NP / 64;            // warps side by side across NP
  static constexpr int kGroups = kWarps / kWPB;   // groups of warps, one tile each at a time
  static constexpr int kSlabRows = kSlabFloats / NP;
};

// Floats of shared memory that W takes: all of it (K x NP), or the ring.
__host__ __device__ constexpr int w_floats(int w_mode, int K, int np) {
  return w_mode == kWRing ? kRingSlots * kSlabFloats : K * np;
}

struct Smem {
  uint64_t* full;   // a slot: its tile has landed
  uint64_t* empty;  // a slot: its group's warps are done reading it (kWPB arrivals)
  uint64_t* wbar;   // resident W: a slab has landed; ring: the ring's full, then empty
  float* w;         // resident W (K x NP), or the ring's slabs
  float* bias;      // NP
  int slots_off;    // floats from the start to the tiles' slots
  float* slots;

  __device__ Smem(unsigned char* smem, int wf, int np) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
    full = bars;
    empty = bars + kMaxSlots;
    wbar = bars + 2 * kMaxSlots;
    w = reinterpret_cast<float*>(smem + kBarBytes);
    bias = w + wf;
    slots_off = kBarBytes / 4 + wf + np;
    slots = reinterpret_cast<float*>(smem) + slots_off;
  }
};

// The block's rows: [r0, r0 + n), in `tiles` tiles whose sizes differ by at
// most one (the first n % tiles have one row more); tile t is rows
// [r0 + first(t), r0 + first(t + 1)) and goes to group t % groups, in
// rounds of one tile a group.
struct Rows {
  long long r0;
  int n, tiles, q, r;
  __device__ Rows(const Params& p) {
    const int b = blockIdx.x;
    r0 = p.rows_q * b + min(b, p.rows_r);
    n = (int)p.rows_q + (b < p.rows_r);
    tiles = min(p.tiles, n);
    q = tiles ? n / tiles : 0;
    r = tiles ? n % tiles : 0;
  }
  __device__ int first(int t) const { return q * t + min(t, r); }
  __device__ int rounds(int groups) const { return (tiles + groups - 1) / groups; }
};

// Slab j of W (rows j * kSlabRows on, whole rows) into `dst`, rows of NP
// floats, completing on `bar`: one bulk copy where Co == NP, else one a
// row (Co % 4 == 0: 16-byte rows; the pad columns are never stored).
template <int NP>
__device__ __forceinline__ void copy_w_slab(const Params& p, float* dst, int j, uint64_t* bar) {
  const int k0 = j * Shape<NP>::kSlabRows;
  const int n_rows = min(Shape<NP>::kSlabRows, p.K - k0);
  if (p.Co == NP) {
    bulk_load(dst, p.w + k0 * NP, (unsigned)(n_rows * NP * 4), bar);
  } else {
    fence_async_shared();
    mbar_expect_tx(bar, (unsigned)(n_rows * p.Co * 4));
    for (int r = 0; r < n_rows; ++r) {
      bulk_copy(dst + r * NP, p.w + (size_t)(k0 + r) * p.Co, (unsigned)(p.Co * 4), bar);
    }
  }
}

// 4 outputs of columns c..c+3 of one row (c % 4 == 0, Co even), masked at Co.
__device__ __forceinline__ void store4(float* o, int c, int Co, float4 v) {
  if (c >= Co) return;
  if (Co % 4 == 0) {
    *reinterpret_cast<float4*>(o + c) = v;
  } else {
    *reinterpret_cast<float2*>(o + c) = make_float2(v.x, v.y);
    if (c + 2 < Co) *reinterpret_cast<float2*>(o + c + 2) = make_float2(v.z, v.w);
  }
}

// One tile of n_rows rows (A: n_rows x K, `a_off` floats into dynamic
// shared memory), TM register rows a thread: the FMAs over W slab by slab
// (resident, or from the ring, whose next slabs refill() issues), then
// done() (the tile's slot is free), then the stores.
template <int NP, int TM, class Refill, class Done>
__device__ __forceinline__ void tile_tm(const Params& p, const Smem& sm,
                                        SlabRing<kRingSlots>& ring, Refill& refill, int a_off,
                                        int n_rows, Done& done, float* out) {
  using S = Shape<NP>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cg = (warp % S::kWPB) * 8 + (lane & 7);
  const int rs = lane >> 3;
  const int K = p.K;
  SmemRow arow[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) arow[i] = SmemRow{a_off + min(rs + kRowSlots * i, n_rows - 1) * K};
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int k0 = 0, j = 0; k0 < K; k0 += S::kSlabRows, ++j) {
    const float* w;
    if (p.w_mode == kWRing) {
      w = ring.wait();
    } else {
      if (p.w_mode == kWBulk) mbar_wait(&sm.wbar[j], 0);
      w = sm.w + k0 * NP;
    }
    slab_fma<TM, NP>(arow, k0, w + cg * 4, min(S::kSlabRows, K - k0), acc);
    if (p.w_mode == kWRing) {
      ring.release();
      refill(ring.j - 1 + kRingSlots);
    }
  }
  done();

  const float4 blo = *reinterpret_cast<const float4*>(sm.bias + cg * 4);
  const float4 bhi = *reinterpret_cast<const float4*>(sm.bias + NP / 2 + cg * 4);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = rs + kRowSlots * i;
    if (r < n_rows) {
      float* o = out + (size_t)r * p.Co;
      store4(o, cg * 4, p.Co,
             make_float4(relu(acc[i][0] + blo.x), relu(acc[i][1] + blo.y),
                         relu(acc[i][2] + blo.z), relu(acc[i][3] + blo.w)));
      store4(o, NP / 2 + cg * 4, p.Co,
             make_float4(relu(acc[i][4] + bhi.x), relu(acc[i][5] + bhi.y),
                         relu(acc[i][6] + bhi.z), relu(acc[i][7] + bhi.w)));
    }
  }
}

// TM = ceil(n_rows / 4), dispatched over 1..kMaxTM.
template <int NP, int TM = 1, class Refill, class Done>
__device__ __forceinline__ void tile(const Params& p, const Smem& sm, SlabRing<kRingSlots>& ring,
                                     Refill& refill, int a_off, int n_rows, Done& done,
                                     float* out) {
  if constexpr (TM < kMaxTM) {
    if (n_rows > TM * kRowSlots) {
      tile<NP, TM + 1>(p, sm, ring, refill, a_off, n_rows, done, out);
      return;
    }
  }
  tile_tm<NP, TM>(p, sm, ring, refill, a_off, n_rows, done, out);
}

// The block is the 8 compute warps alone, so that each thread may take
// 255 registers (an issuing warpgroup would hold every thread to 168).
// The first lane of each group issues its own tiles' copies: its first
// tiles at the start, and each later one into the slot of the tile
// group_slots before it, once the group's warps are done with that.
// Thread 0 issues W: all its slabs at the start (resident), or the ring's
// first slabs, then each slab once every warp has released the one two
// before it.
template <int NP>
__global__ void __launch_bounds__(kThreads, 1) conv2s_kernel(const Params p) {
  using S = Shape<NP>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm(smem, w_floats(p.w_mode, p.K, NP), NP);
  const Rows rows(p);
  if (rows.tiles == 0) return;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / S::kWPB;
  const bool leader = lane == 0 && warp % S::kWPB == 0;
  const int gs = p.group_slots;
  const int n_slabs = (p.K + S::kSlabRows - 1) / S::kSlabRows;
  const int rounds = rows.rounds(S::kGroups);
  SlabRing<kRingSlots> ring{sm.w, sm.wbar, sm.wbar + kRingSlots, 0};

  if (threadIdx.x == 0) {
    for (int i = 0; i < kMaxSlots; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], S::kWPB);
    }
    // resident W: one a slab; streamed: the ring's full, then its empty
    for (int i = 0; i < kMaxSlabs; ++i) {
      const bool ring_empty = p.w_mode == kWRing && i >= kRingSlots && i < 2 * kRingSlots;
      mbar_init(&sm.wbar[i], ring_empty ? kWarps : 1);
    }
    fence_mbar_init();
  }
  __syncthreads();

  auto issue_tile = [&](int t, int slot) {
    const long long a = rows.r0 + rows.first(t);
    const int n_rows = rows.first(t + 1) - rows.first(t);
    bulk_load(sm.slots + slot * p.slot_floats, p.x + a * p.K, (unsigned)(n_rows * p.K * 4),
              &sm.full[slot]);
  };
  if (threadIdx.x == 0 && p.w_mode == kWBulk) {
    for (int j = 0; j < n_slabs; ++j) {
      copy_w_slab<NP>(p, sm.w + j * S::kSlabRows * NP, j, &sm.wbar[j]);
    }
  }
  if (threadIdx.x == 0 && p.w_mode == kWRing) {
    for (int s = 0; s < kRingSlots && s < rounds * n_slabs; ++s) {
      copy_w_slab<NP>(p, ring.refill_wait(s), s % n_slabs, &ring.full[s]);
    }
  }
  if (leader) {
    for (int k = 0; k < gs && group + k * S::kGroups < rows.tiles; ++k) {
      issue_tile(group + k * S::kGroups, group * gs + k);
    }
  }
  for (int c = threadIdx.x; c < NP; c += kThreads) sm.bias[c] = c < p.Co ? p.b[c] : 0.f;
  if (p.w_mode == kWPlain) {
    for (int e = threadIdx.x; e < p.K * NP; e += kThreads) {
      const int k = e / NP, c = e % NP;
      sm.w[e] = c < p.Co ? p.w[(size_t)k * p.Co + c] : 0.f;
    }
  }
  __syncthreads();

  // thread 0, streamed W: slab s of the stream (a round is every slab once)
  auto refill = [&](int s) {
    if (threadIdx.x == 0 && s < rounds * n_slabs) {
      copy_w_slab<NP>(p, ring.refill_wait(s), s % n_slabs, &ring.full[s % kRingSlots]);
    }
  };
  // In rounds of one tile a group: with W streamed, every warp walks every
  // slab of a round, with a tile or without.
  for (int round = 0, k = 0; round < rounds; ++round) {
    const int t = round * S::kGroups + group;
    if (t < rows.tiles) {
      const int slot = group * gs + k % gs;
      const unsigned use = k / gs;
      mbar_wait(&sm.full[slot], use & 1);
      auto done = [&] {
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.empty[slot]);
        const int next = t + gs * S::kGroups;
        if (leader && next < rows.tiles) {
          mbar_wait(&sm.empty[slot], use & 1);
          issue_tile(next, slot);
        }
      };
      const long long a = rows.r0 + rows.first(t);
      tile<NP>(p, sm, ring, refill, sm.slots_off + slot * p.slot_floats,
               rows.first(t + 1) - rows.first(t), done, p.out + a * p.Co);
      ++k;
    } else if (p.w_mode == kWRing) {
      for (int j = 0; j < n_slabs; ++j) {
        ring.wait();
        ring.release();
        refill(ring.j - 1 + kRingSlots);
      }
    }
  }
}

// ------------------------------------------------------------ host side

// The launch's plan: output columns padded to np; `blocks` persistent
// blocks of `tiles` tiles of at most `tile_rows` rows; `group_slots` slots
// a group; `smem` bytes of dynamic shared memory a block; how W comes
// (WMode).
struct Plan {
  int np, blocks, tiles, group_slots, tile_rows, smem, w_mode;
};

long long fixed_bytes(int K, int np, int w_mode) {
  return kBarBytes + 4LL * (w_floats(w_mode, K, np) + np);
}

// The plan for one way of holding W, or false if it does not fit: tiles of
// at most kMaxTileRows rows, small enough for a slot a group beside W, the
// bias and the mbarriers; two slots a group where they fit and the group
// has two tiles or more.
bool plan_mode(long long n, int K, int np, int blocks, int max_smem, int w_mode, Plan* pl) {
  const int groups = kWarps / (np / 64);
  const long long row_bytes = 4LL * K;
  const long long fixed = fixed_bytes(K, np, w_mode);
  const long long room = max_smem - fixed;
  long long cap = room / (groups * row_bytes);
  if (cap < 1) return false;
  if (cap > kMaxTileRows) cap = kMaxTileRows;
  long long tiles = groups * ((n + groups * cap - 1) / (groups * cap));
  if (tiles > n) tiles = n;
  const long long tile_rows = (n + tiles - 1) / tiles;
  long long gs = room / (groups * tile_rows * row_bytes);
  const long long per_group = (tiles + groups - 1) / groups;
  if (gs > per_group) gs = per_group;
  if (gs > kMaxGroupSlots) gs = kMaxGroupSlots;
  *pl = Plan{np, blocks, (int)tiles, (int)gs, (int)tile_rows,
             (int)(fixed + groups * gs * tile_rows * row_bytes), w_mode};
  return true;
}

// false if the layer is past the design: Co > 256, or neither W resident
// (K x NP) nor, where Co % 4 == 0, its ring fits with a slot of one input
// row a group. W stays resident if every group can hold a tile of all the
// rows it needs beside it, or if the ring does not fit.
bool make_plan(long long M, int K, int Co, int sms, int max_smem, Plan* pl) {
  const int np = Co <= 64 ? 64 : Co <= 128 ? 128 : Co <= 256 ? 256 : 0;
  if (np == 0 || M <= 0 || sms <= 0) return false;
  const int groups = kWarps / (np / 64);
  const int blocks = (int)(M < sms ? M : sms);
  const long long n = (M + blocks - 1) / blocks;  // rows of the largest block
  const int n_slabs = (K + kSlabFloats / np - 1) / (kSlabFloats / np);
  const int w_resident = Co % 4 == 0 ? kWBulk : kWPlain;
  Plan resident, ring;
  const bool resident_ok = n_slabs <= kMaxSlabs &&
                           plan_mode(n, K, np, blocks, max_smem, w_resident, &resident);
  const bool ring_ok = Co % 4 == 0 && plan_mode(n, K, np, blocks, max_smem, kWRing, &ring);
  long long want = (n + groups - 1) / groups;  // rows a group needs, all at once
  if (want > kMaxTileRows) want = kMaxTileRows;
  const bool roomy = max_smem - fixed_bytes(K, np, w_resident) >= groups * 4LL * K * want;
  if (resident_ok && (roomy || !ring_ok)) {
    *pl = resident;
  } else if (ring_ok) {
    *pl = ring;
  } else {
    return false;
  }
  return true;
}

// Per device, set at its first launch: the SM count and the shared memory a
// block may opt into, which every instantiation of the kernel is allowed.
struct Device {
  int sms = 0, max_smem = 0;
};
Device g_devices[kMaxDevices];
std::mutex g_mu;

cudaError_t device_limits(int dev, Device* out) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_mu);
  Device& d = g_devices[dev];
  if (d.sms == 0) {
    int sms = 0, max_smem = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    for (auto kernel : {conv2s_kernel<64>, conv2s_kernel<128>, conv2s_kernel<256>}) {
      if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
      }
    }
    if (err != cudaSuccess) return err;
    d.max_smem = max_smem;
    d.sms = sms;
  }
  *out = d;
  return cudaSuccess;
}

bool plan_for(int B, int N, int C, int Co, int sms, int max_smem, Plan* pl) {
  if (B <= 0 || N <= 0 || N % 2 != 0 || C <= 0 || C % 2 != 0 || Co <= 0 || Co % 2 != 0) {
    return false;
  }
  return make_plan((long long)B * (N / 2), 2 * C, Co, sms, max_smem, pl);
}

}  // namespace

// x (B, N, C), w (2C, Co), b (Co,), out (B, N/2, Co): f32, contiguous, x and
// w 16-byte aligned. Needs N, C and Co even; Co <= 256; and W, padded to NP
// columns, or (Co % 4 == 0) a ring of two 16 KB slabs of it, plus one input
// row in the shared memory a block may take. `device` is the CUDA device
// the pointers live on and the current one: after its first launch there,
// a launch queries and sets nothing.
extern "C" int conv2s_launch(const void* x, const void* w, const void* b, void* out, int B, int N,
                             int C, int Co, int device, void* stream) {
  Device d;
  cudaError_t err = device_limits(device, &d);
  if (err != cudaSuccess) return (int)err;
  Plan pl;
  if (!plan_for(B, N, C, Co, d.sms, d.max_smem, &pl)) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * (N / 2);
  const Params p{static_cast<const float*>(x), static_cast<const float*>(w),
                 static_cast<const float*>(b), static_cast<float*>(out), M / pl.blocks,
                 (int)(M % pl.blocks), 2 * C, Co, pl.tiles, pl.group_slots, pl.tile_rows * 2 * C,
                 pl.w_mode};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pl.np == 64) {
    conv2s_kernel<64><<<pl.blocks, kThreads, pl.smem, st>>>(p);
  } else if (pl.np == 128) {
    conv2s_kernel<128><<<pl.blocks, kThreads, pl.smem, st>>>(p);
  } else {
    conv2s_kernel<256><<<pl.blocks, kThreads, pl.smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

// The plan of a launch on a card with `sms` SMs and `max_smem` bytes of
// shared memory a block, for the build log: out = {NP, blocks, tiles a
// block, slots a group, rows a tile, dynamic shared memory a block, how W
// comes: 0 loaded, 1 bulk copies, 2 streamed}. Returns 0, or -1 if the
// layer is past the design.
extern "C" int conv2s_plan(int B, int N, int C, int Co, int sms, int max_smem, int* out) {
  Plan pl;
  if (!plan_for(B, N, C, Co, sms, max_smem, &pl)) return -1;
  const int v[7] = {pl.np, pl.blocks, pl.tiles, pl.group_slots, pl.tile_rows, pl.smem, pl.w_mode};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}
