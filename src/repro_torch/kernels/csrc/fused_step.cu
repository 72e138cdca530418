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
// What the design does about it: the trunk is the persistent tiled plan of
// trunk_common.cuh (tiles of up to 72 (lane, output position) units, the
// weights streamed through shared memory by bulk copies, 9 x 8 register
// tiles of f32 FMAs). A unit's 8 input rows are recency rows 8p..8p+7: the
// current instruction, then slots (head - r) mod Q, contiguous descending
// with at most one wrap, then zero rows. So a tile's input is the planes of
// a run of lanes, each lane's contiguous in every plane: they come in by
// bulk copies (a few lanes a round, into shared memory that layer 1 later
// fills), and one pass in shared memory reorders them into the tile's rows
// and applies the scale, flags and valid. (Gathering the rows one by one
// from device memory instead leaves each warp waiting on each batch of
// loads in turn: on the H100 that took longer than the FMAs.)

#include <cstdint>

#include "trunk_common.cuh"

namespace {

constexpr int kStatic = 41;   // static feature block per instruction
constexpr int kAddr = 5;      // address keys per instruction
constexpr int kFeat = 50;     // model input width: 41 + 3 latencies + 5 flags + valid
constexpr float kLatScale = 1.0f / 64.0f;

struct Planes {
  const float* feat;          // (L, Q, 41)
  const int* addr;            // (L, Q, 5)
  const float* resid;         // (L, Q), and the two below
  const float* exec_lat;
  const float* store_lat;
  const unsigned char* valid; // (L, Q)
  const int* head;            // ()
  const float* cur_feat;      // (L, 41)
  const int* cur_addr;        // (L, 5)
  int Q, P;                   // slots a lane; outputs a lane (seq_padded / 8)
};

constexpr int kSideBytes = 8192;  // the input's side area: row table, zeros, current instructions

// Tile input assembled from the ring state. A tile's units cover a run of
// whole or partial lanes; a lane's planes are contiguous (Q slots of 41 + 1
// + 1 + 1 + 5 words), so they come in by bulk copies, a few lanes a round,
// into h1's space (free until layer 1), while the lanes' current
// instructions come by plain loads into a side area. A table gives each
// row of the round where its 41 static words are (a slot, a current
// instruction, or a zero row) and its valid factor; then the static
// channels are filled a thread per element, branch-free, and the 9 dynamic
// ones (scale, flags, valid) a thread per row.
struct RingInput {
  static constexpr int kRows = trunk::kUnits * 8;  // row table entries
  static constexpr int kZeros = 44;                // a zero row (41), rounded to 16 bytes

  // Only what the FMA loops must keep live across the tile: the planes
  // are read from the kernel's parameter space.
  const Planes* pl;
  int stage_bytes;     // h1's space; the side area follows it
  int rounds;          // bulk-copy rounds so far (the mbarrier's phase)

  // lanes a round: a lane stages Q * 49 words, and 41 + 5 words beside the
  // row table and the zero row
  __host__ __device__ static int lanes_per_round(int q, int stage_bytes) {
    const int a = stage_bytes / (q * 49 * 4);
    const int b = (kSideBytes - 4 * (2 * kRows + kZeros)) / ((kStatic + kAddr) * 4);
    return a < b ? a : b;
  }

  __device__ void load(int, long long u0, int n, float* __restrict__ x, float* stage,
                       uint64_t* bar) {
    const Planes& pl = *this->pl;
    const int Q = pl.Q, P = pl.P, head = *pl.head;
    const int per_round = lanes_per_round(Q, stage_bytes);
    const long long g_first = u0 / P, g_end = (u0 + n - 1) / P + 1;
    // scratch, in floats from `stage` (all offsets 16-byte multiples)
    float* s_lat = stage + per_round * Q * kStatic;                   // 3 x (nl, Q)
    int* s_addr = reinterpret_cast<int*>(s_lat + 3 * per_round * Q);  // (nl, Q, 5)
    const int side = stage_bytes / 4;
    int* row_off = reinterpret_cast<int*>(stage + side);  // a row's static words: stage + off
    float* row_vf = stage + side + kRows;                 // its valid factor
    const int zeros = side + 2 * kRows, c_feat = zeros + kZeros;  // (nl, 41) after the zeros
    int* c_addr = reinterpret_cast<int*>(stage + c_feat + per_round * kStatic);  // (nl, 5)
    for (int k = threadIdx.x; k < kStatic; k += trunk::kThreads) stage[zeros + k] = 0.f;

    for (long long ga = g_first; ga < g_end; ga += per_round) {
      const int nl = (int)min((long long)per_round, g_end - ga);
      if (ga > g_first) trunk::sync_compute();  // the round before is spent
      if (threadIdx.x == 0) {
        const unsigned slots = (unsigned)(nl * Q), bytes = slots * 49 * 4;
        trunk::fence_async_shared();
        trunk::mbar_expect_tx(bar, bytes);
        trunk::bulk_copy(stage, pl.feat + ga * Q * kStatic, slots * kStatic * 4, bar);
        trunk::bulk_copy(s_lat, pl.resid + ga * Q, slots * 4, bar);
        trunk::bulk_copy(s_lat + per_round * Q, pl.exec_lat + ga * Q, slots * 4, bar);
        trunk::bulk_copy(s_lat + 2 * per_round * Q, pl.store_lat + ga * Q, slots * 4, bar);
        trunk::bulk_copy(s_addr, pl.addr + ga * Q * kAddr, slots * kAddr * 4, bar);
      }
      for (int k = threadIdx.x; k < nl * kStatic; k += trunk::kThreads)
        stage[c_feat + k] = __ldg(pl.cur_feat + ga * kStatic + k);
      for (int k = threadIdx.x; k < nl * kAddr; k += trunk::kThreads)
        c_addr[k] = __ldg(pl.cur_addr + ga * kAddr + k);
      // this round's units (those of lanes ga .. ga + nl - 1) and their rows
      const long long ua = max(u0, ga * P), ub = min(u0 + n, (ga + nl) * P);
      const int rows = (int)(ub - ua) * 8;
      for (int q = threadIdx.x; q < rows; q += trunk::kThreads) {
        const long long u = ua + (q >> 3), g = u / P;
        const int r = 8 * (int)(u - g * P) + (q & 7), gl = (int)(g - ga);
        int off = zeros;  // sequence pad
        float vf = 1.f;
        if (r == 0) {  // current instruction
          off = c_feat + gl * kStatic;
        } else if (r <= Q) {  // recency r - 1 at slot (head - r) mod Q
          const int s = head - r < 0 ? head - r + Q : head - r;
          off = (gl * Q + s) * kStatic;
          vf = __ldg(pl.valid + g * Q + s) ? 1.f : 0.f;
        }
        row_off[q] = off;
        row_vf[q] = vf;
      }
      trunk::mbar_wait(bar, rounds++ & 1);
      trunk::sync_compute();

      float* __restrict__ xr = x + (ua - u0) * 8 * kFeat;
      const float* __restrict__ src = stage;
      const int* __restrict__ offs = row_off;
      const float* __restrict__ vfs = row_vf;
      // the static channels; multiply by valid (not select), so NaN
      // propagates as in the reference (current rows and zeros: by 1)
      constexpr int kBatch = 4;
      for (int e0 = threadIdx.x; e0 < rows * kStatic; e0 += kBatch * trunk::kThreads) {
        float v[kBatch];
        int d[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int e = min(e0 + b * trunk::kThreads, rows * kStatic - 1);
          const int q = e / kStatic, c = e - q * kStatic;
          v[b] = src[offs[q] + c] * vfs[q];
          d[b] = q * kFeat + c;
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) xr[d[b]] = v[b];
      }
      // the dynamic channels 41..49, a thread per row
      for (int q = threadIdx.x; q < rows; q += trunk::kThreads) {
        const int off = offs[q];
        float* dyn = xr + q * kFeat + kStatic;
        if (off < side) {  // a slot
          const int sl = off / kStatic;
          const float f = vfs[q];
#pragma unroll
          for (int k = 0; k < 3; ++k) dyn[k] = s_lat[k * per_round * Q + sl] * kLatScale * f;
          const int* ca = c_addr + sl / Q * kAddr;
#pragma unroll
          for (int k = 0; k < kAddr; ++k) {
            dyn[3 + k] = (s_addr[sl * kAddr + k] == ca[k] && ca[k] != 0 ? 1.f : 0.f) * f;
          }
          dyn[8] = f * f;
        } else {  // current instruction: zero dynamics, valid; pad: zeros
#pragma unroll
          for (int k = 0; k < 8; ++k) dyn[k] = 0.f;
          dyn[8] = off == zeros ? 0.f : 1.f;
        }
      }
    }
    trunk::sync_compute();
  }
};

__global__ void __launch_bounds__(trunk::kBlockThreads, 1)
fused_step_kernel(const __grid_constant__ Planes pl, trunk::Weights wt, float* __restrict__ out,
                  long long units, int umax) {
  extern __shared__ __align__(128) unsigned char smem[];
  const trunk::Plan plan(umax, kFeat, kSideBytes);
  RingInput in{&pl, plan.side_off - plan.h1_off, 0};
  trunk::run_tiles(in, smem, plan, kFeat, wt, out, units);
}

trunk::DeviceCache g_cache[trunk::kMaxDevices];

}  // namespace

// State planes as the wrapper passes them (f32 feat/resid/exec/store, i32
// addr/head/cur_addr, bool valid; contiguous), weights (K, N) row-major and
// biases 16-byte aligned, out (L, S/8, C3) f32; feat, addr and the three
// latency planes 16-byte aligned (they come in by bulk copies). Needs
// Q % 4 == 0 (a lane's planes are then whole 16-byte units), S % 8 == 0,
// S >= Q + 1 and the widths the kernel is built for (trunk::C1, C2, C3).
extern "C" int fused_step_launch(const void* feat, const void* addr, const void* resid,
                                 const void* exec_lat, const void* store_lat, const void* valid,
                                 const void* head, const void* cur_feat, const void* cur_addr,
                                 const void* w1, const void* b1, const void* w2, const void* b2,
                                 const void* w3, const void* b3, void* out, int L, int Q,
                                 int S, int C1, int C2, int C3, void* stream) {
  if (L <= 0 || Q <= 0 || Q % 4 != 0 || S % 8 != 0 || S < Q + 1 || C1 != trunk::C1 ||
      C2 != trunk::C2 || C3 != trunk::C3) {
    return (int)cudaErrorInvalidValue;
  }
  int sms = 0, umax = 0;
  cudaError_t err = trunk::prepare(fused_step_kernel, g_cache, kFeat, kSideBytes, &sms, &umax);
  if (err != cudaSuccess) return (int)err;
  if (RingInput::lanes_per_round(Q, 8 * umax * trunk::kLd1) < 1) return (int)cudaErrorInvalidValue;
  const long long units = (long long)L * (S / 8);
  const int blocks = (int)(units < sms ? units : sms);
  const Planes pl{(const float*)feat,
                  (const int*)addr,
                  (const float*)resid,
                  (const float*)exec_lat,
                  (const float*)store_lat,
                  (const unsigned char*)valid,
                  (const int*)head,
                  (const float*)cur_feat,
                  (const int*)cur_addr,
                  Q,
                  S / 8};
  const trunk::Weights wt{{(const float*)w1, (const float*)w2, (const float*)w3},
                          {(const float*)b1, (const float*)b2, (const float*)b3}};
  fused_step_kernel<<<blocks, trunk::kBlockThreads, trunk::Plan(umax, kFeat, kSideBytes).bytes,
                      (cudaStream_t)stream>>>(pl, wt, (float*)out, units, umax);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block (bytes), for the build log.
extern "C" int fused_step_smem_bytes() {
  return trunk::Plan(trunk::kUnits, kFeat, kSideBytes).bytes;
}
