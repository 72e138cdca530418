// rwkv6's wkv recurrence, forward and backward, for sm_90a.
//
// Replaces no Pallas kernel. The reference runs the recurrence as one
// jax.lax.scan (src/repro/nn/ssm.py:238, over the step at :225-230), a loop
// that stays on the device; the port's plain version (kernels/ref.py
// wkv_ref) is a Python loop of T steps a layer. For each batch row b and
// head h, in f32, from S_0:
//   y_t[j] = sum_i r_t[i] (S[i,j] + u[i] k_t[i] v_t[j])
//   S[i,j] <- w_t[i] S[i,j] + k_t[i] v_t[j]
// r, k, v, w and y are (B, T, H, hd), u (H, hd), S (B, H, hd, hd).
//
// What bounds it on this card. Bytes, by the count: a forward reads r, k,
// v, w and writes y, B*T*H*hd*4 bytes each, and the saved states (below)
// as many again at hd 64; ~hd/5 FLOPs a byte, under the ~20 at which the
// f32 rate (67 TFLOP/s over 3.35 TB/s) binds. But the recurrence is
// sequential in T: each (b, h) is a chain of T steps of hd x hd elementwise
// work, and only B*H*hd^2 elements (524,288 at rwkv6-1.6b's training
// batch) can run side by side. Each element costs 3 FP instructions a step
// in the forward (k*v, the S update, the y sum), ~9 in the backward, and
// its share of the floats a thread reads from shared memory (r, k, w of its
// rows, v of its columns, the backward's history), which go through the
// SM's one shared-memory pipe. With so few elements an SM holds few warps,
// so what bounds a step is latency: how many warps an SM has to switch
// between while one waits on a load, a shuffle or a barrier.
//
// What the design does about it:
// - Register tiles of 4 rows x 4 columns of S (forward) or of the carried
//   gradient G (backward): a step reads 4 of each of r, k, w and 4 of v (and
//   gy) for 16 elements, and the training batch's elements make 8 warps an
//   SM. y_t[j] sums over rows: the row tiles of a column tile are lanes of
//   one warp, and a reduce-scatter of shuffles leaves each lane one
//   column's sum; the u term is folded in as v_t[j] * sum_i r u k over the
//   tile's rows, one FMA a column.
// - Loads overlap the recurrence. A chunk of kC = 16 steps of r, k, w and
//   the block's v (and gy) comes into a ring of shared-memory stages (4 in
//   the forward, 2 in the backward) by 16-byte cp.async of every thread,
//   each thread arriving on the stage's mbarrier once its copies land; the
//   next chunks' copies are in flight while a chunk's steps run. (Bulk
//   copies, one a 256-byte vector issued by one warp, held the block at
//   every chunk's barrier behind that warp.) Outputs are held in registers
//   until a chunk's (or a half's) steps are done, so that no store orders a
//   step's loads behind the last step's sums.
// - Forward grid: one block of (hd/4) x (min(hd, 64)/4) threads a (b, h)
//   and 64-column group (256 threads at hd 64; hd 128 takes two blocks a
//   (b, h)). When asked, it saves the state before every kC-th step (ckpt,
//   (B, H, ceil(T/kC), hd, hd): as many bytes as r, k, v and w together at
//   hd 64. kC = 16 is kept; it caps a saving forward at 5/9 and the
//   backward, which reads them, at 9/13 of what its bound, which leaves the
//   states out, allows).
// - Backward: one cluster of hd/R blocks a (b, h), each block R = 32 rows
//   (16 at hd 128) of S and G with every column, so the carried gradient
//   G <- w_t G + r_t gy_t^T runs once, elementwise. For each chunk from the
//   last, in halves of kH = 8 steps from the later one, a block recomputes
//   S_{t-1} of its rows from the saved state with the forward's own
//   arithmetic (fmaf(w, S, k*v): the same bits; S is never recovered by
//   dividing by w) into a history in shared memory, 8 steps x R rows x hd
//   (64 KB at hd 64, not local memory), then runs the steps backwards:
//     gr_t[i] = sum_j gy_t[j] S_{t-1}[i,j] + u[i] k_t[i] (v_t . gy_t)
//     gk_t[i] = sum_j G_t[i,j] v_t[j]      + u[i] r_t[i] (v_t . gy_t)
//     gw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//     gu[i]  += r_t[i] k_t[i] (v_t . gy_t)   (a partial per (b, h))
//     gv_t[j] = sum_i G_t[i,j] k_t[i] + gy_t[j] (r_t . (u * k_t))
//   The row sums (with v_t . gy_t) finish in a reduce-scatter over the
//   column tiles of a row tile, lanes of one warp; gv's column sums over
//   the row tiles of a warp, then each warp's partial goes to shared
//   memory and, once a half, the block of cluster rank q sums its hd/NC
//   columns over the cluster's partials through distributed shared memory
//   (double-buffered: one cluster barrier a half). gS_0 = G_0. The history
//   of 8 steps, not 16, keeps every (b, h) of the training batch resident
//   at once (16 MB of the card's ~30 MB of shared memory); the later half's
//   recomputation runs the first 8 steps again, 1.5 steps of recomputation
//   a step. A thread's part of the saved state comes into registers a half
//   before it is needed.
// - No fallback: a launch the card refuses (cluster, shared memory)
//   returns its error, which the wrapper raises.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kC = 16;  // steps a chunk; the forward saves the state every kC steps
constexpr int kH = 8;   // steps of the backward's history of S
constexpr int kRI = 4;  // rows of a thread's tile
constexpr int kCJ = 4;  // columns of a thread's tile
constexpr unsigned kFull = 0xffffffffu;
static_assert(kRI == 4 && kCJ == 4, "a tile row is one float4; r, k, w of its rows too");

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }

// Sums COUNT values of each lane over the 2^LEVELS lanes that differ in the
// lane bits M, M/2, ...: while more than one value is left, a level keeps
// half of them (the upper half where the lane's bit is set) and adds the
// partner's; the levels after that add the one value left. A lane ends with
// a[0 .. max(COUNT >> LEVELS, 1)), the sums of the values from index
// held_offset<COUNT, M, LEVELS>(lane) on.
template <int COUNT, int M, int LEVELS, int N>
__device__ __forceinline__ void reduce_lanes(float (&a)[N], unsigned lane) {
  if constexpr (LEVELS > 0) {
    if constexpr (COUNT > 1) {
      const bool up = (lane & M) != 0;
#pragma unroll
      for (int q = 0; q < COUNT / 2; ++q) {
        const float send = up ? a[q] : a[q + COUNT / 2];
        const float keep = up ? a[q + COUNT / 2] : a[q];
        a[q] = keep + __shfl_xor_sync(kFull, send, M);
      }
      reduce_lanes<COUNT / 2, M / 2, LEVELS - 1>(a, lane);
    } else {
      a[0] += __shfl_xor_sync(kFull, a[0], M);
      reduce_lanes<1, M / 2, LEVELS - 1>(a, lane);
    }
  }
}

template <int COUNT, int M, int LEVELS>
__device__ __forceinline__ int held_offset(unsigned lane) {
  if constexpr (LEVELS == 0 || COUNT == 1) {
    return 0;
  } else {
    return ((lane & M) ? COUNT / 2 : 0) + held_offset<COUNT / 2, M / 2, LEVELS - 1>(lane);
  }
}

__device__ __forceinline__ float pick(const float (&a)[4], int q) {
  return q == 0 ? a[0] : q == 1 ? a[1] : q == 2 ? a[2] : a[3];
}

__device__ __forceinline__ void split4(float4 x, float* out) {
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}

// A tile of 4 rows from `src` (row stride `ld` floats) into registers, and back.
__device__ __forceinline__ void load_tile(float (&t)[kRI][kCJ], const float* src, size_t ld) {
#pragma unroll
  for (int q = 0; q < kRI; ++q) split4(*reinterpret_cast<const float4*>(src + q * ld), t[q]);
}
__device__ __forceinline__ void store_tile(float* dst, size_t ld, const float (&t)[kRI][kCJ]) {
#pragma unroll
  for (int q = 0; q < kRI; ++q) {
    *reinterpret_cast<float4*>(dst + q * ld) = make_float4(t[q][0], t[q][1], t[q][2], t[q][3]);
  }
}

// The cluster barrier in two halves: this thread's shared-memory writes
// are visible to the cluster's blocks once every thread has arrived and
// it has waited.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// ------------------------------------------------------------------ forward

template <int HD>
struct Fwd {
  static constexpr int COLS = HD < 64 ? HD : 64;   // columns a block
  static constexpr int GROUPS = HD / COLS;         // blocks a (b, h)
  static constexpr int RT = HD / kRI;              // row tiles: lanes of one column tile
  static constexpr int CT = COLS / kCJ;            // column tiles a block
  static constexpr int THREADS = RT * CT;
  static constexpr int STAGES = 4;
  static constexpr int STAGE_FLOATS = kC * (3 * HD + COLS);  // r, k, w [kC][HD], v [kC][COLS]
  static constexpr int SMEM = 128 + 4 * STAGES * STAGE_FLOATS;
  static_assert(RT >= kCJ && RT <= 32 && THREADS % 32 == 0, "tile layout");
};

// Every thread: its 16-byte pieces of chunk [t0, t0 + len)'s r, k, w and
// the block's v into a stage (cp.async), then one arrival on `bar` once
// they have landed. `at` is step t0's offset in (B, T, H, HD).
template <int HD>
__device__ __forceinline__ void fwd_load(float* dst, uint64_t* bar, const float* r,
                                         const float* k, const float* w, const float* v,
                                         size_t at, size_t stride, int len, int col0,
                                         unsigned tid) {
  using P = Fwd<HD>;
  constexpr int QH = HD / 4, QC = P::COLS / 4, STEP = 3 * QH + QC;  // float4s a step
  for (int e = tid; e < len * STEP; e += P::THREADS) {
    const int tt = e / STEP, q = e - tt * STEP, n = q / QH, c4 = 4 * (q - n * QH);
    const size_t src = at + tt * stride + c4;
    if (n < 3) {
      sm90::cp_async16(dst + (n * kC + tt) * HD + c4, (n == 0 ? r : n == 1 ? k : w) + src);
    } else {
      sm90::cp_async16(dst + 3 * kC * HD + tt * P::COLS + c4, v + src + col0);
    }
  }
  sm90::cp_async_arrive(bar);
}

// Step tt of a stage `x` for a thread's tile: S <- w_t S + k_t v_t^T, and
// the tile's part of y_t summed over the column tile's lanes (the lane's
// column's, held_offset on).
template <int HD>
__device__ __forceinline__ float fwd_step(float (&S)[kRI][kCJ], const float (&uu)[kRI],
                                          const float* x, int tt, int i0, int j0, unsigned lane) {
  using P = Fwd<HD>;
  float rr[kRI], kk[kRI], ww[kRI], vv[kCJ];
  split4(*reinterpret_cast<const float4*>(x + tt * HD + i0), rr);
  split4(*reinterpret_cast<const float4*>(x + (kC + tt) * HD + i0), kk);
  split4(*reinterpret_cast<const float4*>(x + (2 * kC + tt) * HD + i0), ww);
  split4(*reinterpret_cast<const float4*>(x + 3 * kC * HD + tt * P::COLS + j0), vv);
  float ruk = 0.f;  // sum over the tile's rows of r u k
#pragma unroll
  for (int q = 0; q < kRI; ++q) ruk = fmaf(rr[q] * uu[q], kk[q], ruk);
  float acc[kCJ];
#pragma unroll
  for (int p = 0; p < kCJ; ++p) acc[p] = vv[p] * ruk;
#pragma unroll
  for (int q = 0; q < kRI; ++q) {
#pragma unroll
    for (int p = 0; p < kCJ; ++p) {
      const float kv = kk[q] * vv[p];
      acc[p] = fmaf(rr[q], S[q][p], acc[p]);
      S[q][p] = fmaf(ww[q], S[q][p], kv);
    }
  }
  reduce_lanes<kCJ, P::RT / 2, ilog2(P::RT)>(acc, lane);
  return acc[0];
}

template <int HD>
__global__ void __launch_bounds__(Fwd<HD>::THREADS)
wkv_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ s0,
               float* __restrict__ y, float* __restrict__ s_out, float* __restrict__ ckpt,
               int T, int H) {
  using P = Fwd<HD>;
  constexpr int RT = P::RT;
  extern __shared__ __align__(128) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* stages = smem + 32;

  const int bh = blockIdx.x / P::GROUPS, col0 = (blockIdx.x % P::GROUPS) * P::COLS;
  const int b = bh / H, h = bh % H;
  const unsigned tid = threadIdx.x, lane = tid & 31;
  const int rt = lane % RT, ct = (tid / 32) * (32 / RT) + lane / RT;
  const int i0 = rt * kRI, j0 = ct * kCJ;  // j0 within the block's columns
  const size_t stride = (size_t)H * HD, base = ((size_t)b * T * H + h) * HD;
  const int chunks = (T + kC - 1) / kC;

  if (tid == 0) {
    for (int s = 0; s < P::STAGES; ++s) sm90::mbar_init(&full[s], P::THREADS);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  for (int c = 0; c < P::STAGES && c < chunks; ++c) {
    fwd_load<HD>(stages + c * P::STAGE_FLOATS, &full[c], r, k, w, v, base + (size_t)c * kC * stride,
                 stride, min(kC, T - c * kC), col0, tid);
  }

  const size_t tile = (size_t)i0 * HD + col0 + j0;  // the tile's first element in a state
  float S[kRI][kCJ], uu[kRI];
  load_tile(S, s0 + (size_t)bh * HD * HD + tile, HD);
  split4(*reinterpret_cast<const float4*>(u + h * HD + i0), uu);
  // the column of y a lane holds after the reduction, and whether it writes it
  const int y_col = j0 + held_offset<kCJ, RT / 2, ilog2(RT)>(lane);
  const bool y_writer = rt % (RT / kCJ) == 0;

  for (int c = 0; c < chunks; ++c) {
    const int s = c % P::STAGES, t0 = c * kC, len = min(kC, T - t0);
    if (ckpt != nullptr) store_tile(ckpt + ((size_t)bh * chunks + c) * HD * HD + tile, HD, S);
    sm90::mbar_wait(&full[s], (c / P::STAGES) & 1);
    const float* x = stages + s * P::STAGE_FLOATS;
    float* yc = y + base + (size_t)t0 * stride + col0 + y_col;  // the lane's column at step t0
    if (len == kC) {  // y held in registers until the chunk's steps are done
      float yt[kC];
#pragma unroll
      for (int tt = 0; tt < kC; ++tt) yt[tt] = fwd_step<HD>(S, uu, x, tt, i0, j0, lane);
      if (y_writer) {
#pragma unroll
        for (int tt = 0; tt < kC; ++tt) yc[tt * stride] = yt[tt];
      }
    } else {
      for (int tt = 0; tt < len; ++tt) {
        const float yt = fwd_step<HD>(S, uu, x, tt, i0, j0, lane);
        if (y_writer) yc[tt * stride] = yt;
      }
    }
    __syncthreads();  // the stage is read: the chunk STAGES on comes into it
    if (c + P::STAGES < chunks) {
      const int cn = c + P::STAGES;
      fwd_load<HD>(stages + s * P::STAGE_FLOATS, &full[s], r, k, w, v, base + (size_t)cn * kC * stride,
                   stride, min(kC, T - cn * kC), col0, tid);
    }
  }
  store_tile(s_out + (size_t)bh * HD * HD + tile, HD, S);
}

// ----------------------------------------------------------------- backward

template <int HD>
struct Bwd {
  static constexpr int R = HD == 128 ? 16 : 32;  // rows a block
  static constexpr int NC = HD / R;              // blocks a (b, h): one cluster
  static constexpr int CT = HD / kCJ;            // column tiles: lanes of one row tile
  static constexpr int RTW = 32 / CT;            // row tiles a warp
  static constexpr int WARPS = R / kRI / RTW;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int SUMS = 16;  // row sums a step: gr, gk, gw parts of 4 rows, v . gy, pad
  static constexpr int HELD = SUMS >= CT ? SUMS / CT : 1;  // of them, after the reduction, a lane's
  static constexpr int GV_HELD = kCJ / RTW;                // gv columns a lane holds
  static constexpr int STAGE_FLOATS = kC * (3 * R + 2 * HD);  // r, k, w [kC][R], gy, v [kC][HD]
  static constexpr int TILE4 = kRI * kCJ / 4;                 // float4s of a tile
  static constexpr int HIST_FLOATS = kH * R * HD;
  static constexpr int GV_FLOATS = kH * HD;  // a warp's gv partial of a half
  static constexpr int SMEM = 128 + 4 * (2 * STAGE_FLOATS + HIST_FLOATS + 2 * WARPS * GV_FLOATS);
  static_assert(CT <= 32 && RTW <= kCJ && WARPS >= 1 && HD % NC == 0, "tile layout");
};

// Every thread: its 16-byte pieces of chunk [t0, t0 + len)'s r, k, w of
// the block's rows and gy, v into a stage (cp.async), then one arrival on
// `bar` once they have landed.
template <int HD>
__device__ __forceinline__ void bwd_load(float* dst, uint64_t* bar, const float* r,
                                         const float* k, const float* w, const float* gy,
                                         const float* v, size_t at, size_t stride, int len,
                                         int row0, unsigned tid) {
  using P = Bwd<HD>;
  constexpr int QR = P::R / 4, QH = HD / 4, STEP = 3 * QR + 2 * QH;  // float4s a step
  for (int e = tid; e < len * STEP; e += P::THREADS) {
    const int tt = e / STEP, q = e - tt * STEP;
    const size_t src = at + tt * stride;
    if (q < 3 * QR) {
      const int n = q / QR, c4 = 4 * (q - n * QR);
      sm90::cp_async16(dst + (n * kC + tt) * P::R + c4,
                       (n == 0 ? r : n == 1 ? k : w) + src + row0 + c4);
    } else {
      const int n = (q - 3 * QR) / QH, c4 = 4 * (q - 3 * QR - n * QH);
      sm90::cp_async16(dst + 3 * kC * P::R + (n * kC + tt) * HD + c4, (n == 0 ? gy : v) + src + c4);
    }
  }
  sm90::cp_async_arrive(bar);
}

// A backward tile's k, w (its rows) and v (its columns) at step tt of a
// stage `x`.
template <int HD>
__device__ __forceinline__ void bwd_kwv(const float* x, int tt, int i0, int j0, float (&kk)[kRI],
                                        float (&ww)[kRI], float (&vv)[kCJ]) {
  constexpr int R = Bwd<HD>::R;
  split4(*reinterpret_cast<const float4*>(x + (kC + tt) * R + i0), kk);
  split4(*reinterpret_cast<const float4*>(x + (2 * kC + tt) * R + i0), ww);
  split4(*reinterpret_cast<const float4*>(x + 3 * kC * R + (kC + tt) * HD + j0), vv);
}

// S_{t-1} of a thread's tile for t in [lo, hi) into its history slots t -
// lo (hs: the tile's first float4), from S, the state before step 0 of the
// stage, with the forward's arithmetic (the same bits). A step's inputs
// are read before the last step's history is written.
template <int HD>
__device__ __forceinline__ void bwd_recompute(float (&S)[kRI][kCJ], const float* x, float4* hs,
                                              int lo, int hi, int i0, int j0) {
  using P = Bwd<HD>;
  float kk[kRI], ww[kRI], vv[kCJ];
  bwd_kwv<HD>(x, 0, i0, j0, kk, ww, vv);
  for (int tt = 0; tt < hi; ++tt) {
    float kn[kRI], wn[kRI], vn[kCJ];
    bwd_kwv<HD>(x, tt + 1 < hi ? tt + 1 : tt, i0, j0, kn, wn, vn);
    if (tt >= lo) {
      float4* h = hs + (size_t)(tt - lo) * P::TILE4 * P::THREADS;
#pragma unroll
      for (int q = 0; q < kRI; ++q) h[q * P::THREADS] = make_float4(S[q][0], S[q][1], S[q][2], S[q][3]);
    }
#pragma unroll
    for (int q = 0; q < kRI; ++q) {
#pragma unroll
      for (int p = 0; p < kCJ; ++p) S[q][p] = fmaf(ww[q], S[q][p], kk[q] * vv[p]);
    }
#pragma unroll
    for (int q = 0; q < kRI; ++q) kk[q] = kn[q], ww[q] = wn[q];
#pragma unroll
    for (int p = 0; p < kCJ; ++p) vv[p] = vn[p];
  }
}

// Step tt of a stage `x` backwards for a thread's tile: G = G_t on entry,
// G_{t-1} on return; S_{t-1} from the history (hs: the tile's first float4
// of slot 0; slot tt - lo). out: the lane's held row sums made into gr, gk
// or gw by their slot (sum0 on); gu_acc: gu's partials of its gr rows;
// gvp: the warp's gv partial of the lane's columns (gv_col on).
template <int HD>
__device__ __forceinline__ void bwd_step(float (&G)[kRI][kCJ], const float (&uu)[kRI],
                                         const float* x, const float4* hs, int lo, int tt, int i0,
                                         int j0, int sum0, unsigned lane,
                                         float (&out)[Bwd<HD>::HELD], float (&gu_acc)[Bwd<HD>::HELD],
                                         float (&gvp)[Bwd<HD>::GV_HELD]) {
  using P = Bwd<HD>;
  constexpr int R = P::R, CT = P::CT;
  float rr[kRI], kk[kRI], ww[kRI], gg[kCJ], vv[kCJ], Sp[kRI][kCJ];
  split4(*reinterpret_cast<const float4*>(x + tt * R + i0), rr);
  split4(*reinterpret_cast<const float4*>(x + (kC + tt) * R + i0), kk);
  split4(*reinterpret_cast<const float4*>(x + (2 * kC + tt) * R + i0), ww);
  split4(*reinterpret_cast<const float4*>(x + 3 * kC * R + tt * HD + j0), gg);
  split4(*reinterpret_cast<const float4*>(x + 3 * kC * R + (kC + tt) * HD + j0), vv);
  const float4* h = hs + (size_t)(tt - lo) * P::TILE4 * P::THREADS;
#pragma unroll
  for (int q = 0; q < kRI; ++q) split4(h[q * P::THREADS], Sp[q]);
  float sums[P::SUMS];  // [a (gr) x 4, b (gk) x 4, c (gw) x 4, v . gy, 0 x 3]
  float e_rows = 0.f;   // sum over the tile's rows of r u k
#pragma unroll
  for (int q = 0; q < kRI; ++q) {
    float a = 0.f, bb = 0.f, cc = 0.f;
#pragma unroll
    for (int p = 0; p < kCJ; ++p) {
      a = fmaf(gg[p], Sp[q][p], a);      // gy_t . S_{t-1}[i, :]
      bb = fmaf(G[q][p], vv[p], bb);     // G_t[i, :] . v_t
      cc = fmaf(G[q][p], Sp[q][p], cc);  // G_t[i, :] . S_{t-1}[i, :]
    }
    sums[q] = a;
    sums[kRI + q] = bb;
    sums[2 * kRI + q] = cc;
    e_rows = fmaf(rr[q] * uu[q], kk[q], e_rows);
  }
  float d = 0.f;
#pragma unroll
  for (int p = 0; p < kCJ; ++p) d = fmaf(gg[p], vv[p], d);  // gy_t . v_t
  sums[3 * kRI] = d;
#pragma unroll
  for (int s = 3 * kRI + 1; s < P::SUMS; ++s) sums[s] = 0.f;
  float e[kCJ];  // gv's partial: G_t[:, j] . k_t + gy_t[j] (r_t . (u * k_t)) over the rows
#pragma unroll
  for (int p = 0; p < kCJ; ++p) {
    float acc = gg[p] * e_rows;
#pragma unroll
    for (int q = 0; q < kRI; ++q) acc = fmaf(G[q][p], kk[q], acc);
    e[p] = acc;
  }
#pragma unroll
  for (int q = 0; q < kRI; ++q) {
#pragma unroll
    for (int p = 0; p < kCJ; ++p) G[q][p] = fmaf(ww[q], G[q][p], rr[q] * gg[p]);
  }
  reduce_lanes<P::SUMS, CT / 2, ilog2(CT)>(sums, lane);
  // v_t . gy_t, held by the lanes of the row tile whose sums start at 3 * RI
  d = __shfl_sync(kFull, sums[0], 3 * kRI * CT / P::SUMS, CT);
#pragma unroll
  for (int s = 0; s < P::HELD; ++s) {
    const int slot = sum0 + s, q = slot % kRI;
    const float ri = pick(rr, q), ki = pick(kk, q), ui = pick(uu, q);
    out[s] = slot < kRI ? fmaf(ui * ki, d, sums[s]) : slot < 2 * kRI ? fmaf(ui * ri, d, sums[s]) : sums[s];
    if (slot < kRI) gu_acc[s] = fmaf(ri * ki, d, gu_acc[s]);
  }
  reduce_lanes<kCJ, 16, ilog2(P::RTW)>(e, lane);
#pragma unroll
  for (int s = 0; s < P::GV_HELD; ++s) gvp[s] = e[s];
}

// A step's outputs: the lane's gr, gk or gw values to device memory (`at`:
// the step's offset in (B, T, H, HD)), its gv partials to the warp's
// buffer (step slot `slot`).
template <int HD>
__device__ __forceinline__ void bwd_write(float* const (&dst)[Bwd<HD>::HELD],
                                          const int (&drow)[Bwd<HD>::HELD],
                                          const float (&out)[Bwd<HD>::HELD], float* gvb, int gv_col,
                                          const float (&gvp)[Bwd<HD>::GV_HELD], size_t at, int slot) {
#pragma unroll
  for (int s = 0; s < Bwd<HD>::HELD; ++s) {
    if (dst[s] != nullptr) dst[s][at + drow[s]] = out[s];
  }
#pragma unroll
  for (int s = 0; s < Bwd<HD>::GV_HELD; ++s) gvb[slot * HD + gv_col + s] = gvp[s];
}

// gv of `steps` steps from step offset `at` (in (B, T, H, HD)): this
// block's HD / NC columns, each summed over the cluster's warps' partials
// (`parts`: this block's buffer of them; the other blocks' at the same
// offset).
template <int HD>
__device__ __forceinline__ void gv_sums(float* gv, float* parts, const cg::cluster_group& cluster,
                                        int rank, size_t at, size_t stride, int steps,
                                        unsigned tid) {
  using P = Bwd<HD>;
  constexpr int COLS = HD / P::NC;
  for (int e = tid; e < steps * COLS; e += P::THREADS) {
    const int tl = e / COLS, col = rank * COLS + e % COLS;
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < P::NC; ++q) {
      const float* src = cluster.map_shared_rank(parts, q);
#pragma unroll
      for (int wp = 0; wp < P::WARPS; ++wp) acc += src[wp * P::GV_FLOATS + tl * HD + col];
    }
    gv[at + tl * stride + col] = acc;
  }
}

template <int HD>
__global__ void __launch_bounds__(Bwd<HD>::THREADS)
wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ ckpt,
               const float* __restrict__ gy, const float* __restrict__ gs,
               float* __restrict__ gr, float* __restrict__ gk, float* __restrict__ gv,
               float* __restrict__ gw, float* __restrict__ gu_part, float* __restrict__ gs0,
               int T, int H) {
  using P = Bwd<HD>;
  constexpr int R = P::R, CT = P::CT;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [2]: the stages
  float* stages = smem + 32;
  float4* hist = reinterpret_cast<float4*>(stages + 2 * P::STAGE_FLOATS);
  float* gvs = reinterpret_cast<float*>(hist) + P::HIST_FLOATS;  // [2][WARPS][kH][HD]

  const int rank = (int)cluster.block_rank(), bh = blockIdx.x / P::NC;
  const int b = bh / H, h = bh % H, row0 = rank * R;
  const unsigned tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ct = lane % CT, rt = warp * P::RTW + lane / CT;
  const int i0 = rt * kRI, j0 = ct * kCJ;  // i0 within the block's rows
  const size_t stride = (size_t)H * HD, base = ((size_t)b * T * H + h) * HD;
  const int chunks = (T + kC - 1) / kC;
  const size_t tile = (size_t)(row0 + i0) * HD + j0;  // the tile's first element in a state
  const float* ckpt_tile = ckpt + (size_t)bh * chunks * HD * HD + tile;  // chunk c: + c * HD * HD

  if (tid == 0) {
    sm90::mbar_init(&full[0], P::THREADS);
    sm90::mbar_init(&full[1], P::THREADS);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  for (int n = 0; n < 2 && n < chunks; ++n) {
    const int c = chunks - 1 - n;
    bwd_load<HD>(stages + n * P::STAGE_FLOATS, &full[n], r, k, w, gy, v,
                 base + (size_t)c * kC * stride, stride, min(kC, T - c * kC), row0, tid);
  }

  float G[kRI][kCJ], uu[kRI], S0[kRI][kCJ];  // S0: the saved state of the chunk at hand
  if (gs == nullptr) {
#pragma unroll
    for (int q = 0; q < kRI; ++q) G[q][0] = G[q][1] = G[q][2] = G[q][3] = 0.f;
  } else {
    load_tile(G, gs + (size_t)bh * HD * HD + tile, HD);
  }
  load_tile(S0, ckpt_tile + (size_t)(chunks - 1) * HD * HD, HD);
  split4(*reinterpret_cast<const float4*>(u + h * HD + row0 + i0), uu);
  // the row sums a lane holds after the reductions and where they go (gr,
  // gk or gw, or nowhere: the pad, or a second lane holding the same sums),
  // and its gv columns
  const int sum0 = held_offset<P::SUMS, CT / 2, ilog2(CT)>(lane);
  const bool sum_writer = CT <= P::SUMS || lane % (CT / P::SUMS) == 0;
  float* dst[P::HELD];
  int drow[P::HELD];
#pragma unroll
  for (int s = 0; s < P::HELD; ++s) {
    const int slot = sum0 + s;
    dst[s] = !sum_writer ? nullptr : slot < kRI ? gr : slot < 2 * kRI ? gk : slot < 3 * kRI ? gw : nullptr;
    drow[s] = row0 + i0 + slot % kRI;
  }
  const int gv_col = j0 + held_offset<kCJ, 16, ilog2(P::RTW)>(lane);
  float gu_acc[P::HELD];
#pragma unroll
  for (int s = 0; s < P::HELD; ++s) gu_acc[s] = 0.f;

  // A half's gv is summed over the cluster during the next half, after its
  // recomputation: the half's cluster barrier is arrived at after its steps
  // and waited for there. `owed`: the last half's first step and steps, its
  // buffer the parity of `halves` - 1.
  int halves = 0, owed_t = 0, owed_steps = 0;
  for (int n = 0; n < chunks; ++n) {
    const int c = chunks - 1 - n, s = n & 1, t0 = c * kC, len = min(kC, T - t0);
    bool refill = n >= 1 && n + 1 < chunks;  // chunk n + 1 into chunk n - 1's stage
    sm90::mbar_wait(&full[s], (n >> 1) & 1);
    const float* x = stages + s * P::STAGE_FLOATS;
    for (int half = len > kH ? 1 : 0; half >= 0; --half) {
      const int lo = half * kH, hi = min(lo + kH, len);
      float S[kRI][kCJ];
#pragma unroll
      for (int q = 0; q < kRI; ++q) {
#pragma unroll
        for (int p = 0; p < kCJ; ++p) S[q][p] = S0[q][p];
      }
      if (half == 0 && n + 1 < chunks) load_tile(S0, ckpt_tile + (size_t)(c - 1) * HD * HD, HD);
      bwd_recompute<HD>(S, x, hist + tid, lo, hi, i0, j0);
      if (owed_steps > 0) {  // every block's partials of the last half are written
        cluster_wait();
        gv_sums<HD>(gv, gvs + ((halves - 1) & 1) * P::WARPS * P::GV_FLOATS, cluster, rank,
                    base + (size_t)owed_t * stride, stride, owed_steps, tid);
        if (refill) {  // every thread of the block is past chunk n - 1's steps
          bwd_load<HD>(stages + (s ^ 1) * P::STAGE_FLOATS, &full[s ^ 1], r, k, w, gy, v,
                       base + (size_t)(c - 1) * kC * stride, stride, kC, row0, tid);
          refill = false;
        }
      }
      // the steps of [lo, hi) backwards
      float* gvb = gvs + (halves & 1) * P::WARPS * P::GV_FLOATS + warp * P::GV_FLOATS;
      if (hi - lo == kH) {  // outputs held in registers until the half's steps are done
        float outs[kH][P::HELD], gvr[kH][P::GV_HELD];
#pragma unroll
        for (int e = 0; e < kH; ++e) {
          bwd_step<HD>(G, uu, x, hist + tid, lo, hi - 1 - e, i0, j0, sum0, lane, outs[e], gu_acc, gvr[e]);
        }
#pragma unroll
        for (int e = 0; e < kH; ++e) {
          bwd_write<HD>(dst, drow, outs[e], gvb, gv_col, gvr[e], base + (size_t)(t0 + hi - 1 - e) * stride,
                        hi - 1 - e - lo);
        }
      } else {
        for (int tt = hi - 1; tt >= lo; --tt) {
          float out[P::HELD], gvp[P::GV_HELD];
          bwd_step<HD>(G, uu, x, hist + tid, lo, tt, i0, j0, sum0, lane, out, gu_acc, gvp);
          bwd_write<HD>(dst, drow, out, gvb, gv_col, gvp, base + (size_t)(t0 + tt) * stride, tt - lo);
        }
      }
      cluster_arrive();
      owed_t = t0 + lo, owed_steps = hi - lo;
      ++halves;
    }
  }
  cluster_wait();
  gv_sums<HD>(gv, gvs + ((halves - 1) & 1) * P::WARPS * P::GV_FLOATS, cluster, rank,
              base + (size_t)owed_t * stride, stride, owed_steps, tid);
  store_tile(gs0 + (size_t)bh * HD * HD + tile, HD, G);
#pragma unroll
  for (int s = 0; s < P::HELD; ++s) {
    if (dst[s] == gr) gu_part[(size_t)bh * HD + drow[s]] = gu_acc[s];
  }
  cluster.sync();  // no block leaves while another reads its gv partials
}

// ------------------------------------------------------------------ launches

// Per device, at its first launch: each kernel may take its shared memory.
bool g_ready[sm90::kMaxDevices];
std::mutex g_mu;

template <int HD>
cudaError_t allow_hd() {
  cudaError_t err = cudaFuncSetAttribute(wkv_fwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Fwd<HD>::SMEM);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(wkv_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Bwd<HD>::SMEM);
  }
  return err;
}

cudaError_t prepare(int dev) {
  if (dev < 0 || dev >= sm90::kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_ready[dev]) return cudaSuccess;
  cudaError_t err = allow_hd<32>();
  if (err == cudaSuccess) err = allow_hd<64>();
  if (err == cudaSuccess) err = allow_hd<128>();
  if (err == cudaSuccess) g_ready[dev] = true;
  return err;
}

template <int HD>
int fwd(const float* r, const float* k, const float* v, const float* w, const float* u,
        const float* s0, float* y, float* s_out, float* ckpt, int B, int T, int H,
        cudaStream_t stream) {
  using P = Fwd<HD>;
  wkv_fwd_kernel<HD><<<B * H * P::GROUPS, P::THREADS, P::SMEM, stream>>>(r, k, v, w, u, s0, y, s_out,
                                                                         ckpt, T, H);
  return (int)cudaGetLastError();
}

template <int HD>
int bwd(const float* r, const float* k, const float* v, const float* w, const float* u,
        const float* ckpt, const float* gy, const float* gs, float* gr, float* gk, float* gv,
        float* gw, float* gu_part, float* gs0, int B, int T, int H, cudaStream_t stream) {
  using P = Bwd<HD>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H * P::NC);
  cfg.blockDim = dim3(P::THREADS);
  cfg.dynamicSmemBytes = P::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P::NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, wkv_bwd_kernel<HD>, r, k, v, w, u, ckpt, gy, gs, gr,
                                       gk, gv, gw, gu_part, gs0, T, H);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// r, k, v, w, y (B, T, H, hd); u (H, hd); s0, s_out (B, H, hd, hd): f32,
// contiguous, 16-byte aligned. ckpt: null, or (B, H, ceil(T / 16), hd, hd)
// f32 for the states before every 16th step. hd 32, 64 or 128. `device` is
// the current CUDA device. One launch on `stream`.
extern "C" int wkv_fwd_launch(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* s0, void* y, void* s_out, void* ckpt,
                              int B, int T, int H, int hd, int device, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = prepare(device);
  if (err != cudaSuccess) return (int)err;
#define WKV_FWD(HD)                                                                             \
  fwd<HD>((const float*)r, (const float*)k, (const float*)v, (const float*)w, (const float*)u, \
          (const float*)s0, (float*)y, (float*)s_out, (float*)ckpt, B, T, H, (cudaStream_t)stream)
  switch (hd) {
    case 32: return WKV_FWD(32);
    case 64: return WKV_FWD(64);
    case 128: return WKV_FWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef WKV_FWD
}

// The forward's inputs, its saved states (ckpt), gy (B, T, H, hd) and gs
// (null for zeros, or (B, H, hd, hd)) -> gr, gk, gv, gw (B, T, H, hd), gu_part
// (B, H, hd: u's gradient of each (b, h), summed over b by the caller) and
// gs0 (B, H, hd, hd). `device` is the current CUDA device. One launch on
// `stream`, in clusters of hd / 32 blocks (8 at hd 128).
extern "C" int wkv_bwd_launch(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* ckpt, const void* gy, const void* gs,
                              void* gr, void* gk, void* gv, void* gw, void* gu_part, void* gs0,
                              int B, int T, int H, int hd, int device, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || ckpt == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = prepare(device);
  if (err != cudaSuccess) return (int)err;
#define WKV_BWD(HD)                                                                             \
  bwd<HD>((const float*)r, (const float*)k, (const float*)v, (const float*)w, (const float*)u, \
          (const float*)ckpt, (const float*)gy, (const float*)gs, (float*)gr, (float*)gk,        \
          (float*)gv, (float*)gw, (float*)gu_part, (float*)gs0, B, T, H, (cudaStream_t)stream)
  switch (hd) {
    case 32: return WKV_BWD(32);
    case 64: return WKV_BWD(64);
    case 128: return WKV_BWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef WKV_BWD
}

// The steps between two saved states (the checkpoint interval): the caller
// sizes ckpt by it.
extern "C" int wkv_chunk_steps() { return kC; }

// A launch's geometry at (B, H, hd), forward (backward 0) or backward (1):
// out = {blocks, blocks a cluster, threads a block, dynamic shared memory
// bytes a block}. -1 for an hd the kernels do not take.
extern "C" int wkv_geometry(int backward, int B, int H, int hd, int* out) {
#define WKV_GEOM(HD)                                                                 \
  do {                                                                               \
    if (backward) {                                                                  \
      out[0] = B * H * Bwd<HD>::NC, out[1] = Bwd<HD>::NC, out[2] = Bwd<HD>::THREADS; \
      out[3] = Bwd<HD>::SMEM;                                                        \
    } else {                                                                         \
      out[0] = B * H * Fwd<HD>::GROUPS, out[1] = 1, out[2] = Fwd<HD>::THREADS;       \
      out[3] = Fwd<HD>::SMEM;                                                        \
    }                                                                                \
    return 0;                                                                        \
  } while (0)
  switch (hd) {
    case 32: WKV_GEOM(32);
    case 64: WKV_GEOM(64);
    case 128: WKV_GEOM(128);
    default: return -1;
  }
#undef WKV_GEOM
}

// Dynamic shared memory a block of each kernel takes at head_dim hd.
extern "C" int wkv_fwd_smem_bytes(int hd) {
  int g[4];
  return wkv_geometry(0, 1, 1, hd, g) == 0 ? g[3] : -1;
}
extern "C" int wkv_bwd_smem_bytes(int hd) {
  int g[4];
  return wkv_geometry(1, 1, 1, hd, g) == 0 ? g[3] : -1;
}
