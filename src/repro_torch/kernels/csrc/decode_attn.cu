// One-token GQA flash-decode attention, for sm_90a (K4).
//
// Replaces the TPU kernel src/repro/kernels/decode_attn.py:78
// (_decode_attn_kernel / decode_attn_pallas): for each batch row b and
// query head h = kv * G + g,
//   out[b, h] = softmax_s(q[b, h] . k[b, s, kv] / sqrt(hd)) @ v[b, s, kv]
// over the live positions s: with c = min(cache_len, limit), offset + s < c
// and, if window > 0, offset + s >= c - window. f32 logits and accumulator;
// the output is acc / max(l, 1e-30) in the inputs' type (f32 or bf16). With
// no live position it is zeros.
//
// Shard mode: k/v hold positions [offset, offset + S) of a cache split
// along its sequence (one rank's kvseq shard); limit is then past any
// cache_len, so the window is measured from the global cache_len, and a
// shard may hold no live position. With an lse buffer the output is f32
// and each row's log-sum-exp m + log l of its live logits goes beside it
// (-inf with none live), so that the ranks' rows merge without rounding.
// The unsharded call is offset 0, limit S, no lse.
//
// What bounds it on this card: bytes. Each K/V element read feeds one
// multiply-add per query head of its group, about 2 * G operations a byte
// in bf16, far under the ~295 at which the tensor cores would bind. At
// qwen2-vl-72b's decode (B 8, 2049 live positions, KV 8, hd 128) a call
// reads 67 MB: 20 us at 3.35 TB/s.
//
// What the design does about it:
// - One block per (split, kv head, b) holds all G query heads of the group,
//   as 16-row tiles (a group wider than two tiles at hd <= 128, or than one
//   at hd 256, takes more blocks, each re-reading the K/V). Every K/V byte
//   of the live range is read from device memory once.
// - K/V reach shared memory through a ring of >= 3 stages of TP positions
//   (64, or 32 where a row is 512 bytes or more), two blocks an SM. One
//   producer warp fills a stage with 16-byte asynchronous copies
//   (cp.async, 32 lanes at once) that complete on the stage's mbarrier
//   (cp.async.mbarrier.arrive); the consumer warps release the slot on
//   another. A bulk copy (cp.async.bulk) a 256-byte K or V row ran the ring
//   about 30% slower on an H100 (kernels.breakdown: bulk_rows_ring_only vs
//   ring_only). Rows land 16 bytes apart beyond their length, so ldmatrix
//   reads eight rows from eight distinct bank groups. The producer issues
//   the first stages before the block loads Q.
// - Each consumer warp takes 16 positions of every stage. In bf16, S = Q K^T
//   and O += P V run on the tensor cores (mma.sync m16n8k16, f32
//   accumulators): Q is the A operand (its rows padded to 16 with zeros),
//   K and V come through ldmatrix / ldmatrix.trans, and P's C fragments are
//   reused as the A fragment. P is split into bf16 hi + lo (two MMAs), so
//   its rounding error stays under 2^-16 of P. The online softmax runs on
//   the C fragments, once per row and 16 positions, the row's max taken
//   over the four lanes of a quad (two shuffles). In f32 the same fragments
//   come from CUDA-core fmaf over the shared-memory rows (no TF32).
// - One launch per call. The host picks the split count from S, B * KV and
//   the SM count (kernels.ops.decode_plan). With one split the block writes
//   the output; otherwise each writes an unnormalised partial (m, l, acc)
//   to f32 scratch, and the last block of its (b, kv head) to take a ticket
//   (an acq_rel atomicInc, which wraps the counter back to 0 for the next
//   call or graph replay) merges the splits: their partials come into its
//   ring by bulk copies while it weighs them, and it writes the output.
// - cache_len is read from device memory (no host sync); each block reads
//   only its share of the live range, so a local layer reads its window.
// - expf (not __expf), and the output acc * (1 / max(l, 1e-30)), so the plain
//   version stays within the stated tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>
#include <mutex>
#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kMaxStages = 8;
constexpr int kMaxSplits = 64;
constexpr int kMergeSlots = 3;
constexpr int kHeader = 256;  // mbarriers: 2 x kMaxStages (the ring), kMergeSlots (the merge); the flag

template <typename T, int HD>
struct Shape {
  static constexpr int kRowBytes = HD * (int)sizeof(T) + 16;  // a padded row in shared memory
  static constexpr int kTile = HD * (int)sizeof(T) <= 256 ? 64 : 32;  // positions a stage
  static constexpr int kConsumers = kTile / 16;  // consumer warps, 16 positions each
  static constexpr int kThreads = 32 * (kConsumers + 1);  // + the producer warp
  static constexpr int kStageBytes = 2 * kTile * kRowBytes;  // K rows, then V rows
  static constexpr int kChunks = HD * (int)sizeof(T) / 16;  // 16-byte pieces of a row
  static constexpr int kPBytes = std::is_same<T, float>::value ? kConsumers * 16 * 17 * 4 : 0;
};

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

// Byte offset of the ring: header, Q rows (RT * 16), P tiles (f32 only).
template <typename T, int HD>
__host__ __device__ constexpr int ring_offset(int rt) {
  return align128(kHeader + rt * 16 * Shape<T, HD>::kRowBytes + Shape<T, HD>::kPBytes);
}

// Floats of the consumer warps' merge, laid over the ring once it is
// free: their partials [CW][ROWS][HD + 4] and (m, l) [CW][ROWS][2].
template <typename T, int HD>
constexpr int merge_floats(int rows) {
  return Shape<T, HD>::kConsumers * rows * (HD + 6);
}

// Dynamic shared memory of a block: the ring, or the merges after it
// (whichever is larger).
template <typename T, int HD>
int smem_bytes(int rt, int stages) {
  const int ring = stages * Shape<T, HD>::kStageBytes;
  const int merge = 4 * merge_floats<T, HD>(rt * 16);
  return ring_offset<T, HD>(rt) + (ring > merge ? ring : merge);
}

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const int* cache_len;
  float* part_ml;     // (B, H, n_splits, 2): m, l
  float* part_acc;    // (B, H, n_splits, HD)
  unsigned* tickets;  // (B, KV, row_groups), 0 between calls
  void* out;          // (B, H, HD): T, or f32 with lse
  float* lse;         // (B, H) or null
  int S, H, KV, G, window, n_splits, stages, row_groups, offset, limit;
};

// ------------------------------------------------------------ PTX wrappers

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as bf16 hi + lo: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t* hi, uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = *reinterpret_cast<const uint32_t*>(&l);
}

using sm90::cp_async16;
using sm90::cp_async_arrive;

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

__device__ __forceinline__ float4 fma4(float w, float4 x, float4 y) {
  return make_float4(fmaf(w, x.x, y.x), fmaf(w, x.y, y.y), fmaf(w, x.z, y.z), fmaf(w, x.w, y.w));
}

// 4 consecutive outputs y * s (16- or 8-byte aligned), in the output's type
__device__ __forceinline__ void store_out4(float* p, float4 y, float s) {
  *reinterpret_cast<float4*>(p) = make_float4(y.x * s, y.y * s, y.z * s, y.w * s);
}
__device__ __forceinline__ void store_out4(__nv_bfloat16* p, float4 y, float s) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(y.x * s, y.y * s);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(y.z * s, y.w * s);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

// Output elements [i, i + 4): y * s, in T, or in f32 in shard mode
template <typename T>
__device__ __forceinline__ void store_out(const Args<T>& a, size_t i, float4 y, float s) {
  if (a.lse == nullptr) {
    store_out4(static_cast<T*>(a.out) + i, y, s);
  } else {
    store_out4(static_cast<float*>(a.out) + i, y, s);
  }
}

// ------------------------------------------------------------ one 16-position step

// S (16 rows x 16 positions) in the C-fragment layout of two m16n8 tiles:
// s[n][0..1] = row g, positions 8n + 2t + {0, 1}; s[n][2..3] = row g + 8.
// bf16: Q rows at q_s, K rows at k_s (shared-memory addresses, ROW bytes apart).
template <int HD, int ROW>
__device__ __forceinline__ void scores_bf16(uint32_t q_s, uint32_t k_s, int lane,
                                            float (&s)[2][4]) {
  const uint32_t qa = q_s + (((lane >> 3) & 1) * 8 + (lane & 7)) * ROW + (lane >> 4) * 16;
  const uint32_t ka = k_s + ((lane >> 4) * 8 + (lane & 7)) * ROW + ((lane >> 3) & 1) * 16;
  float t[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};  // odd k-steps: two shorter chains
#pragma unroll
  for (int k0 = 0; k0 < HD; k0 += 32) {
    uint32_t a[4], b[4], a2[4], b2[4];
    ldsm_x4(a, qa + k0 * 2);
    ldsm_x4(b, ka + k0 * 2);
    ldsm_x4(a2, qa + k0 * 2 + 32);
    ldsm_x4(b2, ka + k0 * 2 + 32);
    mma_bf16(s[0], a, b[0], b[1]);
    mma_bf16(s[1], a, b[2], b[3]);
    mma_bf16(t[0], a2, b2[0], b2[1]);
    mma_bf16(t[1], a2, b2[2], b2[3]);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[n][c] += t[n][c];
  }
}

// f32: the same fragments from fmaf over the rows (ROW bytes apart)
template <int HD, int ROW>
__device__ __forceinline__ void scores_f32(const float* q_s, const float* k_s, int lane,
                                           float (&s)[2][4]) {
  const int g = lane >> 2, t = lane & 3;
  const float* q0 = q_s + g * (ROW / 4);
  const float* q8 = q0 + 8 * (ROW / 4);
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float* kr = k_s + (8 * n + 2 * t + c) * (ROW / 4);
      float d0 = 0.f, d8 = 0.f;
#pragma unroll 8
      for (int e = 0; e < HD; e += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + e);
        const float4 a0 = *reinterpret_cast<const float4*>(q0 + e);
        const float4 a8 = *reinterpret_cast<const float4*>(q8 + e);
        d0 = fmaf(a0.x, kk.x, d0); d0 = fmaf(a0.y, kk.y, d0);
        d0 = fmaf(a0.z, kk.z, d0); d0 = fmaf(a0.w, kk.w, d0);
        d8 = fmaf(a8.x, kk.x, d8); d8 = fmaf(a8.y, kk.y, d8);
        d8 = fmaf(a8.z, kk.z, d8); d8 = fmaf(a8.w, kk.w, d8);
      }
      s[n][c] = d0;
      s[n][2 + c] = d8;
    }
  }
}

// Online softmax over one 16-position step of a 16-row tile: logits from s
// (positions >= n_live masked), the running max m and sum l of rows g and
// g + 8 (l is this lane's share; the quad's shares are added at the end),
// acc rescaled; s becomes P.
template <int HD>
__device__ __forceinline__ void softmax_step(float (&s)[2][4], int n_live, int lane,
                                             float (&m)[2], float (&l)[2],
                                             float (&acc)[HD / 8][4]) {
  const int t = lane & 3;
  const float sqrt_hd = sqrtf((float)HD);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool live = 8 * n + 2 * t + (c & 1) < n_live;
      s[n][c] = live ? s[n][c] / sqrt_hd : -INFINITY;
      mx[c >> 1] = fmaxf(mx[c >> 1], s[n][c]);
    }
  }
  float alpha[2], mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    mu[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing live yet stays at 0
    alpha[r] = expf(m[r] - mu[r]);
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[n][c] = expf(s[n][c] - mu[c >> 1]);
      sum[c >> 1] += s[n][c];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    acc[j][0] *= alpha[0];
    acc[j][1] *= alpha[0];
    acc[j][2] *= alpha[1];
    acc[j][3] *= alpha[1];
  }
}

// acc (16 rows x HD, C fragments of HD / 8 m16n8 tiles) += P V, bf16: P's
// fragments as the A operand, hi then lo; V rows at v_s via ldmatrix.trans
template <int HD, int ROW>
__device__ __forceinline__ void pv_bf16(const float (&p)[2][4], uint32_t v_s, int lane,
                                        float (&acc)[HD / 8][4]) {
  uint32_t hi[4], lo[4];
  split_bf16(p[0][0], p[0][1], &hi[0], &lo[0]);
  split_bf16(p[0][2], p[0][3], &hi[1], &lo[1]);
  split_bf16(p[1][0], p[1][1], &hi[2], &lo[2]);
  split_bf16(p[1][2], p[1][3], &hi[3], &lo[3]);
  const uint32_t va = v_s + (((lane >> 3) & 1) * 8 + (lane & 7)) * ROW + (lane >> 4) * 16;
#pragma unroll
  for (int n0 = 0; n0 < HD; n0 += 16) {
    uint32_t b[4];
    ldsm_x4_trans(b, va + n0 * 2);
    mma_bf16(acc[n0 / 8], hi, b[0], b[1]);
    mma_bf16(acc[n0 / 8], lo, b[0], b[1]);
    mma_bf16(acc[n0 / 8 + 1], hi, b[2], b[3]);
    mma_bf16(acc[n0 / 8 + 1], lo, b[2], b[3]);
  }
}

// f32: P through the warp's 16 x 17 tile in shared memory, then fmaf
template <int HD, int ROW>
__device__ __forceinline__ void pv_f32(const float (&p)[2][4], const float* v_s, float* pt,
                                       int lane, float (&acc)[HD / 8][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      pt[g * 17 + 8 * n + 2 * t + c] = p[n][c];
      pt[(g + 8) * 17 + 8 * n + 2 * t + c] = p[n][2 + c];
    }
  }
  __syncwarp();
#pragma unroll 2
  for (int j = 0; j < 16; ++j) {
    const float p0 = pt[g * 17 + j], p8 = pt[(g + 8) * 17 + j];
    const float* vr = v_s + j * (ROW / 4) + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const float2 vv = *reinterpret_cast<const float2*>(vr + 8 * n);
      acc[n][0] = fmaf(p0, vv.x, acc[n][0]);
      acc[n][1] = fmaf(p0, vv.y, acc[n][1]);
      acc[n][2] = fmaf(p8, vv.x, acc[n][2]);
      acc[n][3] = fmaf(p8, vv.y, acc[n][3]);
    }
  }
  __syncwarp();
}

// ------------------------------------------------------------ the kernel

// ------------------------------------------------------------ the merge of the splits

// atomicInc with release and acquire semantics at GPU scope: returns the old
// value and stores (old >= wrap ? 0 : old + 1)
__device__ __forceinline__ unsigned ticket_inc(unsigned* p, unsigned wrap) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;" : "=r"(old) : "l"(p), "r"(wrap) : "memory");
  return old;
}

// The last block of a (b, kv head, row group): merge the splits' partials
// and write the output. Its rows' acc partials (n_rows x n_splits x HD
// floats, contiguous) come into the free ring by one bulk copy a chunk, in
// thirds of the ring that complete on the three merge mbarriers: two chunks
// in flight while one is summed. A chunk is the whole rows a third holds,
// or, where one row does not fit, an even count of one row's splits. The
// (m, l) partials are read into shared memory meanwhile. A thread owns
// float4 columns of output rows and sums each row's splits in ascending
// order into two chains (alternate splits), added at the end.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void merge_splits(const Args<T>& a, unsigned char* ring, uint64_t* bars,
                                             int b, int h0, int n_rows) {
  using Sh = Shape<T, HD>;
  constexpr int NT = Sh::kThreads, NW = NT / 32, C4 = HD / 4;
  constexpr int MAXI = (ROWS * C4 + NT - 1) / NT;  // output float4s a thread owns
  constexpr int kFixed = (ROWS * kMaxSplits * 12 + ROWS * 4 + 15) / 16 * 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = a.n_splits;
  float2* ml_s = reinterpret_cast<float2*>(ring);                   // [ROWS][n]: (m, l)
  float* wts = reinterpret_cast<float*>(ml_s + ROWS * kMaxSplits);  // [ROWS][kMaxSplits]
  float* den = wts + ROWS * kMaxSplits;                             // [ROWS]: 1 / max(l, 1e-30)
  unsigned char* bufs = ring + kFixed;
  // three slots in the ring past the weights, each >= 2 splits of a row
  const int slot = (a.stages * Sh::kStageBytes - kFixed) / kMergeSlots / 16 * 16;
  const int rows_per = slot / (n * HD * 4);
  const int sp = rows_per > 0 ? n : slot / (HD * 4) / 2 * 2;
  const int parts = (n + sp - 1) / sp;
  const int chunks = rows_per > 0 ? (n_rows + rows_per - 1) / rows_per : n_rows * parts;
  const size_t base = ((size_t)b * a.H + h0) * n;  // the block's first (row, split)
  // chunk c: rows [r0, r1), splits [sa, sb) of each
  auto span = [&](int c, int* r0, int* r1, int* sa, int* sb) {
    if (rows_per > 0) {
      *r0 = c * rows_per, *r1 = min(*r0 + rows_per, n_rows), *sa = 0, *sb = n;
    } else {
      *r0 = c / parts, *r1 = *r0 + 1, *sa = (c % parts) * sp, *sb = min(*sa + sp, n);
    }
  };
  auto pull = [&](int c) {  // chunk c into slot c % 3
    if (threadIdx.x != 0 || c >= chunks) return;
    int r0, r1, sa, sb;
    span(c, &r0, &r1, &sa, &sb);
    sm90::bulk_load(bufs + (c % kMergeSlots) * slot, a.part_acc + (base + (size_t)r0 * n + sa) * HD,
                    (unsigned)(((r1 - r0 - 1) * n + sb - sa) * HD * 4), &bars[c % kMergeSlots]);
  };
  if (threadIdx.x == 0) asm volatile("fence.proxy.async;" ::: "memory");  // the splits' stores
  for (int c = 0; c < kMergeSlots - 1; ++c) pull(c);
  const float2* ml = reinterpret_cast<const float2*>(a.part_ml) + base;
  for (int i = threadIdx.x; i < n_rows * n; i += NT) ml_s[i] = __ldcg(ml + i);
  __syncthreads();
  // each split's weight exp(m - max m) and the rows' sums, a warp a row
  for (int r = warp; r < n_rows; r += NW) {
    const float2 x0 = lane < n ? ml_s[r * n + lane] : make_float2(-INFINITY, 0.f);
    const float2 x1 = lane + 32 < n ? ml_s[r * n + lane + 32] : make_float2(-INFINITY, 0.f);
    float M = fmaxf(x0.x, x1.x);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    const float w0 = x0.x == -INFINITY ? 0.f : expf(x0.x - M);
    const float w1 = x1.x == -INFINITY ? 0.f : expf(x1.x - M);
    float L = fmaf(w1, x1.y, w0 * x0.y);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
    wts[r * kMaxSplits + lane] = w0;
    wts[r * kMaxSplits + lane + 32] = w1;
    if (lane == 0) {
      den[r] = 1.f / fmaxf(L, 1e-30f);
      if (a.lse != nullptr) a.lse[(size_t)b * a.H + h0 + r] = M + logf(L);  // -inf with none live
    }
  }
  __syncthreads();

  float4 even[MAXI], odd[MAXI];
#pragma unroll
  for (int j = 0; j < MAXI; ++j) {
    even[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    odd[j] = even[j];
  }
  for (int c = 0; c < chunks; ++c) {
    pull(c + kMergeSlots - 1);  // its slot was freed by the sync ending chunk c - 1
    sm90::mbar_wait(&bars[c % kMergeSlots], (c / kMergeSlots) & 1);
    int r0, r1, sa, sb;
    span(c, &r0, &r1, &sa, &sb);
    const int m = sb - sa;
    const float4* buf = reinterpret_cast<const float4*>(bufs + (c % kMergeSlots) * slot);
    for (int s = 0; s < m; s += 2) {
#pragma unroll
      for (int j = 0; j < MAXI; ++j) {
        const int i = threadIdx.x + j * NT, r = i / C4, e = i % C4;
        if (r >= r1) break;
        if (r < r0) continue;
        const float* w = wts + r * kMaxSplits + sa + s;
        const float4* x = buf + ((r - r0) * m + s) * C4 + e;
        even[j] = fma4(w[0], x[0], even[j]);
        if (s + 1 < m) odd[j] = fma4(w[1], x[C4], odd[j]);
      }
    }
    __syncthreads();  // before slot c % 3 is refilled
  }
#pragma unroll
  for (int j = 0; j < MAXI; ++j) {
    const int i = threadIdx.x + j * NT, r = i / C4, e = i % C4 * 4;
    if (r >= n_rows) break;
    const float4 y = make_float4(even[j].x + odd[j].x, even[j].y + odd[j].y, even[j].z + odd[j].z,
                                 even[j].w + odd[j].w);
    store_out(a, ((size_t)b * a.H + h0 + r) * HD + e, y, den[r]);
  }
}

// Stage t of a block's share [s0, s1) of the live range into its ring slot:
// K rows then V rows, TP positions, 16 bytes a lane and copy. Rows past s1
// are zero-filled (no bytes read): P is 0 there, and 0 * NaN of stale bytes
// would not be. The slot's full barrier completes once the 32 lanes' copies
// have landed.
template <typename T, int HD>
__device__ __forceinline__ void stage_in(const Args<T>& a, unsigned char* ring, uint64_t* full,
                                         int b, int kv, int s0, int s1, int t, int lane) {
  using Sh = Shape<T, HD>;
  constexpr int TP = Sh::kTile, ROW = Sh::kRowBytes;
  const int slot = t % a.stages;
  const int p0 = s0 + t * TP;
  const int rows = min(TP, s1 - p0);
  unsigned char* k_d = ring + slot * Sh::kStageBytes;
  unsigned char* v_d = k_d + TP * ROW;
#pragma unroll 4
  for (int i = lane; i < TP * Sh::kChunks; i += 32) {
    const int r = i / Sh::kChunks, c = i % Sh::kChunks;
    const bool in = r < rows;
    const size_t off = ((((size_t)b * a.S + p0 + (in ? r : 0)) * a.KV + kv) * HD) * sizeof(T) + c * 16;
    cp_async16(k_d + r * ROW + c * 16, reinterpret_cast<const char*>(a.k) + off, in);
    cp_async16(v_d + r * ROW + c * 16, reinterpret_cast<const char*>(a.v) + off, in);
  }
  cp_async_arrive(&full[slot]);
}

// Block (split, kv head x row group, b). RT row tiles of 16 query heads.
template <typename T, int HD, int RT>
__global__ void __launch_bounds__(Shape<T, HD>::kThreads, 2)
decode_attn_kernel(const Args<T> a) {
  using Sh = Shape<T, HD>;
  constexpr int TP = Sh::kTile, CW = Sh::kConsumers, ROW = Sh::kRowBytes;
  constexpr int ROWS = RT * 16;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  uint64_t* merge_bars = empty + kMaxStages;
  int* flag = reinterpret_cast<int*>(merge_bars + kMergeSlots);
  unsigned char* q_s = smem + kHeader;
  float* p_tiles = reinterpret_cast<float*>(q_s + ROWS * ROW);  // f32 only
  unsigned char* ring = smem + ring_offset<T, HD>(RT);

  const int split = blockIdx.x;
  const int kv = blockIdx.y / a.row_groups, grp = blockIdx.y % a.row_groups;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h0 = kv * a.G + grp * ROWS;          // the block's first query head
  const int n_rows = min(ROWS, a.G - grp * ROWS);  // its heads; rows past them are zeros

  // live positions [lo, hi) of this shard and this split's share [s0, s1)
  const int c = min(__ldg(a.cache_len), a.limit);
  const int hi = min(c - a.offset, a.S);
  const int lo = a.window > 0 ? max(c - a.window - a.offset, 0) : 0;
  const int live = max(hi - lo, 0);
  const int chunk = ((live + a.n_splits - 1) / a.n_splits + 15) / 16 * 16;
  const int s0 = lo + split * chunk;
  const int s1 = min(s0 + chunk, hi);
  const int n_tiles = s0 < s1 ? (s1 - s0 + TP - 1) / TP : 0;

  if (warp == CW) {
    // producer: the first stages go out while the consumers load Q
    if (lane == 0) {
      for (int s = 0; s < a.stages; ++s) {
        sm90::mbar_init(&full[s], 32);
        sm90::mbar_init(&empty[s], CW);
      }
      for (int s = 0; s < kMergeSlots; ++s) sm90::mbar_init(&merge_bars[s], 1);
      sm90::fence_mbar_init();
    }
    __syncwarp();
    for (int t = 0; t < min(n_tiles, a.stages); ++t) stage_in<T, HD>(a, ring, full, b, kv, s0, s1, t, lane);
  } else {
    for (int i = threadIdx.x; i < ROWS * Sh::kChunks; i += CW * 32) {
      const int r = i / Sh::kChunks, c = i % Sh::kChunks;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (r < n_rows) {
        x = __ldg(reinterpret_cast<const uint4*>(a.q + ((size_t)b * a.H + h0 + r) * HD) + c);
      }
      *reinterpret_cast<uint4*>(q_s + r * ROW + c * 16) = x;
    }
  }
  __syncthreads();

  float acc[RT][HD / 8][4];
  float m[RT][2], l[RT][2];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) acc[r][j][0] = acc[r][j][1] = acc[r][j][2] = acc[r][j][3] = 0.f;
    m[r][0] = m[r][1] = -INFINITY;
    l[r][0] = l[r][1] = 0.f;
  }

  if (warp == CW) {
    // stage t into slot t % stages once the consumers released stage
    // t - stages there
    for (int t = a.stages; t < n_tiles; ++t) {
      sm90::mbar_wait(&empty[t % a.stages], (t / a.stages - 1) & 1);
      stage_in<T, HD>(a, ring, full, b, kv, s0, s1, t, lane);
    }
    cp_async_wait_all();
  } else {
    // consumer warp: positions [16 warp, 16 warp + 16) of every stage
    for (int t = 0; t < n_tiles; ++t) {
      const int slot = t % a.stages;
      sm90::mbar_wait(&full[slot], (t / a.stages) & 1);
      const int n_live = s1 - (s0 + t * TP + 16 * warp);
      if (n_live > 0) {
        unsigned char* k_s = ring + slot * Sh::kStageBytes + 16 * warp * ROW;
        unsigned char* v_s = k_s + TP * ROW;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          if constexpr (kBf16) {
            scores_bf16<HD, ROW>(sm90::smem_u32(q_s + r * 16 * ROW), sm90::smem_u32(k_s), lane, s);
          } else {
            scores_f32<HD, ROW>(reinterpret_cast<const float*>(q_s + r * 16 * ROW),
                                reinterpret_cast<const float*>(k_s), lane, s);
          }
          softmax_step<HD>(s, n_live, lane, m[r], l[r], acc[r]);
          if constexpr (kBf16) {
            pv_bf16<HD, ROW>(s, sm90::smem_u32(v_s), lane, acc[r]);
          } else {
            pv_f32<HD, ROW>(s, reinterpret_cast<const float*>(v_s), p_tiles + warp * 16 * 17, lane,
                            acc[r]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[slot]);
    }
  }
  __syncthreads();  // every stage landed and was read: the ring is free

  // merge the consumer warps' partials, in the ring's bytes (merge_floats)
  float* m_acc = reinterpret_cast<float*>(ring);      // [CW][ROWS][HD + 4]
  float* m_ml = m_acc + CW * ROWS * (HD + 4);         // [CW][ROWS][2]
  if (warp < CW) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float* row0 = m_acc + (warp * ROWS + r * 16 + g) * (HD + 4) + 2 * t;
      float* row8 = row0 + 8 * (HD + 4);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<float2*>(row0 + 8 * j) = make_float2(acc[r][j][0], acc[r][j][1]);
        *reinterpret_cast<float2*>(row8 + 8 * j) = make_float2(acc[r][j][2], acc[r][j][3]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float li = l[r][i];
        li += __shfl_xor_sync(0xffffffffu, li, 1);
        li += __shfl_xor_sync(0xffffffffu, li, 2);
        if (t == 0) {
          float* ml = m_ml + (warp * ROWS + r * 16 + g + 8 * i) * 2;
          ml[0] = m[r][i];
          ml[1] = li;
        }
      }
    }
  }
  __syncthreads();
  // each thread weighs the warps' partials of its rows, exp(m_w - M); a
  // warp (or split) that saw no live position has m = -inf, l = 0, acc = 0
  // and weight 0
  for (int i = threadIdx.x; i < n_rows * HD / 4; i += Sh::kThreads) {
    const int r = i / (HD / 4), e = i % (HD / 4) * 4;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < CW; ++w) M = fmaxf(M, m_ml[(w * ROWS + r) * 2]);
    float L = 0.f;
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < CW; ++w) {
      const float mw = m_ml[(w * ROWS + r) * 2];
      const float wt = mw == -INFINITY ? 0.f : expf(mw - M);
      L = fmaf(wt, m_ml[(w * ROWS + r) * 2 + 1], L);
      y = fma4(wt, *reinterpret_cast<const float4*>(m_acc + (w * ROWS + r) * (HD + 4) + e), y);
    }
    if (a.n_splits == 1) {
      const size_t row = (size_t)b * a.H + h0 + r;
      store_out(a, row * HD + e, y, 1.f / fmaxf(L, 1e-30f));
      if (e == 0 && a.lse != nullptr) a.lse[row] = M + logf(L);  // -inf with none live
    } else {
      const size_t row = ((size_t)b * a.H + h0 + r) * a.n_splits + split;
      *reinterpret_cast<float4*>(a.part_acc + row * HD + e) = y;
      if (e == 0) {
        a.part_ml[row * 2] = M;
        a.part_ml[row * 2 + 1] = L;
      }
    }
  }
  if (a.n_splits == 1) return;

  // the last block of (b, kv head, row group) to finish merges the splits:
  // the ticket releases this block's partials (its threads' stores are
  // ordered before it by the barrier) and acquires the others'
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* ticket = a.tickets + ((size_t)b * a.KV + kv) * a.row_groups + grp;
    *flag = ticket_inc(ticket, (unsigned)(a.n_splits - 1)) == (unsigned)(a.n_splits - 1);
  }
  __syncthreads();
  if (!*flag) return;
  merge_splits<T, HD, ROWS>(a, ring, merge_bars, b, h0, n_rows);
}

// ------------------------------------------------------------ host side

template <typename T, int HD, int RT>
cudaError_t launch_rt(const Args<T>& a, int B, int smem, cudaStream_t st) {
  if (smem != smem_bytes<T, HD>(RT, a.stages)) return cudaErrorInvalidValue;
  const dim3 grid(a.n_splits, a.KV * a.row_groups, B);
  decode_attn_kernel<T, HD, RT><<<grid, Shape<T, HD>::kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(const Args<T>& a, int B, int rt, int smem, cudaStream_t st) {
  if (rt == 1) return launch_rt<T, HD, 1>(a, B, smem, st);
  if constexpr (HD <= 128) {
    if (rt == 2) return launch_rt<T, HD, 2>(a, B, smem, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_t(const Args<T>& a, int B, int hd, int rt, int smem, cudaStream_t st) {
  switch (hd) {
    case 32: return launch_hd<T, 32>(a, B, rt, smem, st);
    case 64: return launch_hd<T, 64>(a, B, rt, smem, st);
    case 128: return launch_hd<T, 128>(a, B, rt, smem, st);
    case 256: return launch_hd<T, 256>(a, B, rt, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int smem_t(int hd, int rt, int stages) {
  switch (hd) {
    case 32: return smem_bytes<T, 32>(rt, stages);
    case 64: return smem_bytes<T, 64>(rt, stages);
    case 128: return smem_bytes<T, 128>(rt, stages);
    case 256: return smem_bytes<T, 256>(rt, stages);
    default: return -1;
  }
}

// Per device, at its first launch: every instantiation may take the shared
// memory a block may opt into.
bool g_ready[sm90::kMaxDevices];
std::mutex g_mu;

template <typename T, int HD>
cudaError_t allow_hd(int max_smem) {
  cudaError_t err = cudaFuncSetAttribute(decode_attn_kernel<T, HD, 1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if constexpr (HD <= 128) {
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(decode_attn_kernel<T, HD, 2>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    }
  }
  return err;
}

template <typename T>
cudaError_t allow_t(int max_smem) {
  cudaError_t err = allow_hd<T, 32>(max_smem);
  if (err == cudaSuccess) err = allow_hd<T, 64>(max_smem);
  if (err == cudaSuccess) err = allow_hd<T, 128>(max_smem);
  if (err == cudaSuccess) err = allow_hd<T, 256>(max_smem);
  return err;
}

cudaError_t prepare(int dev) {
  if (dev < 0 || dev >= sm90::kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_ready[dev]) return cudaSuccess;
  int max_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = allow_t<__nv_bfloat16>(max_smem);
  if (err == cudaSuccess) err = allow_t<float>(max_smem);
  if (err == cudaSuccess) g_ready[dev] = true;
  return err;
}

}  // namespace

// Dynamic shared memory of a block of the kernel for (hd, type, rt row
// tiles, stages), or -1 for an hd it does not take: what
// kernels.ops.decode_plan must compute.
extern "C" int decode_attn_smem_bytes(int hd, int is_bf16, int rt, int stages) {
  return is_bf16 ? smem_t<__nv_bfloat16>(hd, rt, stages) : smem_t<float>(hd, rt, stages);
}

// q (B, H, hd), k/v (B, S, KV, hd), out (B, H, hd), all of one type: bf16
// if is_bf16 else f32, contiguous, 16-byte aligned; with lse (B, H) f32 not
// null (shard mode), out is f32. cache_len: one int32 in device memory,
// taken as min(cache_len, limit); k/v hold the cache's positions
// [offset, offset + S). Scratch, f32: part_ml (B, H, n_splits, 2) and part_acc
// (B, H, n_splits, hd), not read before written; tickets: B * KV *
// row_groups uint32 that are 0, and are 0 again when the kernel ends. The
// plan (n_splits, stages, rt row tiles a block, row_groups blocks a kv
// head, smem bytes) is kernels.ops.decode_plan's; smem must equal
// decode_attn_smem_bytes. `device` is the current CUDA device. One launch
// on `stream`.
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const void* cache_len, void* part_ml, void* part_acc,
                                  void* tickets, void* out, void* lse, int B, int S, int H, int KV,
                                  int hd, int is_bf16, int window, int offset, int limit,
                                  int n_splits, int stages, int rt, int row_groups, int smem,
                                  int device, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || n_splits <= 0 || n_splits > kMaxSplits ||
      stages < 2 || stages > kMaxStages || row_groups <= 0 || rt * 16 * row_groups < H / KV) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = prepare(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  if (is_bf16) {
    using T = __nv_bfloat16;
    const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                    static_cast<const int*>(cache_len), static_cast<float*>(part_ml),
                    static_cast<float*>(part_acc), static_cast<unsigned*>(tickets), out,
                    static_cast<float*>(lse), S, H, KV, G, window, n_splits, stages, row_groups,
                    offset, limit};
    return (int)launch_t<T>(a, B, hd, rt, smem, st);
  }
  const Args<float> a{static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<const int*>(cache_len),
                      static_cast<float*>(part_ml), static_cast<float*>(part_acc),
                      static_cast<unsigned*>(tickets), out, static_cast<float*>(lse), S, H, KV,
                      G, window, n_splits, stages, row_groups, offset, limit};
  return (int)launch_t<float>(a, B, hd, rt, smem, st);
}
