// One-token GQA flash-decode attention, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/decode_attn.py
// (_decode_attn_kernel / decode_attn_pallas): for each batch row b and
// query head h = kv * G + g,
//   out[b, h] = softmax_s(q[b, h] . k[b, s, kv] / sqrt(hd)) @ v[b, s, kv]
// over the live positions s: s < cache_len and, if window > 0,
// s >= cache_len - window. f32 logits and accumulator; the output is
// written in the inputs' type (f32 or bf16).
//
// What bounds it on this card: bytes. Each K/V element read feeds about one
// multiply-add per query head of its group (G = 2 at gemma3-4b), so at
// B = 8, S = 2112, KV = 4, hd = 256 in bf16 a global layer reads ~69 MB
// (~21 us at 3.35 TB/s) for ~0.14 GFLOP.
//
// What the design does about it:
// - The TPU kernel walks the S blocks of one batch row in order on one
//   core, carrying (max, sum, acc) in VMEM. Here the live range is split
//   across blocks that run in parallel (split-K flash decoding): block
//   (split, kv head, b) holds the G query heads of its group in registers,
//   reads its share of K/V once, and writes an unnormalised partial
//   (m, l, acc[hd]) per head to f32 scratch. A second small kernel merges
//   the splits and writes the output. The wrapper picks the split count
//   so that a few hundred blocks are in flight on the 132 SMs.
// - Only the live range is read: cache_len is read from device memory (no
//   host sync) and each block computes lo/hi itself, so a local layer
//   reads its 1024-position window, not the whole cache. The TPU kernel
//   read every block and masked; the result is the same.
// - Loads are 16 bytes a lane for hd = 256 in bf16 (8 values), a warp
//   reading one position's contiguous hd-row; each warp keeps 4 positions'
//   K and V rows in flight per step of its loop.
// - expf (not __expf) and f32 throughout, so the plain version stays within
//   the stated tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPPW = 4;                 // positions per warp per loop step
constexpr int kTile = kWarps * kPPW;    // positions per block per loop step

// EPL consecutive elements at p (this lane's slice of an hd-row) as f32.
template <int EPL>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float (&x)[EPL]) {
  if constexpr (EPL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < EPL; i += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
      x[i] = t.x; x[i + 1] = t.y; x[i + 2] = t.z; x[i + 3] = t.w;
    }
  } else if constexpr (EPL == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = __ldg(p);
  }
}

// EPL bf16 values (2 * EPL bytes) come in one 16-, 8- or 4-byte load
template <int EPL> struct Bf16Raw;
template <> struct Bf16Raw<8> { using type = uint4; };
template <> struct Bf16Raw<4> { using type = uint2; };
template <> struct Bf16Raw<2> { using type = unsigned int; };

template <int EPL>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p, float (&x)[EPL]) {
  if constexpr (EPL == 1) {
    x[0] = __bfloat162float(p[0]);
  } else {
    using Raw = typename Bf16Raw<EPL>::type;
    const Raw raw = __ldg(reinterpret_cast<const Raw*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < EPL / 2; ++i) {
      x[2 * i] = __bfloat162float(h[i].x);
      x[2 * i + 1] = __bfloat162float(h[i].y);
    }
  }
}

__device__ __forceinline__ void store_out(float* p, float y) { *p = y; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float y) { *p = __float2bfloat16(y); }

// Live positions [lo, hi) of a cache holding cache_len (clamped to S)
// entries, and this split's share [s0, s1) of them (empty if s0 >= s1).
__device__ __forceinline__ void split_range(const int* __restrict__ cache_len, int S, int window,
                                            int n_splits, int split, int* s0, int* s1) {
  const int hi = min(__ldg(cache_len), S);
  const int lo = window > 0 ? max(hi - window, 0) : 0;
  const int live = max(hi - lo, 0);
  int chunk = (live + n_splits - 1) / n_splits;
  chunk = (chunk + kTile - 1) / kTile * kTile;
  *s0 = lo + split * chunk;
  *s1 = min(*s0 + chunk, hi);
}

// Block (split, kv-head x head-tile, b): GT query heads of one kv head over
// one split of the live range. Partials go to part_{m,l} (B, H, n_splits)
// and part_acc (B, H, n_splits, HD), unnormalised.
template <typename T, int HD, int GT>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ cache_len, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc, int S, int H,
                    int KV, int window, int n_splits) {
  constexpr int EPL = HD / 32;
  const int split = blockIdx.x;
  const int G = H / KV;
  const int n_gt = G / GT;
  const int kvh = blockIdx.y / n_gt;
  const int h0 = kvh * G + (blockIdx.y % n_gt) * GT;  // first query head of the tile
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  int s0, s1;
  split_range(cache_len, S, window, n_splits, split, &s0, &s1);

  float qr[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    float t[EPL];
    load_row<EPL>(q + ((size_t)b * H + h0 + g) * HD + lane * EPL, t);
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] = t[e];
  }

  float m[GT], l[GT], acc[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const float sqrt_hd = sqrtf((float)HD);
  const size_t pos_stride = (size_t)KV * HD;  // elements between positions
  const size_t base = ((size_t)b * S * KV + kvh) * HD + lane * EPL;

  for (int t0 = s0 + warp * kPPW; t0 < s1; t0 += kTile) {
    float kf[kPPW][EPL], vf[kPPW][EPL];
#pragma unroll
    for (int j = 0; j < kPPW; ++j) {
      const int s = min(t0 + j, s1 - 1);  // past the end: reread the last row, masked below
      load_row<EPL>(k + base + (size_t)s * pos_stride, kf[j]);
      load_row<EPL>(v + base + (size_t)s * pos_stride, vf[j]);
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float x[kPPW];
#pragma unroll
      for (int j = 0; j < kPPW; ++j) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qr[g][e], kf[j][e], d);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        x[j] = t0 + j < s1 ? d / sqrt_hd : -INFINITY;
      }
      float m_new = m[g];
#pragma unroll
      for (int j = 0; j < kPPW; ++j) m_new = fmaxf(m_new, x[j]);
      // x[0] is live (t0 < s1), so m_new is finite and expf(-inf) = 0
      const float alpha = expf(m[g] - m_new);
      float p[kPPW], psum = 0.f;
#pragma unroll
      for (int j = 0; j < kPPW; ++j) {
        p[j] = expf(x[j] - m_new);
        psum += p[j];
      }
      l[g] = l[g] * alpha + psum;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int j = 0; j < kPPW; ++j) a = fmaf(p[j], vf[j][e], a);
        acc[g][e] = a;
      }
      m[g] = m_new;
    }
  }

  // merge the block's warps; a warp (or split) that saw no live position
  // has m = -inf, l = 0, acc = 0 and gets weight 0
  __shared__ float sm_m[kWarps][GT], sm_l[kWarps][GT];
  __shared__ float sm_acc[kWarps][GT][HD];
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][g][lane * EPL + e] = acc[g][e];
  __syncthreads();
  for (int i = threadIdx.x; i < GT * HD; i += kThreads) {
    const int g = i / HD, e = i % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float a = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm_m[w][g];
      const float wt = mw == -INFINITY ? 0.f : expf(mw - M);
      a = fmaf(wt, sm_acc[w][g][e], a);
      L = fmaf(wt, sm_l[w][g], L);
    }
    const size_t row = ((size_t)b * H + h0 + g) * n_splits + split;
    part_acc[row * HD + e] = a;
    if (e == 0) {
      part_m[row] = M;
      part_l[row] = L;
    }
  }
}

// Block per (b, h), one thread per output element: merge the splits and
// finish as the reference does, acc / max(l, 1e-30).
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
decode_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, T* __restrict__ out, int n_splits) {
  const size_t row = blockIdx.x;
  const int e = threadIdx.x;
  const float* pm = part_m + row * n_splits;
  const float* pl = part_l + row * n_splits;
  const float* pa = part_acc + row * n_splits * HD + e;
  float M = -INFINITY;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, pm[s]);
  float a = 0.f, L = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float ms = pm[s];
    const float wt = ms == -INFINITY ? 0.f : expf(ms - M);
    a = fmaf(wt, pa[(size_t)s * HD], a);
    L = fmaf(wt, pl[s], L);
  }
  store_out(out + row * HD + e, a / fmaxf(L, 1e-30f));
}

// Query heads per block: the most of 8, 4, 2, 1 that divides G and keeps
// GT * HD / 32 accumulators a lane within 32 registers.
template <typename T, int HD>
cudaError_t launch_hd(const T* q, const T* k, const T* v, const int* cache_len, float* part_m,
                      float* part_l, float* part_acc, T* out, int B, int S, int H, int KV,
                      int window, int n_splits, cudaStream_t stream) {
  constexpr int EPL = HD / 32;
  const int G = H / KV;
  int gt = 1;
  for (int c = 8; c > 1; c >>= 1) {
    if (G % c == 0 && c * EPL <= 32) {
      gt = c;
      break;
    }
  }
  const dim3 grid(n_splits, KV * (G / gt), B);
  switch (gt) {
    case 8:
      if constexpr (8 * EPL <= 32) {
        decode_split_kernel<T, HD, 8><<<grid, kThreads, 0, stream>>>(
            q, k, v, cache_len, part_m, part_l, part_acc, S, H, KV, window, n_splits);
      } else {
        return cudaErrorInvalidValue;  // not reached: gt * EPL <= 32
      }
      break;
    case 4:
      decode_split_kernel<T, HD, 4><<<grid, kThreads, 0, stream>>>(
          q, k, v, cache_len, part_m, part_l, part_acc, S, H, KV, window, n_splits);
      break;
    case 2:
      decode_split_kernel<T, HD, 2><<<grid, kThreads, 0, stream>>>(
          q, k, v, cache_len, part_m, part_l, part_acc, S, H, KV, window, n_splits);
      break;
    default:
      decode_split_kernel<T, HD, 1><<<grid, kThreads, 0, stream>>>(
          q, k, v, cache_len, part_m, part_l, part_acc, S, H, KV, window, n_splits);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, HD><<<B * H, HD, 0, stream>>>(part_m, part_l, part_acc, out, n_splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, const int* cache_len,
                     float* part_m, float* part_l, float* part_acc, void* out, int B, int S,
                     int H, int KV, int hd, int window, int n_splits, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  switch (hd) {
    case 32:
      return launch_hd<T, 32>(qt, kt, vt, cache_len, part_m, part_l, part_acc, ot, B, S, H, KV,
                              window, n_splits, stream);
    case 64:
      return launch_hd<T, 64>(qt, kt, vt, cache_len, part_m, part_l, part_acc, ot, B, S, H, KV,
                              window, n_splits, stream);
    case 128:
      return launch_hd<T, 128>(qt, kt, vt, cache_len, part_m, part_l, part_acc, ot, B, S, H, KV,
                               window, n_splits, stream);
    case 256:
      return launch_hd<T, 256>(qt, kt, vt, cache_len, part_m, part_l, part_acc, ot, B, S, H, KV,
                               window, n_splits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, hd), k/v (B, S, KV, hd), out (B, H, hd), all of one type: bf16
// if is_bf16 else f32, contiguous, 16-byte aligned. cache_len: one int32 in
// device memory. Scratch: part_m/part_l (B, H, n_splits), part_acc
// (B, H, n_splits, hd), f32. Launches the split kernel and the combine
// kernel on `stream`.
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const void* cache_len, void* part_m, void* part_l,
                                  void* part_acc, void* out, int B, int S, int H, int KV, int hd,
                                  int is_bf16, int window, int n_splits, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || n_splits <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int* cl = static_cast<const int*>(cache_len);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return (int)launch_t<__nv_bfloat16>(q, k, v, cl, pm, pl, pa, out, B, S, H, KV, hd, window,
                                        n_splits, st);
  }
  return (int)launch_t<float>(q, k, v, cl, pm, pl, pa, out, B, S, H, KV, hd, window, n_splits,
                              st);
}
