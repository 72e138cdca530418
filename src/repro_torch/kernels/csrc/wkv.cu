// rwkv6's wkv recurrence, forward and backward, for sm_90a.
//
// Replaces no Pallas kernel. The reference runs the recurrence as one
// jax.lax.scan (src/repro/nn/ssm.py:238, over the step at :225-230), a loop
// that stays on the device; the port's plain version (kernels/ref.py
// wkv_ref) is a Python loop of T steps a layer, whose host time bound the
// rwkv6 prefill and train step on the card. For each batch row b and head
// h, in f32, from S_0:
//   y_t[j] = sum_i r_t[i] (S[i,j] + u[i] k_t[i] v_t[j])
//   S[i,j] <- w_t[i] S[i,j] + k_t[i] v_t[j]
// r, k, v, w and y are (B, T, H, hd), u (H, hd), S (B, H, hd, hd).
//
// What bounds it on this card: bytes. A call reads r, k, v, w and writes y,
// B*T*H*hd*4 bytes each (x 5), plus the states; the forward does ~4 hd^2
// FLOPs a step and head (the backward ~10 hd^2), about hd/5 FLOPs a byte,
// under the ~20 at which the f32 rate (67 TFLOP/s over 3.35 TB/s) binds.
// The recurrence is sequential in T: only B*H*hd state columns (rows in
// the backward) can run side by side.
//
// What the design does about it (a simple first design):
// - Forward: one block per (b, h) of hd * P threads. The P = 4 adjacent
//   lanes of a column j share it, each holding rows i = ii*P + p of S[:, j]
//   in registers, so the P lanes read 4 consecutive floats of a staged
//   vector (no bank conflict) and sum y_t[j] by two shuffles. A chunk of
//   C = 16 steps of r, k, v, w comes into shared memory by 16-byte loads of
//   all threads, one barrier a chunk; y of the chunk is staged there and
//   written out by 16-byte stores. When asked, the state before every C-th
//   step is saved (ckpt, (B, H, ceil(T/C), hd, hd)) for the backward.
// - Backward: grid (b*h, 2). Both halves run the carried gradient G = dL/dS_t
//   backwards in time from g(S_T), G <- w_t G + r_t gy_t^T, each in the
//   layout in which its sums stay in a thread and its P lanes:
//   * rows (blockIdx.y 0): thread (i, p) holds G[i, j] for j = jj*P + p and,
//     chunk by chunk from the last, recomputes S_{t-1}[i, j] from the saved
//     state (the forward's own arithmetic, so the same bits) into a
//     per-thread history of C steps (local memory); then, t descending,
//       gr_t[i] = sum_j gy_t[j] S_{t-1}[i,j] + u[i] k_t[i] (v_t . gy_t)
//       gk_t[i] = sum_j G_t[i,j] v_t[j]      + u[i] r_t[i] (v_t . gy_t)
//       gw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//       gu[i]  += r_t[i] k_t[i] (v_t . gy_t)  (a partial per (b, h))
//     and gS_0 = G_0. S_{t-1} is never recovered by dividing by w.
//   * columns (blockIdx.y 1): thread (j, p) holds G[i, j] for i = ii*P + p:
//       gv_t[j] = sum_i G_t[i,j] k_t[i] + gy_t[j] (r_t . (u * k_t))
//   Each stages r, k, v, w and gy of a chunk as the forward does.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kP = 4;   // lanes sharing a state column (forward, gv) or row (gr, gk, gw)
constexpr int kC = 16;  // steps a chunk; the forward saves the state every kC steps

// Steps [t0, t0 + len) of N (B, T, H, HD) tensors at one (b, h) into
// dst[n][0..len): ``base`` is step t0's offset, ``stride`` a step's.
template <int HD, int N>
__device__ __forceinline__ void stage(float (*dst)[kC][HD], const float* const (&src)[N],
                                      size_t base, size_t stride, int len) {
  constexpr int Q = HD / 4;  // float4s a vector
  const int n_vec = len * Q;
  for (int e = threadIdx.x; e < N * n_vec; e += blockDim.x) {
    const int n = e / n_vec, rest = e - n * n_vec, tt = rest / Q, q = rest - tt * Q;
    reinterpret_cast<float4*>(dst[n][tt])[q] =
        *reinterpret_cast<const float4*>(src[n] + base + (size_t)tt * stride + 4 * q);
  }
}

__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int m = 1; m < kP; m <<= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(HD * kP)
wkv_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ s0,
               float* __restrict__ y, float* __restrict__ s_out, float* __restrict__ ckpt,
               int T, int H) {
  constexpr int NI = HD / kP;
  __shared__ __align__(16) float xs[4][kC][HD];  // r, k, v, w of the chunk
  __shared__ __align__(16) float ys[kC][HD];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j = threadIdx.x / kP, p = threadIdx.x % kP;
  const size_t stride = (size_t)H * HD, base = ((size_t)b * T * H + h) * HD;
  const float* const src[4] = {r, k, v, w};
  float S[NI], uu[NI];
  const float* sb = s0 + (size_t)bh * HD * HD;
#pragma unroll
  for (int ii = 0; ii < NI; ++ii) {
    S[ii] = sb[(ii * kP + p) * HD + j];
    uu[ii] = u[h * HD + ii * kP + p];
  }
  const int chunks = (T + kC - 1) / kC;
  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * kC, len = min(kC, T - t0);
    if (ckpt != nullptr) {  // the state before step t0
      float* cb = ckpt + ((size_t)bh * chunks + c) * HD * HD;
#pragma unroll
      for (int ii = 0; ii < NI; ++ii) cb[(ii * kP + p) * HD + j] = S[ii];
    }
    __syncthreads();  // the last chunk's reads of xs and ys are done
    stage<HD, 4>(xs, src, base + (size_t)t0 * stride, stride, len);
    __syncthreads();
    for (int tt = 0; tt < len; ++tt) {
      const float vj = xs[2][tt][j];
      float acc = 0.f;
#pragma unroll
      for (int ii = 0; ii < NI; ++ii) {
        const int i = ii * kP + p;
        const float kv = xs[1][tt][i] * vj;
        acc = fmaf(xs[0][tt][i], fmaf(uu[ii], kv, S[ii]), acc);
        S[ii] = fmaf(xs[3][tt][i], S[ii], kv);
      }
      acc = lanes_sum(acc);
      if (p == 0) ys[tt][j] = acc;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < len * (HD / 4); e += blockDim.x) {
      const int tt = e / (HD / 4), q = e - tt * (HD / 4);
      *reinterpret_cast<float4*>(y + base + (size_t)(t0 + tt) * stride + 4 * q) =
          reinterpret_cast<const float4*>(ys[tt])[q];
    }
  }
  float* so = s_out + (size_t)bh * HD * HD;
#pragma unroll
  for (int ii = 0; ii < NI; ++ii) so[(ii * kP + p) * HD + j] = S[ii];
}

template <int HD>
__global__ void __launch_bounds__(HD * kP)
wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ ckpt,
               const float* __restrict__ gy, const float* __restrict__ gs,
               float* __restrict__ gr, float* __restrict__ gk, float* __restrict__ gv,
               float* __restrict__ gw, float* __restrict__ gu_part, float* __restrict__ gs0,
               int T, int H) {
  constexpr int N = HD / kP;
  __shared__ __align__(16) float xs[5][kC][HD];  // r, k, v, w, gy of the chunk
  const int bh = blockIdx.x, h = bh % H, b = bh / H;
  const int row = threadIdx.x / kP, p = threadIdx.x % kP;
  const size_t stride = (size_t)H * HD, base = ((size_t)b * T * H + h) * HD;
  const float* const src[5] = {r, k, v, w, gy};
  const float* gsb = gs == nullptr ? nullptr : gs + (size_t)bh * HD * HD;
  const int chunks = (T + kC - 1) / kC;
  if (blockIdx.y == 0) {  // rows: gr, gk, gw, gu, gS_0
    const int i = row;
    const float ui = u[h * HD + i];
    float G[N], hist[kC][N];  // hist: S before each step of the chunk
#pragma unroll
    for (int jj = 0; jj < N; ++jj) G[jj] = gsb == nullptr ? 0.f : gsb[i * HD + jj * kP + p];
    float gu_acc = 0.f;
    for (int c = chunks - 1; c >= 0; --c) {
      const int t0 = c * kC, len = min(kC, T - t0);
      __syncthreads();
      stage<HD, 5>(xs, src, base + (size_t)t0 * stride, stride, len);
      __syncthreads();
      const float* cb = ckpt + ((size_t)bh * chunks + c) * HD * HD + (size_t)i * HD;
      float S[N];
#pragma unroll
      for (int jj = 0; jj < N; ++jj) S[jj] = cb[jj * kP + p];
      for (int tt = 0; tt < len; ++tt) {  // the forward's arithmetic: the same S bits
        const float ki = xs[1][tt][i], wi = xs[3][tt][i];
#pragma unroll
        for (int jj = 0; jj < N; ++jj) {
          hist[tt][jj] = S[jj];
          S[jj] = fmaf(wi, S[jj], ki * xs[2][tt][jj * kP + p]);
        }
      }
      for (int tt = len - 1; tt >= 0; --tt) {
        const float ri = xs[0][tt][i], ki = xs[1][tt][i], wi = xs[3][tt][i];
        float a = 0.f, bb = 0.f, cc = 0.f, d = 0.f;
#pragma unroll
        for (int jj = 0; jj < N; ++jj) {
          const int jx = jj * kP + p;
          const float g = xs[4][tt][jx], vj = xs[2][tt][jx], sp = hist[tt][jj];
          a = fmaf(g, sp, a);        // gy_t . S_{t-1}[i, :]
          bb = fmaf(G[jj], vj, bb);  // G_t[i, :] . v_t
          cc = fmaf(G[jj], sp, cc);  // G_t[i, :] . S_{t-1}[i, :]
          d = fmaf(g, vj, d);        // gy_t . v_t
          G[jj] = fmaf(wi, G[jj], ri * g);
        }
        a = lanes_sum(a);
        bb = lanes_sum(bb);
        cc = lanes_sum(cc);
        d = lanes_sum(d);
        if (p == 0) {
          const size_t o = base + (size_t)(t0 + tt) * stride + i;
          gr[o] = fmaf(ui * ki, d, a);
          gk[o] = fmaf(ui * ri, d, bb);
          gw[o] = cc;
          gu_acc = fmaf(ri * ki, d, gu_acc);
        }
      }
    }
    float* gb = gs0 + (size_t)bh * HD * HD + (size_t)i * HD;
#pragma unroll
    for (int jj = 0; jj < N; ++jj) gb[jj * kP + p] = G[jj];
    if (p == 0) gu_part[(size_t)bh * HD + i] = gu_acc;
  } else {  // columns: gv
    const int j = row;
    float G[N], uu[N];
#pragma unroll
    for (int ii = 0; ii < N; ++ii) {
      G[ii] = gsb == nullptr ? 0.f : gsb[(ii * kP + p) * HD + j];
      uu[ii] = u[h * HD + ii * kP + p];
    }
    for (int c = chunks - 1; c >= 0; --c) {
      const int t0 = c * kC, len = min(kC, T - t0);
      __syncthreads();
      stage<HD, 5>(xs, src, base + (size_t)t0 * stride, stride, len);
      __syncthreads();
      for (int tt = len - 1; tt >= 0; --tt) {
        const float g = xs[4][tt][j];
        float a = 0.f, e = 0.f;
#pragma unroll
        for (int ii = 0; ii < N; ++ii) {
          const int i = ii * kP + p;
          const float ki = xs[1][tt][i], ri = xs[0][tt][i];
          a = fmaf(G[ii], ki, a);        // G_t[:, j] . k_t
          e = fmaf(ri * uu[ii], ki, e);  // r_t . (u * k_t)
          G[ii] = fmaf(xs[3][tt][i], G[ii], ri * g);
        }
        a = lanes_sum(a);
        e = lanes_sum(e);
        if (p == 0) gv[base + (size_t)(t0 + tt) * stride + j] = fmaf(g, e, a);
      }
    }
  }
}

template <int HD>
int fwd(const float* r, const float* k, const float* v, const float* w, const float* u,
        const float* s0, float* y, float* s_out, float* ckpt, int B, int T, int H,
        cudaStream_t stream) {
  wkv_fwd_kernel<HD><<<B * H, HD * kP, 0, stream>>>(r, k, v, w, u, s0, y, s_out, ckpt, T, H);
  return (int)cudaGetLastError();
}

template <int HD>
int bwd(const float* r, const float* k, const float* v, const float* w, const float* u,
        const float* ckpt, const float* gy, const float* gs, float* gr, float* gk, float* gv,
        float* gw, float* gu_part, float* gs0, int B, int T, int H, cudaStream_t stream) {
  wkv_bwd_kernel<HD><<<dim3(B * H, 2), HD * kP, 0, stream>>>(r, k, v, w, u, ckpt, gy, gs, gr, gk,
                                                             gv, gw, gu_part, gs0, T, H);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, y (B, T, H, hd); u (H, hd); s0, s_out (B, H, hd, hd): f32,
// contiguous, 16-byte aligned. ckpt: null, or (B, H, ceil(T / 16), hd, hd)
// f32 for the states before every 16th step. hd 32, 64 or 128.
extern "C" int wkv_fwd_launch(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* s0, void* y, void* s_out, void* ckpt,
                              int B, int T, int H, int hd, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
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
// gs0 (B, H, hd, hd).
extern "C" int wkv_bwd_launch(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* ckpt, const void* gy, const void* gs,
                              void* gr, void* gk, void* gv, void* gw, void* gu_part, void* gs0,
                              int B, int T, int H, int hd, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || ckpt == nullptr) return (int)cudaErrorInvalidValue;
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
