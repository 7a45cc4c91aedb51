// Time scans of the attention-free mixers for Hopper: the Mamba-1
// selective scan and the RG-LRU's linear recurrence, each one launch per
// layer and call.
//
// Replaces: not a Pallas site.  The JAX package scans time with lax.scan
// (repro/models/ssm.py :: _chunked_time_scan, the Mamba-1 step of
// _ssm_inner and the RG-LRU step of _rglru_scan); its torch counterpart
// would be a few launches per time step and layer, which leaves the card
// waiting on the host (a [8, 1024] wave of 64 layers: ~330,000 launches).
//
// selective_scan (Mamba-1): dt, u [Bt, S, din] f32; B, C [Bt, S, N] f32;
// A [din, N] f32; h0 [Bt, din, N] f32.  For t = 0 .. S-1:
//   h = exp(dt_t * A) * h + (dt_t * u_t) * B_t,   y_t = sum_n h * C_t
// gives y [Bt, S, din] and h_last [Bt, din, N].  A position with dt = 0
// and u = 0 (the callers' masked padding) leaves h as it is.
//
// linear_scan (RG-LRU): a, g [Bt, S, w] f32, h0 [Bt, w] f32.  For each t,
// h = a_t * h + g_t (one fmaf); gives hs [Bt, S, w] and h_last [Bt, w].
//
// What bounds them on an H100: bytes.  The selective scan does about 7
// flops per state element and step (one expf among them) against 12
// bytes of dt, u and y per channel and step, shared by its N = 16 states:
// ~9 flops per byte; the linear scan 2 flops against 12 bytes.  Both are
// below the ~20 flops per byte at which the card's f32 CUDA cores (67
// TFLOP/s against 3.35 TB/s) would set the pace.
//
// Design: one thread owns one (sequence, channel) and walks time in
// order, its state in registers (the selective scan's N states and its
// row of A as well), so the recurrence needs no communication.  A block
// is THREADS channels of one sequence, so dt / u / a / g are read and y /
// hs written coalesced along the channels.  Time goes in tiles of TT
// steps: a thread first loads its tile's inputs into registers (TT
// independent loads in flight), then steps through them.  Every channel
// of a block shares B_t and C_t, so the block stages the tile's rows of
// B and C in shared memory once and each thread reads them broadcast.
// The time loop is serial in each thread; splitting time across blocks
// (a chunked two-pass scan) is left for later.  Exponentials are expf
// (not __expf): the plain version's exp within an ulp or two.
#include "common.cuh"

namespace {

constexpr int THREADS = 64;     // channels per block
constexpr int TT = 16;          // time steps per register tile

template <int N>
__global__ void __launch_bounds__(THREADS) selective_scan_kernel(
    const float* __restrict__ dt, const float* __restrict__ u,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_last, int S, int din) {
  __shared__ float sB[TT][N];
  __shared__ float sC[TT][N];
  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < din;
  const size_t state = ((size_t)b * din + d) * N;
  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? A[(size_t)d * N + n] : 0.f;
    h[n] = live ? h0[state + n] : 0.f;
  }
  const size_t row0 = (size_t)b * S;       // this sequence's first row
  for (int t0 = 0; t0 < S; t0 += TT) {
    const int nt = min(TT, S - t0);
    __syncthreads();                       // the last tile's reads done
    for (int i = threadIdx.x; i < TT * N; i += THREADS) {
      const int tt = i / N, n = i % N;
      const bool in = tt < nt;
      const size_t at = (row0 + t0 + tt) * N + n;
      sB[tt][n] = in ? Bm[at] : 0.f;
      sC[tt][n] = in ? Cm[at] : 0.f;
    }
    float dtv[TT], uv[TT];
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      const bool in = live && tt < nt;
      const size_t at = (row0 + t0 + tt) * din + d;
      dtv[tt] = in ? dt[at] : 0.f;
      uv[tt] = in ? u[at] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      if (tt < nt) {                       // the same for the whole block
        const float dx = dtv[tt] * uv[tt];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float da = expf(dtv[tt] * a[n]);
          h[n] = da * h[n] + dx * sB[tt][n];
          acc += h[n] * sC[tt][n];
        }
        if (live) y[(row0 + t0 + tt) * din + d] = acc;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_last[state + n] = h[n];
  }
}

__global__ void __launch_bounds__(THREADS) linear_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ g,
    const float* __restrict__ h0, float* __restrict__ hs,
    float* __restrict__ h_last, int S, int w) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= w) return;
  float h = h0[(size_t)b * w + c];
  const size_t base = (size_t)b * S * w + c;
  for (int t0 = 0; t0 < S; t0 += TT) {
    const int nt = min(TT, S - t0);
    float av[TT], gv[TT];
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      const size_t at = base + (size_t)(t0 + tt) * w;
      av[tt] = tt < nt ? a[at] : 0.f;
      gv[tt] = tt < nt ? g[at] : 0.f;
    }
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      if (tt < nt) {
        h = fmaf(av[tt], h, gv[tt]);
        hs[base + (size_t)(t0 + tt) * w] = h;
      }
    }
  }
  h_last[(size_t)b * w + c] = h;
}

}  // namespace

extern "C" int selective_scan_launch(const float* dt, const float* u,
                                     const float* B, const float* C,
                                     const float* A, const float* h0,
                                     float* y, float* h_last, int Bt, int S,
                                     int din, int N, void* stream) {
  if (Bt <= 0 || Bt > 65535 || din <= 0 || S < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((din + THREADS - 1) / THREADS, Bt);
  cudaStream_t s = (cudaStream_t)stream;
  switch (N) {
    case 16:
      selective_scan_kernel<16><<<grid, THREADS, 0, s>>>(
          dt, u, B, C, A, h0, y, h_last, S, din);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int linear_scan_launch(const float* a, const float* g,
                                  const float* h0, float* hs, float* h_last,
                                  int Bt, int S, int w, void* stream) {
  if (Bt <= 0 || Bt > 65535 || w <= 0 || S < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w + THREADS - 1) / THREADS, Bt);
  linear_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      a, g, h0, hs, h_last, S, w);
  return (int)cudaGetLastError();
}
