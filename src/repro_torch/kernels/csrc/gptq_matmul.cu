// W4A16 GPTQ matmul for Hopper: y = x @ ((codes - zeros[g]) * scales[g]).
//
// Replaces: repro/kernels/gptq_matmul.py :: gptq_matmul (body _gptq_mm_kernel).
//
// x [M, K] (bf16 or f32), qweight [K/8, N] int32 (8 codes per word, little
// nibble first), scales / zeros [K/gs, N] f32, group g = k // gs over
// contiguous groups only (the caller rejects any other g_idx).  Codes
// are unpacked with UNSIGNED shifts (an int32 >> would smear the sign of a
// top-nibble code >= 8), dequantized in f32, accumulated in f32, and the
// output is written in x's dtype.  Bias stays outside the kernel.
//
// What bounds it on an H100: at decode (M = 8) bytes — 4 bits of codes
// plus 8 / gs bytes of f32 scale and zero per weight, each read once; at a
// 256-token prefill chunk it does 2 * M flops per weight, which on the
// CUDA cores (no tensor cores yet) makes it compute-bound in practice.
//
// Design: a block owns 32 output columns (one per lane, so every code,
// scale and zero load of a warp is one coalesced 128-byte row) and BM
// rows; its 8 warps split the K groups between them, each dequantizing a
// group's codes in registers once and applying them to all BM rows of x
// held transposed in its own shared-memory slice (float4 broadcasts),
// then the warps' partial sums are reduced through shared memory.  The
// K-split stays inside the block: no atomics, a deterministic sum order.
// Later work: tensor-core (mma/wgmma) tiles for prefill, split-K across
// blocks for decode.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PACK = 8;

template <typename T, int BM>
__global__ void __launch_bounds__(THREADS) gptq_matmul_kernel(
    const T* __restrict__ x, const int* __restrict__ qweight,
    const float* __restrict__ scales, const float* __restrict__ zeros,
    T* __restrict__ y, int M, int K, int N, int gs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const int m0 = blockIdx.y * BM;
  extern __shared__ float sm[];
  float* xs = sm + (size_t)warp * gs * BM;      // this warp's [gs][BM]
  float acc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0.f;

  const int ngroups = K / gs;
  for (int g = warp; g < ngroups; g += WARPS) {
    for (int i = lane; i < BM * gs; i += 32) {   // coalesced along k
      const int m = i / gs, kk = i - m * gs;
      xs[kk * BM + m] =
          (m0 + m < M) ? rt::to_f32(x[(size_t)(m0 + m) * K + g * gs + kk]) : 0.f;
    }
    __syncwarp();
    if (n < N) {
      const float s = scales[(size_t)g * N + n];
      const float z = zeros[(size_t)g * N + n];
      const int w0 = g * (gs / PACK);
      for (int j = 0; j < gs / PACK; ++j) {
        const uint32_t word = (uint32_t)qweight[(size_t)(w0 + j) * N + n];
#pragma unroll
        for (int i = 0; i < PACK; ++i) {
          const float w = ((float)((word >> (4u * i)) & 0xFu) - z) * s;
          const float4* xv =
              reinterpret_cast<const float4*>(xs + (j * PACK + i) * BM);
#pragma unroll
          for (int m4 = 0; m4 < BM / 4; ++m4) {
            const float4 v = xv[m4];
            acc[4 * m4 + 0] += v.x * w;
            acc[4 * m4 + 1] += v.y * w;
            acc[4 * m4 + 2] += v.z * w;
            acc[4 * m4 + 3] += v.w * w;
          }
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();
  float* red = sm;                                // [WARPS][BM][32]
#pragma unroll
  for (int m = 0; m < BM; ++m) red[(warp * BM + m) * 32 + lane] = acc[m];
  __syncthreads();
  for (int i = threadIdx.x; i < BM * 32; i += THREADS) {
    const int m = i / 32, l = i - m * 32;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[(w * BM + m) * 32 + l];
    const int nn = blockIdx.x * 32 + l;
    if (m0 + m < M && nn < N) y[(size_t)(m0 + m) * N + nn] = rt::from_f32<T>(sum);
  }
}

template <typename T, int BM>
int launch_bm(const void* x, const int* qweight, const float* scales,
              const float* zeros, void* y, int M, int K, int N, int gs,
              cudaStream_t stream) {
  static size_t granted = 0;
  const int span = gs > 32 ? gs : 32;             // staging or reduction
  const size_t smem = sizeof(float) * (size_t)WARPS * BM * span;
  cudaError_t e = rt::allow_smem(gptq_matmul_kernel<T, BM>, smem, &granted);
  if (e != cudaSuccess) return (int)e;
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  dim3 grid((N + 31) / 32, (M + BM - 1) / BM);
  gptq_matmul_kernel<T, BM><<<grid, THREADS, smem, stream>>>(
      (const T*)x, qweight, scales, zeros, (T*)y, M, K, N, gs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const int* qweight, const float* scales,
           const float* zeros, void* y, int M, int K, int N, int gs,
           cudaStream_t stream) {
  if (M <= 8)
    return launch_bm<T, 8>(x, qweight, scales, zeros, y, M, K, N, gs, stream);
  if (M <= 16)
    return launch_bm<T, 16>(x, qweight, scales, zeros, y, M, K, N, gs, stream);
  return launch_bm<T, 32>(x, qweight, scales, zeros, y, M, K, N, gs, stream);
}

}  // namespace

extern "C" int gptq_matmul_launch(int dtype, const void* x, const int* qweight,
                                  const float* scales, const float* zeros,
                                  void* y, int M, int K, int N, int gs,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == rt::DTYPE_BF16)
    return launch<__nv_bfloat16>(x, qweight, scales, zeros, y, M, K, N, gs, s);
  return launch<float>(x, qweight, scales, zeros, y, M, K, N, gs, s);
}
