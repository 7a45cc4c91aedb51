// Shared helpers of the port's hand-written Hopper kernels.
//
// Each kernel source is compiled on its own by nvcc for sm_90a into a
// shared library with a plain C interface (see kernels/build.py); the
// Python wrappers pass raw device pointers, the current stream, and a
// dtype code, and raise if the returned cudaGetLastError() is non-zero.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// dtype codes shared with the Python wrappers
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

// the JAX package's finite "-inf" (keeps exp(m_prev - m_new) NaN-free)
constexpr float NEG_INF = -0.7f * 3.402823466e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch does
}

// 16-byte vector of T unpacked to floats (bf16 -> f32 is exact: the bf16
// bits are the top half of the f32).
__device__ __forceinline__ void unpack16(const uint4& r, float* out,
                                         const float*) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack16(const uint4& r, float* out,
                                         const __nv_bfloat16*) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// Stage `rows` rows of K and V (D values each, row r at element offset
// off_of(r), or off_of(r) < 0 for a row of zeros) into shared memory as
// f32: ks with row stride D + 1, vs with row stride D.  All of a
// thread's 16-byte loads are issued before any is consumed, so a tile
// costs about one device-memory round trip, not one per element.
template <typename T, int NT, typename OffFn>
__device__ __forceinline__ void load_kv_tile(const T* __restrict__ k,
                                             const T* __restrict__ v,
                                             float* ks, float* vs, int rows,
                                             int D, OffFn off_of) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int MAXV = 4;
  const int DV = D / VEC, NV = rows * DV, DP = D + 1;
  for (int base = 0; base < NV; base += NT * MAXV) {
    uint4 kr[MAXV], vr[MAXV];
#pragma unroll
    for (int u = 0; u < MAXV; ++u) {
      const int i = base + u * NT + (int)threadIdx.x;
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      vr[u] = kr[u];
      if (i < NV) {
        const int t = i / DV;
        const long long off = off_of(t);
        if (off >= 0) {
          const size_t o = (size_t)off + (size_t)(i - t * DV) * VEC;
          kr[u] = *reinterpret_cast<const uint4*>(k + o);
          vr[u] = *reinterpret_cast<const uint4*>(v + o);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < MAXV; ++u) {
      const int i = base + u * NT + (int)threadIdx.x;
      if (i < NV) {
        const int t = i / DV, c = (i - t * DV) * VEC;
        float kf[VEC], vf[VEC];
        unpack16(kr[u], kf, (const T*)nullptr);
        unpack16(vr[u], vf, (const T*)nullptr);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          ks[t * DP + c + j] = kf[j];
          vs[t * D + c + j] = vf[j];
        }
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, o);
  return x;
}

// Online-softmax update of one score row s[0 .. n) by a whole warp: the
// row becomes exp(s - m_new); the running max *m and sum *l advance, and
// alpha = exp(m_prev - m_new) is returned through *a_out (lane 0 writes).
__device__ __forceinline__ void warp_softmax_row(float* s, int n, float* m,
                                                 float* l, float* a_out) {
  const int lane = threadIdx.x & 31;
  const float m_prev = *m;
  float mx = m_prev;
  for (int t = lane; t < n; t += 32) mx = fmaxf(mx, s[t]);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int t = lane; t < n; t += 32) {
    const float e = expf(s[t] - mx);
    s[t] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  if (lane == 0) {
    const float alpha = expf(m_prev - mx);
    *l = *l * alpha + sum;
    *m = mx;
    *a_out = alpha;
  }
}

// Raise a kernel's dynamic shared-memory limit once per instantiation
// (launches above 48 KB are refused without it).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes, size_t* granted) {
  if (bytes <= 48 * 1024 || bytes <= *granted) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *granted = bytes;
  return e;
}

}  // namespace rt
