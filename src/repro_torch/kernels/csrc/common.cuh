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

#include <type_traits>

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

// 16-byte vector of pool or activation values unpacked to floats
// (bf16 -> f32 is exact: the bf16 bits are the top half of the f32;
// int8 -> f32 is exact).
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
__device__ __forceinline__ void unpack16(const uint4& r, float* out,
                                         const int8_t*) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)   // sign-extend byte j (arithmetic shift)
      out[4 * i + j] = (float)((int32_t)(w[i] << (24 - 8 * j)) >> 24);
  }
}

// One K/V row to stage: the element offset of its first value (< 0 for
// a row of zeros) and, in an int8 pool, the index of its (block, KV
// head) scale.
struct KVRow {
  long long off;
  long long scale;
};

// Stage `rows` rows of K and V (D values each, located by row_of(r))
// into shared memory as f32: ks with row stride D + 1, vs with row stride
// D.  P is the element type in device memory: the activation type, or
// int8 with k_scale / v_scale giving each row's f32 scale (multiplied in
// as the JAX package dequantizes: float(code) * scale).  All of a
// thread's 16-byte loads are issued before any is consumed, so a tile
// costs about one device-memory round trip, not one per element.
template <typename P, int NT, typename RowFn>
__device__ __forceinline__ void load_kv_tile(
    const P* __restrict__ k, const P* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    float* ks, float* vs, int rows, int D, RowFn row_of) {
  constexpr bool QUANT = std::is_same<P, int8_t>::value;
  constexpr int VEC = 16 / sizeof(P);
  constexpr int MAXV = 4;
  const int DV = D / VEC, NV = rows * DV, DP = D + 1;
  for (int base = 0; base < NV; base += NT * MAXV) {
    uint4 kr[MAXV], vr[MAXV];
    float kq[MAXV], vq[MAXV];
#pragma unroll
    for (int u = 0; u < MAXV; ++u) {
      const int i = base + u * NT + (int)threadIdx.x;
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      vr[u] = kr[u];
      kq[u] = vq[u] = 0.f;
      if (i < NV) {
        const int t = i / DV;
        const KVRow row = row_of(t);
        if (row.off >= 0) {
          const size_t o = (size_t)row.off + (size_t)(i - t * DV) * VEC;
          kr[u] = *reinterpret_cast<const uint4*>(k + o);
          vr[u] = *reinterpret_cast<const uint4*>(v + o);
          if (QUANT) {
            kq[u] = k_scale[row.scale];
            vq[u] = v_scale[row.scale];
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < MAXV; ++u) {
      const int i = base + u * NT + (int)threadIdx.x;
      if (i < NV) {
        const int t = i / DV, c = (i - t * DV) * VEC;
        float kf[VEC], vf[VEC];
        unpack16(kr[u], kf, (const P*)nullptr);
        unpack16(vr[u], vf, (const P*)nullptr);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          ks[t * DP + c + j] = QUANT ? kf[j] * kq[u] : kf[j];
          vs[t * D + c + j] = QUANT ? vf[j] * vq[u] : vf[j];
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

// --------------------------------------------------------------------------
// Flash-attention block over R query rows (BQ tokens x G grouped heads of
// one KV head), shared by the chunk-prefill and the static prefill
// kernels: the query rows and their f32 output accumulators live in
// shared memory, keys arrive TK at a time through load_kv_tile, and the
// softmax is online in f32, one warp per row.
// --------------------------------------------------------------------------

struct AttnSmem {
  float *qs, *os, *ks, *vs, *ss, *m_s, *l_s, *a_s;
};

template <int TK>
inline size_t attn_smem_bytes(int R, int D) {
  return sizeof(float) * ((size_t)R * (D + 1) + (size_t)R * D +
                          (size_t)TK * (D + 1) + (size_t)TK * D +
                          (size_t)R * (TK + 1) + 3 * (size_t)R);
}

template <int TK>
__device__ __forceinline__ AttnSmem carve_attn_smem(float* sm, int R,
                                                    int D) {
  AttnSmem s;
  s.qs = sm;                     // [R][D + 1] query rows (qi, g)
  s.os = s.qs + R * (D + 1);     // [R][D]     output accumulators
  s.ks = s.os + R * D;           // [TK][D + 1]
  s.vs = s.ks + TK * (D + 1);    // [TK][D]
  s.ss = s.vs + TK * D;          // [R][TK + 1] scores, then probabilities
  s.m_s = s.ss + R * (TK + 1);   // [R] running max
  s.l_s = s.m_s + R;             // [R] running sum
  s.a_s = s.l_s + R;             // [R] this tile's rescale factor
  return s;
}

// Load rows (qi, g) of q [S, H, D] for tokens q0 .. q0 + R / G (zeros
// past S), zero the accumulators, reset the running max / sum.
template <typename T, int NT>
__device__ __forceinline__ void load_q_rows(const T* __restrict__ q,
                                            const AttnSmem& s, int R, int G,
                                            int D, int H, int h, int q0,
                                            int S) {
  const int DP = D + 1;
  for (int i = threadIdx.x; i < R * D; i += NT) {
    const int r = i / D, d = i - r * D;
    const int qi = r / G, g = r - qi * G;
    float x = 0.f;
    if (q0 + qi < S)
      x = to_f32(q[((size_t)(q0 + qi) * H + h * G + g) * D + d]);
    s.qs[r * DP + d] = x;
    s.os[i] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += NT) {
    s.m_s[r] = NEG_INF;
    s.l_s[r] = 0.f;
  }
}

// One staged key tile at positions k_pos0 .. k_pos0 + TK: scores (ALiBi
// from |q_pos - k_pos|, the plain version's distance), the mask
// live(q_pos, k_pos), online-softmax update, P @ V.
template <int NT, int TK, typename LiveFn>
__device__ __forceinline__ void attend_tile(const AttnSmem& s, int R, int G,
                                            int D, int h, int q_pos0,
                                            int k_pos0,
                                            const float* __restrict__ slopes,
                                            int use_alibi, float scale,
                                            LiveFn live) {
  const int tid = threadIdx.x, DP = D + 1, SP = TK + 1;
  for (int i = tid; i < R * TK; i += NT) {
    const int r = i / TK, t = i - r * TK;
    const int qi = r / G, g = r - qi * G;
    const int q_pos = q_pos0 + qi, k_pos = k_pos0 + t;
    float sc = 0.f;
    for (int d = 0; d < D; ++d) sc += s.qs[r * DP + d] * s.ks[t * DP + d];
    sc *= scale;
    if (use_alibi) sc -= slopes[h * G + g] * (float)abs(q_pos - k_pos);
    s.ss[r * SP + t] = live(q_pos, k_pos) ? sc : NEG_INF;
  }
  __syncthreads();
  for (int r = tid >> 5; r < R; r += NT / 32)
    warp_softmax_row(s.ss + r * SP, TK, s.m_s + r, s.l_s + r, s.a_s + r);
  __syncthreads();
  for (int i = tid; i < R * D; i += NT) {
    const int r = i / D, d = i - r * D;
    float o = s.os[i] * s.a_s[r];
    for (int t = 0; t < TK; ++t) o += s.ss[r * SP + t] * s.vs[t * D + d];
    s.os[i] = o;
  }
  __syncthreads();
}

// Write the normalized rows (qi, g) of tokens q0 .. min(q0 + R / G, S)
// into out [S, H, D].
template <typename T, int NT>
__device__ __forceinline__ void store_rows(T* __restrict__ out,
                                           const AttnSmem& s, int R, int G,
                                           int D, int H, int h, int q0,
                                           int S) {
  for (int i = threadIdx.x; i < R * D; i += NT) {
    const int r = i / D, d = i - r * D;
    const int qi = r / G, g = r - qi * G;
    if (q0 + qi < S)
      out[((size_t)(q0 + qi) * H + h * G + g) * D + d] =
          from_f32<T>(s.os[i] / fmaxf(s.l_s[r], 1e-30f));
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
