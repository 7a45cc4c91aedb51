// Flash-attention tile routine on the tensor cores (bf16, mma.sync),
// FlashAttention-2 style: each warp owns 16 query rows whose Q fragments
// stay in registers for the whole key loop; the scores S = Q K^T and the
// product O += P V are mma.sync.m16n8k16 (bf16 in, f32 accumulate); the
// online softmax runs on the S accumulators in registers, each row's max
// combined across the four lanes that hold it by quad shuffles; P becomes
// the A operand of the second product in registers, never through shared
// memory.  K and V tiles of BK keys sit in shared memory as bf16 rows of
// D + PAD values (key-major), read with ldmatrix (.trans for V); the pad
// of 16 bytes puts the 8 rows of each 8 x 8 matrix in 8 distinct 16-byte
// bank groups, so ldmatrix is free of bank conflicts.
//
// Used by the static prefill kernel (flash_attention.cu); the chunk
// kernel still runs the CUDA-core rt::attend_tile of common.cuh.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace rt {

constexpr int MMA_ATTN_PAD = 8;   // bf16 values of padding per staged row

// One warp's softmax state over its 16 query rows.  Lane (g, t) holds
// rows g and g + 8: m / l index 0 and 1.  l is this lane's share of the
// row sum (its own columns); the quad's shares are added at the end.
template <int D>
struct MmaAttnState {
  uint32_t qf[D / 16][4];   // Q as A fragments, one per 16-wide d chunk
  float o[D / 8][4];        // O accumulators, one C tile per 8 d columns
  float m[2], l[2];
};

template <int D>
__device__ __forceinline__ void mma_attn_init(MmaAttnState<D>& st) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[j][e] = 0.f;
  st.m[0] = st.m[1] = NEG_INF;
  st.l[0] = st.l[1] = 0.f;
}

// Q fragments of the warp's 16 rows, staged at qs (row stride STR).
template <int D>
__device__ __forceinline__ void mma_attn_load_q(MmaAttnState<D>& st,
                                                const __nv_bfloat16* qs,
                                                int STR) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    ldmatrix_x4(st.qf[kc], qs + (lane & 15) * STR + kc * 16 + (lane >> 4) * 8);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xFFFFFFFFu, x, 1);
  return x + __shfl_xor_sync(0xFFFFFFFFu, x, 2);
}

// One staged tile of BK keys at positions k_pos0 .. k_pos0 + BK: scores
// (scaled, ALiBi by |q_pos - k_pos| when slope != 0), the mask
// live(q_pos, k_pos) only when MASK, the online-softmax update, P @ V.
// q_pos0 is the position of the warp's row 0.
template <int D, int BK, bool MASK, typename LiveFn>
__device__ __forceinline__ void mma_attend_tile(
    MmaAttnState<D>& st, const __nv_bfloat16* ks, const __nv_bfloat16* vs,
    int STR, int q_pos0, int k_pos0, float scale, float slope,
    LiveFn live) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float s[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

  // S = Q K^T: K rows are keys (n), their d values are the product's k.
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * STR +
                         kc * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16_16816(s[2 * np], st.qf[kc], b);
      mma_bf16_16816(s[2 * np + 1], st.qf[kc], b + 2);
    }
  }

  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q_pos = q_pos0 + g + (e >> 1) * 8;
      const int k_pos = k_pos0 + j * 8 + 2 * t + (e & 1);
      float x = s[j][e] * scale;
      if (slope != 0.f) x -= slope * (float)abs(q_pos - k_pos);
      if (MASK && !live(q_pos, k_pos)) x = NEG_INF;
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    alpha[r] = __expf(st.m[r] - mx[r]);
    st.m[r] = mx[r];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = __expf(s[j][e] - mx[e >> 1]);
      s[j][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = st.l[r] * alpha[r] + sum[r];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    st.o[j][0] *= alpha[0];
    st.o[j][1] *= alpha[0];
    st.o[j][2] *= alpha[1];
    st.o[j][3] *= alpha[1];
  }

  // O += P V: the S accumulators of key tiles 2c, 2c + 1 are exactly the
  // A fragment of key chunk c; V rows are keys (the product's k), read
  // transposed into B fragments.
#pragma unroll
  for (int c = 0; c < BK / 16; ++c) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
    a[1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
    a[2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
    a[3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + (c * 16 + (lane & 15)) * STR + dp * 16 +
                               (lane >> 4) * 8);
      mma_bf16_16816(st.o[2 * dp], a, b);
      mma_bf16_16816(st.o[2 * dp + 1], a, b + 2);
    }
  }
}

// Normalize and write the warp's rows: row r of the warp is query token
// tok0 + r, stored at out + tok * row_stride (bf16, D values); rows at or
// past n_tok are not written.
template <int D>
__device__ __forceinline__ void mma_attn_store(const MmaAttnState<D>& st,
                                               __nv_bfloat16* out,
                                               size_t row_stride, int tok0,
                                               int n_tok) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tok = tok0 + g + 8 * r;
    const float inv = 1.f / fmaxf(quad_sum(st.l[r]), 1e-30f);
    if (tok >= n_tok) continue;
    __nv_bfloat16* row = out + (size_t)tok * row_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + j * 8) =
          pack_bf16(st.o[j][2 * r] * inv, st.o[j][2 * r + 1] * inv);
  }
}

}  // namespace rt
