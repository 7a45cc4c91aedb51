// Flash-attention tile routine on the tensor cores (bf16, mma.sync),
// FlashAttention-2 style: each warp owns 16 query rows whose Q fragments
// stay in registers for the whole key loop (up to head dim 128; see
// mma_q_in_regs for 256); the scores S = Q K^T and the
// product O += P V are mma.sync.m16n8k16 (bf16 in, f32 accumulate); the
// online softmax runs on the S accumulators in registers, each row's max
// combined across the four lanes that hold it by quad shuffles; P becomes
// the A operand of the second product in registers, never through shared
// memory.  K and V tiles of BK keys sit in shared memory as bf16 rows of
// D + PAD values (key-major), read with ldmatrix (.trans for V); the pad
// of 16 bytes puts the 8 rows of each 8 x 8 matrix in 8 distinct 16-byte
// bank groups, so ldmatrix is free of bank conflicts.
//
// A head dim D that is a multiple of 8 but not of 16 (120) is padded to
// DP = mma_padded(D) in shared memory: the staged Q and K rows carry zeros
// in columns D .. DP, so the last k-step of Q K^T adds 0; P V needs no
// pad (D / 8 C tiles of 8 columns), and only D columns are stored.  The
// pool stagers below take D % 16 == 0 only (static_assert).
//
// Used by the static prefill kernel (flash_attention.cu), the chunk
// prefill kernel (flash_attention_chunk.cu) and the paged decode kernel
// (paged_attention.cu).  A warp's 16 rows are 16 query tokens of one head
// in the two prefill kernels, and the G grouped heads of one KV head
// (padded to 16) at one position in decode: a per-row hook gives each
// row's position and ALiBi slope.  Pool tiles (bf16 rows, or int8 codes
// dequantized to bf16 in shared memory) are staged by stage_pool_rows.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace rt {

constexpr int MMA_ATTN_PAD = 8;   // bf16 values of padding per staged row

// The width of a staged head of D values: D rounded up to the mma's k
// depth of 16 (the columns past D hold zeros in Q and K).
__host__ __device__ constexpr int mma_padded(int D) {
  return (D + 15) / 16 * 16;
}

// Whether a warp holds its Q fragments in registers for the whole key
// loop.  At D = 256 they would take 64 registers beside O's 128
// accumulators and a 64-key tile's 32 scores, past the 255 a thread may
// have (ptxas spills); there each k-step's fragment is read again from
// the staged Q in shared memory (one ldmatrix.x4 per 16 d per key tile,
// which the shared-memory pipe serves beside the K reads).
template <int D>
__host__ __device__ constexpr bool mma_q_in_regs() {
  return D <= 128;
}

// One warp's softmax state over its 16 query rows.  Lane (g, t) holds
// rows g and g + 8: m / l index 0 and 1.  l is this lane's share of the
// row sum (its own columns); the quad's shares are added at the end.
template <int D>
struct MmaAttnState {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  // Q as A fragments, per 16 d (one unused row when Q stays staged)
  uint32_t qf[mma_q_in_regs<D>() ? mma_padded(D) / 16 : 1][4];
  const __nv_bfloat16* qs;  // this lane's ldmatrix row of the staged Q
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

// Q fragments of the warp's 16 rows, staged at qs (row stride STR, pad
// columns zero); where they do not stay in registers, the lane's row of
// the staged Q, which must then stay in place for the whole key loop.
template <int D>
__device__ __forceinline__ void mma_attn_load_q(MmaAttnState<D>& st,
                                                const __nv_bfloat16* qs,
                                                int STR) {
  const int lane = threadIdx.x & 31;
  st.qs = qs + (lane & 15) * STR + (lane >> 4) * 8;
  if constexpr (mma_q_in_regs<D>()) {
#pragma unroll
    for (int kc = 0; kc < mma_padded(D) / 16; ++kc)
      ldmatrix_x4(st.qf[kc], st.qs + kc * 16);
  }
}

// The A fragment of Q for k-step kc: held, or read into buf.
template <int D>
__device__ __forceinline__ const uint32_t* mma_q_frag(
    const MmaAttnState<D>& st, int kc, uint32_t* buf) {
  if constexpr (mma_q_in_regs<D>()) {
    return st.qf[kc];
  } else {
    ldmatrix_x4(buf, st.qs + kc * 16);
    return buf;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xFFFFFFFFu, x, 1);
  return x + __shfl_xor_sync(0xFFFFFFFFu, x, 2);
}

// A warp row's query position and ALiBi slope (0: no bias).
struct MmaRow {
  int pos;
  float slope;
};

// One staged tile of BK keys at positions k_pos0 .. k_pos0 + BK: scores
// (scaled, ALiBi by |q_pos - k_pos| where the row's slope != 0), the mask
// live(q_pos, k_pos) only when MASK, the online-softmax update, P @ V.
// row(g, hi) gives the position and slope of warp row g + 8 * hi (g < 8,
// hi 0 or 1: the two rows a lane holds).  Under a causal mask every live
// key has k_pos <= q_pos, so |q_pos - k_pos| is the Pallas kernels'
// max(q_pos - k_pos, 0) wherever it is not masked.  Without one (the
// static kernel's encoder case) the bias is |q_pos - k_pos|, the
// reference's oracle grouped_attention, where its Pallas _fa_kernel takes
// max(q_pos - k_pos, 0) (ROADMAP C3): the port holds to the oracle, as its
// plain version does.  The static kernel's
// hook, q_pos0 + g + hi * 8, compiles to the same SASS as the scalar
// position and slope this routine took before the hook.
template <int D, int BK, bool MASK, typename RowFn, typename LiveFn>
__device__ __forceinline__ void mma_attend_tile(
    MmaAttnState<D>& st, const __nv_bfloat16* ks, const __nv_bfloat16* vs,
    int STR, int k_pos0, float scale, RowFn row, LiveFn live) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float s[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

  // S = Q K^T: K rows are keys (n), their d values are the product's k
  // (the pad columns of Q and K are zero).
#pragma unroll
  for (int kc = 0; kc < mma_padded(D) / 16; ++kc) {
    uint32_t qbuf[4];
    const uint32_t* qa = mma_q_frag(st, kc, qbuf);
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * STR +
                         kc * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16_16816(s[2 * np], qa, b);
      mma_bf16_16816(s[2 * np + 1], qa, b + 2);
    }
  }

  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const MmaRow rw = row(g, e >> 1);
      const int q_pos = rw.pos;
      const int k_pos = k_pos0 + j * 8 + 2 * t + (e & 1);
      float x = s[j][e] * scale;
      if (rw.slope != 0.f) x -= rw.slope * (float)abs(q_pos - k_pos);
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
    if constexpr (D % 16 != 0) {
      // the last 8 columns: one C tile (the 8 pad columns loaded beside
      // them are never multiplied)
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + (c * 16 + (lane & 15)) * STR +
                               (D / 16) * 16 + (lane >> 4) * 8);
      mma_bf16_16816(st.o[D / 8 - 1], a, b);
    }
  }
}

// Stage ROWS rows of K and V from a bf16 pool or raw tensor into shared
// bf16 rows of STR values by cp.async: row_of(r) gives row r's element
// offset (KVRow::off < 0: a row of zeros, nothing read).
template <int D, int ROWS, int NT, typename RowFn>
__device__ __forceinline__ void stage_kv_rows(__nv_bfloat16* kd,
                                              __nv_bfloat16* vd,
                                              const __nv_bfloat16* k,
                                              const __nv_bfloat16* v,
                                              RowFn row_of) {
  static_assert(D % 16 == 0, "pool rows are staged unpadded");
  constexpr int CH = D / 8, STR = D + MMA_ATTN_PAD;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i - r * CH;
    const KVRow row = row_of(r);
    const bool ok = row.off >= 0;
    const size_t o = ok ? (size_t)row.off + c * 8 : 0;
    cp_async16(kd + r * STR + c * 8, k + o, ok);
    cp_async16(vd + r * STR + c * 8, v + o, ok);
  }
}

// The same from an int8 pool: the codes land in kc / vc (rows of D
// bytes) and each row's f32 scale (KVRow::scale indexes k_scale /
// v_scale) in ksc / vsc; dequant_kv_rows then makes the bf16 rows.
template <int D, int ROWS, int NT, typename RowFn>
__device__ __forceinline__ void stage_kv_codes(
    int8_t* kc, int8_t* vc, float* ksc, float* vsc, const int8_t* k,
    const int8_t* v, const float* k_scale, const float* v_scale,
    RowFn row_of) {
  static_assert(D % 16 == 0, "int8 rows are staged 16 codes at a time");
  constexpr int CH = D / 16;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i - r * CH;
    const KVRow row = row_of(r);
    const bool ok = row.off >= 0;
    const size_t o = ok ? (size_t)row.off + c * 16 : 0;
    cp_async16(kc + r * D + c * 16, k + o, ok);
    cp_async16(vc + r * D + c * 16, v + o, ok);
    if (c == 0) {
      const size_t so = ok ? (size_t)row.scale : 0;
      cp_async4(ksc + r, k_scale + so, ok);
      cp_async4(vsc + r, v_scale + so, ok);
    }
  }
}

// Staged int8 rows -> bf16 rows of STR values: code x the row's scale in
// f32, rounded once to bf16 (the plain version's dequantize-then-cast).
template <int D, int ROWS, int NT>
__device__ __forceinline__ void dequant_kv_rows(__nv_bfloat16* kd,
                                                __nv_bfloat16* vd,
                                                const int8_t* kc,
                                                const int8_t* vc,
                                                const float* ksc,
                                                const float* vsc) {
  static_assert(D % 16 == 0, "int8 rows are staged 16 codes at a time");
  constexpr int CH = D / 16, STR = D + MMA_ATTN_PAD;
  for (int i = threadIdx.x; i < 2 * ROWS * CH; i += NT) {
    const bool is_v = i >= ROWS * CH;
    const int j = is_v ? i - ROWS * CH : i;
    const int r = j / CH, c = j - r * CH;
    const float sc = (is_v ? vsc : ksc)[r];
    const uint4 w = *reinterpret_cast<const uint4*>((is_v ? vc : kc) +
                                                    r * D + c * 16);
    float f[16];
    unpack16(w, f, (const int8_t*)nullptr);
    uint32_t b[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      b[e] = pack_bf16(f[2 * e] * sc, f[2 * e + 1] * sc);
    uint4* dst =
        reinterpret_cast<uint4*>((is_v ? vd : kd) + r * STR + c * 16);
    dst[0] = make_uint4(b[0], b[1], b[2], b[3]);
    dst[1] = make_uint4(b[4], b[5], b[6], b[7]);
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
