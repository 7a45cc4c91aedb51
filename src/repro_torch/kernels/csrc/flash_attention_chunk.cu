// Chunk-prefill flash attention over the paged pool, for Hopper (bf16/f32
// pools; the int8 pool branch is not ported yet).
//
// Replaces: repro/kernels/flash_attention.py :: flash_attention_chunk
//           (body _fa_chunk_kernel, page clamp _chunk_clamp), quantized=False.
//
// One chunk of W query tokens of ONE sequence, at absolute offset
// q_offset, attends to two key sources:
//   * the already-prefilled prefix [0, q_offset) in the paged pool, read
//     through the block table; the walk stops at ceil(q_offset / BS) pages
//     and masks k_pos < q_offset (stale table entries are never read);
//   * the chunk's own raw K/V (never pool-roundtripped), causally, masked
//     at total_len.
// q_offset and total_len are read INSIDE the kernel from device int32
// scalars: no host sync, and one launch configuration serves every chunk.
//
// What bounds it on an H100: operations at a long prefix are still small
// (2 * 2 * W * H * D flops per key), so at the serving shape the kernel is
// bound by its own latency; the device-memory bytes (prefix K/V once per
// KV head plus the chunk's q/k/v/out) are a few MB per layer.
//
// Design: one thread block per (KV head, tile of BQ query tokens); the
// block holds its BQ * G query rows (all G heads of the KV head) and their
// f32 output accumulators in shared memory, stages 32 keys of K/V at a
// time (16-byte loads, all in flight at once), and runs an f32 online
// softmax per row (one warp per row).  Key tiles that no query
// of the block can see (causal, or past total_len) are skipped.  Plain
// CUDA-core FMAs: the tensor-core (wgmma) form is later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TK = 32;         // keys per staged tile

struct Smem {
  float *qs, *os, *ks, *vs, *ss, *m_s, *l_s, *a_s;
};

// One staged key tile: scores, online-softmax update, P @ V.
// ``raw`` selects the chunk's own keys (causal, < total_len) over the
// pool prefix (< q_offset).
__device__ __forceinline__ void attend_tile(
    const Smem& s, int R, int G, int D, int h, int q_pos0, int k_pos0,
    bool raw, int q_off, int tlen, int window, const float* slopes,
    int use_alibi, float scale) {
  const int tid = threadIdx.x, DP = D + 1, SP = TK + 1;
  for (int i = tid; i < R * TK; i += THREADS) {
    const int r = i / TK, t = i - r * TK;
    const int qi = r / G, g = r - qi * G;
    const int q_pos = q_pos0 + qi, k_pos = k_pos0 + t;
    float sc = 0.f;
    for (int d = 0; d < D; ++d) sc += s.qs[r * DP + d] * s.ks[t * DP + d];
    sc *= scale;
    if (use_alibi) sc -= slopes[h * G + g] * (float)max(q_pos - k_pos, 0);
    bool live = raw ? (k_pos < tlen && k_pos <= q_pos) : (k_pos < q_off);
    if (window > 0) live = live && (q_pos - k_pos) < window;
    s.ss[r * SP + t] = live ? sc : rt::NEG_INF;
  }
  __syncthreads();
  for (int r = tid >> 5; r < R; r += THREADS / 32)
    rt::warp_softmax_row(s.ss + r * SP, TK, s.m_s + r, s.l_s + r, s.a_s + r);
  __syncthreads();
  for (int i = tid; i < R * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    float o = s.os[i] * s.a_s[r];
    for (int t = 0; t < TK; ++t) o += s.ss[r * SP + t] * s.vs[t * D + d];
    s.os[i] = o;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS) chunk_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ block_table,
    const int* __restrict__ q_offset, const int* __restrict__ total_len,
    const T* __restrict__ k_raw, const T* __restrict__ v_raw,
    const float* __restrict__ slopes, T* __restrict__ out, int W, int H,
    int KV, int D, int BS, int MB, int BQ, int window, int use_alibi) {
  const int h = blockIdx.x, q0 = blockIdx.y * BQ, tid = threadIdx.x;
  const int G = H / KV, R = BQ * G, DP = D + 1;
  extern __shared__ float sm[];
  Smem s;
  s.qs = sm;                     // [R][DP] query rows (qi, g)
  s.os = s.qs + R * DP;          // [R][D]  output accumulators
  s.ks = s.os + R * D;           // [TK][DP]
  s.vs = s.ks + TK * DP;         // [TK][D]
  s.ss = s.vs + TK * D;          // [R][TK + 1]
  s.m_s = s.ss + R * (TK + 1);   // [R]
  s.l_s = s.m_s + R;             // [R]
  s.a_s = s.l_s + R;             // [R]

  const int q_off = *q_offset, tlen = *total_len;
  const float scale = rsqrtf((float)D);

  for (int i = tid; i < R * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int qi = r / G, g = r - qi * G;
    float v = 0.f;
    if (q0 + qi < W) v = rt::to_f32(q[((size_t)(q0 + qi) * H + h * G + g) * D + d]);
    s.qs[r * DP + d] = v;
    s.os[i] = 0.f;
  }
  for (int r = tid; r < R; r += THREADS) {
    s.m_s[r] = rt::NEG_INF;
    s.l_s[r] = 0.f;
  }
  __syncthreads();

  // ---- pool prefix [0, q_offset): live pages only
  const int npool = min((q_off + BS - 1) / BS, MB);
  const int n_prefix = npool * BS;
  for (int k0 = 0; k0 < n_prefix; k0 += TK) {
    rt::load_kv_tile<T, THREADS>(
        k_pool, v_pool, s.ks, s.vs, TK, D, [&](int t) -> long long {
          const int k_pos = k0 + t;
          if (k_pos >= n_prefix) return -1;   // past the live pages
          const long long blk = block_table[k_pos / BS];
          return ((blk * BS + k_pos % BS) * KV + h) * D;
        });
    __syncthreads();
    attend_tile(s, R, G, D, h, q_off + q0, k0, false, q_off, tlen, window,
                slopes, use_alibi, scale);
  }

  // ---- the chunk's own raw keys at [q_offset, q_offset + W)
  const int q_last = min(q0 + BQ, W) - 1;
  for (int j0 = 0; j0 < W; j0 += TK) {
    if (j0 > q_last || q_off + j0 >= tlen) break;   // no query sees it
    rt::load_kv_tile<T, THREADS>(
        k_raw, v_raw, s.ks, s.vs, TK, D, [&](int t) -> long long {
          const int j = j0 + t;
          return j < W ? ((long long)j * KV + h) * D : -1;
        });
    __syncthreads();
    attend_tile(s, R, G, D, h, q_off + q0, q_off + j0, true, q_off, tlen,
                window, slopes, use_alibi, scale);
  }

  for (int i = tid; i < R * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int qi = r / G, g = r - qi * G;
    if (q0 + qi < W)
      out[((size_t)(q0 + qi) * H + h * G + g) * D + d] =
          rt::from_f32<T>(s.os[i] / fmaxf(s.l_s[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* block_table, const int* q_offset, const int* total_len,
           const void* k_raw, const void* v_raw, const float* slopes,
           void* out, int W, int H, int KV, int D, int BS, int MB, int BQ,
           int window, int use_alibi, cudaStream_t stream) {
  static size_t granted = 0;
  const int R = BQ * (H / KV);
  const size_t smem =
      sizeof(float) * ((size_t)R * (D + 1) + (size_t)R * D +
                       (size_t)TK * (D + 1) + (size_t)TK * D +
                       (size_t)R * (TK + 1) + 3 * (size_t)R);
  cudaError_t e = rt::allow_smem(chunk_attention_kernel<T>, smem, &granted);
  if (e != cudaSuccess) return (int)e;
  if (W == 0) return (int)cudaGetLastError();
  dim3 grid(KV, (W + BQ - 1) / BQ);
  chunk_attention_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, block_table, q_offset,
      total_len, (const T*)k_raw, (const T*)v_raw, slopes, (T*)out, W, H, KV,
      D, BS, MB, BQ, window, use_alibi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_chunk_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const int* block_table, const int* q_offset, const int* total_len,
    const void* k_raw, const void* v_raw, const float* slopes, void* out,
    int W, int H, int KV, int D, int BS, int MB, int BQ, int window,
    int use_alibi, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == rt::DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, block_table, q_offset,
                                 total_len, k_raw, v_raw, slopes, out, W, H,
                                 KV, D, BS, MB, BQ, window, use_alibi, s);
  return launch<float>(q, k_pool, v_pool, block_table, q_offset, total_len,
                       k_raw, v_raw, slopes, out, W, H, KV, D, BS, MB, BQ,
                       window, use_alibi, s);
}
