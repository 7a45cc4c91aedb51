// Chunk-prefill flash attention over the paged pool, for Hopper: bf16/f32
// pools and the int8 pool (one f32 scale per block and KV head).
//
// Replaces: repro/kernels/flash_attention.py :: flash_attention_chunk
//           (body _fa_chunk_kernel, page clamp _chunk_clamp), both the
//           quantized=False and the quantized=True branch.
//
// One chunk of W query tokens of ONE sequence, at absolute offset
// q_offset, attends to two key sources:
//   * the already-prefilled prefix [0, q_offset) in the paged pool, read
//     through the block table; the walk stops at ceil(q_offset / BS) pages
//     and masks k_pos < q_offset (stale table entries are never read).
//     An int8 pool is dequantized while its tile is staged into shared
//     memory (16 codes per 16-byte load, times the row's page scale: a
//     32-key tile spans two 16-token pages, so the scale is per row);
//   * the chunk's own raw K/V in the activation dtype (never
//     pool-roundtripped, as in the JAX package), causally, masked at
//     total_len.
// q_offset and total_len are read INSIDE the kernel from device int32
// scalars: no host sync, and one launch configuration serves every chunk.
//
// What bounds it on an H100: operations at a long prefix are still small
// (2 * 2 * W * H * D flops per key), so at the serving shape the kernel is
// bound by its own latency; the device-memory bytes (prefix K/V once per
// KV head, half as many in int8, plus the chunk's q/k/v/out) are a few MB
// per layer.
//
// Design: one thread block per (KV head, tile of BQ query tokens); the
// block holds its BQ * G query rows (all G heads of the KV head) and their
// f32 output accumulators in shared memory, stages 32 keys of K/V at a
// time (16-byte loads, all in flight at once), and runs an f32 online
// softmax per row (one warp per row) — the block helpers it shares with
// the static prefill kernel live in common.cuh.  Key tiles that no query
// of the block can see (causal, or past total_len) are skipped.  Plain
// CUDA-core FMAs: the tensor-core (wgmma) form is later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TK = 32;         // keys per staged tile

template <typename T, typename P>
__global__ void __launch_bounds__(THREADS) chunk_attention_kernel(
    const T* __restrict__ q, const P* __restrict__ k_pool,
    const float* __restrict__ k_scales, const P* __restrict__ v_pool,
    const float* __restrict__ v_scales, const int* __restrict__ block_table,
    const int* __restrict__ q_offset, const int* __restrict__ total_len,
    const T* __restrict__ k_raw, const T* __restrict__ v_raw,
    const float* __restrict__ slopes, T* __restrict__ out, int W, int H,
    int KV, int D, int BS, int MB, int BQ, int window, int use_alibi) {
  const int h = blockIdx.x, q0 = blockIdx.y * BQ;
  const int G = H / KV, R = BQ * G;
  extern __shared__ float sm[];
  const rt::AttnSmem s = rt::carve_attn_smem<TK>(sm, R, D);
  const int q_off = *q_offset, tlen = *total_len;
  const float scale = rsqrtf((float)D);

  rt::load_q_rows<T, THREADS>(q, s, R, G, D, H, h, q0, W);
  __syncthreads();

  // ---- pool prefix [0, q_offset): live pages only
  const int npool = min((q_off + BS - 1) / BS, MB);
  const int n_prefix = npool * BS;
  for (int k0 = 0; k0 < n_prefix; k0 += TK) {
    rt::load_kv_tile<P, THREADS>(
        k_pool, v_pool, k_scales, v_scales, s.ks, s.vs, TK, D,
        [&](int t) -> rt::KVRow {
          const int k_pos = k0 + t;
          if (k_pos >= n_prefix) return {-1, 0};   // past the live pages
          const long long blk = block_table[k_pos / BS];
          return {((blk * BS + k_pos % BS) * KV + h) * D, blk * KV + h};
        });
    __syncthreads();
    rt::attend_tile<THREADS, TK>(
        s, R, G, D, h, q_off + q0, k0, slopes, use_alibi, scale,
        [&](int q_pos, int k_pos) {
          return k_pos < q_off && (window <= 0 || q_pos - k_pos < window);
        });
  }

  // ---- the chunk's own raw keys at [q_offset, q_offset + W)
  const int q_last = min(q0 + BQ, W) - 1;
  for (int j0 = 0; j0 < W; j0 += TK) {
    if (j0 > q_last || q_off + j0 >= tlen) break;   // no query sees it
    rt::load_kv_tile<T, THREADS>(
        k_raw, v_raw, nullptr, nullptr, s.ks, s.vs, TK, D,
        [&](int t) -> rt::KVRow {
          const int j = j0 + t;
          return {j < W ? ((long long)j * KV + h) * D : -1, 0};
        });
    __syncthreads();
    rt::attend_tile<THREADS, TK>(
        s, R, G, D, h, q_off + q0, q_off + j0, slopes, use_alibi, scale,
        [&](int q_pos, int k_pos) {
          return k_pos < tlen && k_pos <= q_pos &&
                 (window <= 0 || q_pos - k_pos < window);
        });
  }

  rt::store_rows<T, THREADS>(out, s, R, G, D, H, h, q0, W);
}

template <typename T, typename P>
int launch(const void* q, const void* k_pool, const float* k_scales,
           const void* v_pool, const float* v_scales, const int* block_table,
           const int* q_offset, const int* total_len, const void* k_raw,
           const void* v_raw, const float* slopes, void* out, int W, int H,
           int KV, int D, int BS, int MB, int BQ, int window, int use_alibi,
           cudaStream_t stream) {
  static size_t granted = 0;
  const size_t smem = rt::attn_smem_bytes<TK>(BQ * (H / KV), D);
  cudaError_t e = rt::allow_smem(chunk_attention_kernel<T, P>, smem,
                                 &granted);
  if (e != cudaSuccess) return (int)e;
  if (W == 0) return (int)cudaGetLastError();
  dim3 grid(KV, (W + BQ - 1) / BQ);
  chunk_attention_kernel<T, P><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const P*)k_pool, k_scales, (const P*)v_pool, v_scales,
      block_table, q_offset, total_len, (const T*)k_raw, (const T*)v_raw,
      slopes, (T*)out, W, H, KV, D, BS, MB, BQ, window, use_alibi);
  return (int)cudaGetLastError();
}

}  // namespace

// Pools in the activation dtype.
extern "C" int flash_attention_chunk_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const int* block_table, const int* q_offset, const int* total_len,
    const void* k_raw, const void* v_raw, const float* slopes, void* out,
    int W, int H, int KV, int D, int BS, int MB, int BQ, int window,
    int use_alibi, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == rt::DTYPE_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, nullptr, v_pool, nullptr, block_table, q_offset,
        total_len, k_raw, v_raw, slopes, out, W, H, KV, D, BS, MB, BQ,
        window, use_alibi, s);
  return launch<float, float>(q, k_pool, nullptr, v_pool, nullptr,
                              block_table, q_offset, total_len, k_raw, v_raw,
                              slopes, out, W, H, KV, D, BS, MB, BQ, window,
                              use_alibi, s);
}

// int8 pools with [NB, KV] f32 scales; q, raw K/V and out in `dtype`.
extern "C" int flash_attention_chunk_int8_launch(
    int dtype, const void* q, const void* k_pool, const float* k_scales,
    const void* v_pool, const float* v_scales, const int* block_table,
    const int* q_offset, const int* total_len, const void* k_raw,
    const void* v_raw, const float* slopes, void* out, int W, int H, int KV,
    int D, int BS, int MB, int BQ, int window, int use_alibi, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == rt::DTYPE_BF16)
    return launch<__nv_bfloat16, int8_t>(
        q, k_pool, k_scales, v_pool, v_scales, block_table, q_offset,
        total_len, k_raw, v_raw, slopes, out, W, H, KV, D, BS, MB, BQ,
        window, use_alibi, s);
  return launch<float, int8_t>(q, k_pool, k_scales, v_pool, v_scales,
                               block_table, q_offset, total_len, k_raw,
                               v_raw, slopes, out, W, H, KV, D, BS, MB, BQ,
                               window, use_alibi, s);
}
