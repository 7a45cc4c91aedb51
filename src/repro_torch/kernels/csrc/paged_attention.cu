// Paged decode attention (Opt-GQA over block tables) for Hopper, over the
// bf16/f32 pool and over the int8 pool.
//
// Replaces: repro/kernels/paged_attention.py :: paged_attention
//           (body _pa_kernel, page clamp _clamp_live), bf16/f32 pools, and
//           repro/kernels/paged_attention_quant.py :: paged_attention_quant
//           (the same body with quantized=True), int8 pools.
//
// What bounds it on an H100: bytes.  Each decode row reads its live K and
// V pages once (seq_len * KV * D * 2 tensors * 2 bytes in bf16; 1 byte in
// int8, plus one f32 scale per page and KV head) and does about 4 * G
// flops per byte read, far below the ~295 flop/byte at which the tensor
// cores would be the limit.
//
// As in the JAX package, ONE kernel body serves both pool formats, so the
// softmax loop cannot diverge between them: the pool element type P is a
// template parameter apart from the activation type T.  In int8 the tile
// is dequantized while it is staged into shared memory: 16 codes per
// 16-byte load, times the scale of the row's page (a 32-token tile spans
// two 16-token pages, so the scale is taken per row).
//
// Design: one thread block per (sequence, KV head).  The block reads its
// own block_table row and seq_len, walks ONLY the live pages
// ceil(seq_len / BS) (stale table entries past them are never read, and
// seq_len == 0 writes zeros), stages 32 tokens of K/V at a time in shared
// memory (16-byte loads, all in flight at once) and contracts them
// against all G grouped query heads of the KV head at once, so each K/V
// byte is read from device memory once for G heads.  Softmax is online in
// f32: one warp per head row updates the running max / sum in shared
// memory; the output accumulators sit in registers, one output column
// per thread.  Known limit: B x KV blocks (16 at the serving shape) fill 16
// of the 132 SMs; splitting the page walk across blocks (flash-decoding)
// is the first target of a later PR.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;   // one output column per thread: D <= 128
constexpr int MAX_G = 16;      // query heads per KV head held in registers

template <typename T, typename P>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(
    const T* __restrict__ q, const P* __restrict__ k_pool,
    const float* __restrict__ k_scales, const P* __restrict__ v_pool,
    const float* __restrict__ v_scales, const int* __restrict__ block_table,
    const int* __restrict__ seq_lens, const float* __restrict__ slopes,
    T* __restrict__ out, int H, int KV, int D, int BS, int MB, int TP,
    int window, int use_alibi) {
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int G = H / KV;
  const int TT = TP * BS;      // tokens per staged tile
  const int DP = D + 1;        // padded row stride: conflict-free dots
  extern __shared__ float sm[];
  float* qs = sm;              // [G][DP]
  float* ks = qs + G * DP;     // [TT][DP]
  float* vs = ks + TT * DP;    // [TT][D]
  float* ss = vs + TT * D;     // [G][TT] scores, then probabilities
  float* m_s = ss + G * TT;    // [G] running max
  float* l_s = m_s + G;        // [G] running sum
  float* a_s = l_s + G;        // [G] this tile's rescale factor

  const int seq_len = seq_lens[b];
  const int npages = (seq_len + BS - 1) / BS;   // live pages only
  const int q_pos = seq_len - 1;
  const float scale = rsqrtf((float)D);

  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i - g * D;
    qs[g * DP + d] = rt::to_f32(q[((size_t)b * H + h * G + g) * D + d]);
  }
  if (tid < G) {
    m_s[tid] = rt::NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;
  __syncthreads();

  for (int p0 = 0; p0 < npages; p0 += TP) {
    rt::load_kv_tile<P, THREADS>(
        k_pool, v_pool, k_scales, v_scales, ks, vs, TT, D,
        [&](int t) -> rt::KVRow {
          const int page = p0 + t / BS;
          if (page >= npages) return {-1, 0};   // past the live pages
          const long long blk = block_table[(size_t)b * MB + page];
          return {((blk * BS + t % BS) * KV + h) * D, blk * KV + h};
        });
    __syncthreads();
    for (int i = tid; i < G * TT; i += THREADS) {
      const int g = i / TT, t = i - g * TT;
      const int k_pos = p0 * BS + t;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += qs[g * DP + d] * ks[t * DP + d];
      s *= scale;
      if (use_alibi) s -= slopes[h * G + g] * (float)max(q_pos - k_pos, 0);
      bool live = k_pos < seq_len;
      if (window > 0) live = live && k_pos > q_pos - window;
      ss[g * TT + t] = live ? s : rt::NEG_INF;
    }
    __syncthreads();
    for (int g = tid >> 5; g < G; g += THREADS / 32)
      rt::warp_softmax_row(ss + g * TT, TT, m_s + g, l_s + g, a_s + g);
    __syncthreads();
    if (tid < D) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          float a = acc[g] * a_s[g];
          for (int t = 0; t < TT; ++t) a += ss[g * TT + t] * vs[t * D + tid];
          acc[g] = a;
        }
      }
    }
    __syncthreads();
  }
  if (tid < D) {
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        out[((size_t)b * H + h * G + g) * D + tid] =
            rt::from_f32<T>(acc[g] / fmaxf(l_s[g], 1e-30f));
      }
    }
  }
}

template <typename T, typename P>
int launch(const void* q, const void* k_pool, const float* k_scales,
           const void* v_pool, const float* v_scales, const int* block_table,
           const int* seq_lens, const float* slopes, void* out, int B, int H,
           int KV, int D, int BS, int MB, int window, int use_alibi,
           cudaStream_t stream) {
  static size_t granted = 0;
  const int G = H / KV;
  const int TP = BS >= 32 ? 1 : 32 / BS;
  const int TT = TP * BS;
  const size_t smem =
      sizeof(float) * ((size_t)G * (D + 1) + (size_t)TT * (D + 1) +
                       (size_t)TT * D + (size_t)G * TT + 3 * (size_t)G);
  cudaError_t e = rt::allow_smem(paged_attention_kernel<T, P>, smem,
                                 &granted);
  if (e != cudaSuccess) return (int)e;
  if (B == 0) return (int)cudaGetLastError();
  paged_attention_kernel<T, P><<<dim3(B, KV), THREADS, smem, stream>>>(
      (const T*)q, (const P*)k_pool, k_scales, (const P*)v_pool, v_scales,
      block_table, seq_lens, slopes, (T*)out, H, KV, D, BS, MB, TP, window,
      use_alibi);
  return (int)cudaGetLastError();
}

}  // namespace

// Pools in the activation dtype.
extern "C" int paged_attention_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const int* block_table, const int* seq_lens, const float* slopes,
    void* out, int B, int H, int KV, int D, int BS, int MB, int window,
    int use_alibi, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == rt::DTYPE_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, nullptr, v_pool, nullptr, block_table, seq_lens, slopes,
        out, B, H, KV, D, BS, MB, window, use_alibi, s);
  return launch<float, float>(q, k_pool, nullptr, v_pool, nullptr,
                              block_table, seq_lens, slopes, out, B, H, KV,
                              D, BS, MB, window, use_alibi, s);
}

// int8 pools with [NB, KV] f32 scales; q and out in `dtype`.
extern "C" int paged_attention_quant_launch(
    int dtype, const void* q, const void* k_values, const float* k_scales,
    const void* v_values, const float* v_scales, const int* block_table,
    const int* seq_lens, const float* slopes, void* out, int B, int H,
    int KV, int D, int BS, int MB, int window, int use_alibi, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == rt::DTYPE_BF16)
    return launch<__nv_bfloat16, int8_t>(
        q, k_values, k_scales, v_values, v_scales, block_table, seq_lens,
        slopes, out, B, H, KV, D, BS, MB, window, use_alibi, s);
  return launch<float, int8_t>(q, k_values, k_scales, v_values, v_scales,
                               block_table, seq_lens, slopes, out, B, H, KV,
                               D, BS, MB, window, use_alibi, s);
}
