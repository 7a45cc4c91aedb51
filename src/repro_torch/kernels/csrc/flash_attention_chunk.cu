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
//     An int8 pool is dequantized on its way into shared memory, each
//     staged row times its own page's scale (a key tile spans pages);
//   * the chunk's own raw K/V in the activation dtype (never
//     pool-roundtripped, as in the JAX package), causally, masked at
//     total_len.
// q_offset and total_len are read INSIDE the kernel from device int32
// scalars: no host sync, and one launch configuration serves every chunk.
//
// What bounds it on an H100: the work is small either way.  A chunk of
// W = 256 queries after a prefix of P pooled keys does 2 * 2 * H * D
// flops per visible (query, key) pair (about 2.8 GFLOP at P = 768: 2.9 us
// at the 989 TFLOP/s bf16 peak) against (2 * W * H + 2 * W * KV + 2 * P *
// KV) * D * 2 bytes (about 2.8 MB: 0.8 us at 3.35 TB/s; the int8 prefix
// half as many).  So the bound is operations, and the kernel is in
// practice bound by its own latency: a few key tiles per block.
//
// bf16 (the serving type), head dim 64 or 128: tensor cores, the design
// of the static prefill kernel (flash_attention.cu).  One block of 4
// warps per (query head, tile of 64 query tokens); each warp holds 16
// query rows' Q fragments in registers and runs the FlashAttention-2 tile
// routine of mma_attention.cuh (mma.sync.m16n8k16, online softmax on the
// accumulators, P as the A operand in registers).  K/V tiles of 64 keys
// are staged by cp.async, two stages, so the next tile loads while this
// one is multiplied; the tiles walk the pooled prefix first, one block
// table lookup per staged row, then the chunk's raw keys.  Prefix rows at
// or past q_offset (hence every page past ceil(q_offset / BS)) and raw
// rows at or past total_len are zero-filled by cp.async and never read,
// so no masked tile makes NaN.  Only tiles that cross q_offset, the
// causal diagonal, total_len or the sliding window's edge pay for the
// mask; tiles outside the window or past every query's causal edge are
// never staged.  An int8 prefix tile is staged as codes plus one f32
// scale per row (a 64-key tile spans four 16-token pages), then
// dequantized to bf16 rows in shared memory (code x scale, one bf16
// rounding, as the plain version casts), and the tile routine runs
// unchanged.  The G heads of a KV head are separate blocks that re-read
// the same K/V tiles from the 50 MB L2.  Blocks of 2 warps (twice the
// grid) cost more device time at every chunk of the serve (PERF.md).
//
// f32 (a check path on the card, not serving): one block per (KV head,
// tile of BQ query tokens) holds all G grouped heads (BQ * G rows) and
// their f32 accumulators in shared memory and walks 32-key tiles on CUDA
// cores with the block helpers it shares with the static kernel
// (common.cuh); tensor cores would need TF32 and change the numbers.
#include "common.cuh"
#include "mma_attention.cuh"

namespace {

// ---------------------------------------------------------------- f32 body

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

// --------------------------------------------------- bf16 tensor-core body

constexpr int MMA_WARPS = 4;     // 16 query tokens each
constexpr int MMA_BK = 64;       // keys per staged tile
constexpr int MMA_STAGES = 2;

template <int D, typename P>
struct ChunkSmem {
  static_assert(D % 16 == 0, "rows are staged unpadded");
  static constexpr bool QUANT = std::is_same<P, int8_t>::value;
  static constexpr int STR = D + rt::MMA_ATTN_PAD;
  static constexpr size_t Q =
      sizeof(__nv_bfloat16) * 16 * MMA_WARPS * STR;
  static constexpr size_t KV =
      sizeof(__nv_bfloat16) * MMA_STAGES * 2 * MMA_BK * STR;
  static constexpr size_t CODES = QUANT ? MMA_STAGES * 2 * MMA_BK * D : 0;
  static constexpr size_t SCALES =
      QUANT ? sizeof(float) * MMA_STAGES * 2 * MMA_BK : 0;
  static constexpr size_t BYTES = Q + KV + CODES + SCALES;
};

template <int D, typename P>
__global__ void __launch_bounds__(32 * MMA_WARPS) chunk_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const P* __restrict__ k_pool,
    const float* __restrict__ k_scales, const P* __restrict__ v_pool,
    const float* __restrict__ v_scales, const int* __restrict__ block_table,
    const int* __restrict__ q_offset, const int* __restrict__ total_len,
    const __nv_bfloat16* __restrict__ k_raw,
    const __nv_bfloat16* __restrict__ v_raw,
    const float* __restrict__ slopes, __nv_bfloat16* __restrict__ out,
    int W, int H, int KV, int BS, int MB, int window, int use_alibi) {
  using L = ChunkSmem<D, P>;
  constexpr int NT = 32 * MMA_WARPS, BQ = 16 * MMA_WARPS, BK = MMA_BK;
  constexpr int STR = L::STR;
  const int h = blockIdx.x, warp = threadIdx.x >> 5;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int kvh = h / (H / KV);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kvs = qs + BQ * STR;   // [stage][K | V][BK][STR]
  int8_t* codes = reinterpret_cast<int8_t*>(smem_raw + L::Q + L::KV);
  float* scs = reinterpret_cast<float*>(smem_raw + L::Q + L::KV + L::CODES);
  const int q_off = *q_offset, tlen = *total_len;
  const int n_pool = min(q_off, MB * BS);   // pooled prefix keys
  const int n_raw = min(W, tlen - q_off);   // the chunk's live raw keys
  const float scale = rsqrtf((float)D);
  const float slope = use_alibi ? slopes[h] : 0.f;

  // the band of keys some query of this block can see: prefix tiles
  // [p_begin, p_end), then raw tiles [r_begin, r_end) (causal, < total_len)
  const int q_lo = q_off + q0;
  const int q_hi = q_off + min(q0 + BQ, W) - 1;
  const int k_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int p_begin = k_lo / BK, p_end = (n_pool + BK - 1) / BK;
  const int r_begin = max(0, k_lo - q_off) / BK;
  const int r_end = min(max(n_raw, 0) + BK - 1, q_hi - q_off + BK) / BK;
  const int np = max(0, p_end - p_begin);
  const int n_tiles = np + max(0, r_end - r_begin);

  auto stage = [&](int it, int s) {
    __nv_bfloat16* kd = kvs + (size_t)s * 2 * BK * STR;
    __nv_bfloat16* vd = kd + BK * STR;
    if (it < np) {
      const int k0 = (p_begin + it) * BK;
      auto row = [&](int r) -> rt::KVRow {
        const int k = k0 + r;
        if (k >= n_pool) return {-1, 0};   // past the prefix: zeros
        const long long blk = block_table[k / BS];
        return {((blk * BS + k % BS) * KV + kvh) * D, blk * KV + kvh};
      };
      if constexpr (L::QUANT) {
        int8_t* kc = codes + (size_t)s * 2 * BK * D;
        float* ksc = scs + s * 2 * BK;
        rt::stage_kv_codes<D, BK, NT>(kc, kc + BK * D, ksc, ksc + BK,
                                      k_pool, v_pool, k_scales, v_scales,
                                      row);
      } else {
        rt::stage_kv_rows<D, BK, NT>(kd, vd, k_pool, v_pool, row);
      }
    } else {
      const int j0 = (r_begin + it - np) * BK;
      rt::stage_kv_rows<D, BK, NT>(
          kd, vd, k_raw, v_raw, [&](int r) -> rt::KVRow {
            const int j = j0 + r;
            return {j < n_raw ? ((long long)j * KV + kvh) * D : -1, 0};
          });
    }
  };

  for (int i = threadIdx.x; i < BQ * (D / 8); i += NT) {
    const int r = i / (D / 8), c = i - r * (D / 8);
    const bool ok = q0 + r < W;
    rt::cp_async16(qs + r * STR + c * 8,
                   q + ((size_t)(ok ? q0 + r : 0) * H + h) * D + c * 8, ok);
  }
  if (n_tiles > 0) stage(0, 0);
  rt::cp_async_commit();

  rt::MmaAttnState<D> st;
  rt::mma_attn_init(st);
  const int q_pos0 = q_lo + warp * 16;
  auto row = [=](int g, int hi) {
    return rt::MmaRow{q_pos0 + g + hi * 8, slope};
  };
  auto in_window = [&](int q_pos, int k_pos) {
    return window <= 0 || q_pos - k_pos < window;
  };
  auto live_pool = [&](int q_pos, int k_pos) {
    return k_pos < n_pool && in_window(q_pos, k_pos);
  };
  auto live_raw = [&](int q_pos, int k_pos) {
    return k_pos < tlen && k_pos <= q_pos && in_window(q_pos, k_pos);
  };
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % MMA_STAGES;
    if (it + 1 < n_tiles) stage(it + 1, (it + 1) % MMA_STAGES);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();   // this tile (and Q) landed; the next flies
    __syncthreads();
    if (it == 0) rt::mma_attn_load_q(st, qs + warp * 16 * STR, STR);
    __nv_bfloat16* ks = kvs + (size_t)s * 2 * BK * STR;
    __nv_bfloat16* vs = ks + BK * STR;
    const bool pool = it < np;
    if constexpr (L::QUANT) {
      if (pool) {
        const int8_t* kc = codes + (size_t)s * 2 * BK * D;
        const float* ksc = scs + s * 2 * BK;
        rt::dequant_kv_rows<D, BK, NT>(ks, vs, kc, kc + BK * D, ksc,
                                       ksc + BK);
        __syncthreads();
      }
    }
    const int k0 = pool ? (p_begin + it) * BK
                        : q_off + (r_begin + it - np) * BK;
    // only tiles that cross q_offset, the causal diagonal, total_len or
    // the window's edge need the mask
    const bool win_edge = window > 0 && k0 < q_hi - window + 1;
    if (pool && (k0 + BK > n_pool || win_edge))
      rt::mma_attend_tile<D, BK, true>(st, ks, vs, STR, k0, scale, row,
                                       live_pool);
    else if (!pool && (k0 + BK - 1 > q_lo || k0 + BK > tlen || win_edge))
      rt::mma_attend_tile<D, BK, true>(st, ks, vs, STR, k0, scale, row,
                                       live_raw);
    else
      rt::mma_attend_tile<D, BK, false>(st, ks, vs, STR, k0, scale, row,
                                        live_raw);
    __syncthreads();          // every warp is done before the stage refills
  }
  rt::cp_async_wait<0>();

  rt::mma_attn_store(st, out + (size_t)h * D, (size_t)H * D, q0 + warp * 16,
                     W);
}

template <int D, typename P>
int launch_mma(const void* q, const void* k_pool, const float* k_scales,
               const void* v_pool, const float* v_scales,
               const int* block_table, const int* q_offset,
               const int* total_len, const void* k_raw, const void* v_raw,
               const float* slopes, void* out, int W, int H, int KV, int BS,
               int MB, int window, int use_alibi, cudaStream_t stream) {
  static size_t granted = 0;
  constexpr size_t smem = ChunkSmem<D, P>::BYTES;
  cudaError_t e = rt::allow_smem(chunk_attention_mma_kernel<D, P>, smem,
                                 &granted);
  if (e != cudaSuccess) return (int)e;
  if (W == 0) return (int)cudaGetLastError();
  dim3 grid(H, (W + 16 * MMA_WARPS - 1) / (16 * MMA_WARPS));
  chunk_attention_mma_kernel<D, P><<<grid, 32 * MMA_WARPS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const P*)k_pool, k_scales, (const P*)v_pool,
      v_scales, block_table, q_offset, total_len,
      (const __nv_bfloat16*)k_raw, (const __nv_bfloat16*)v_raw, slopes,
      (__nv_bfloat16*)out, W, H, KV, BS, MB, window, use_alibi);
  return (int)cudaGetLastError();
}

// The bf16 body for head dim D in {64, 128}; anything else is refused.
template <typename P>
int launch_bf16(int D, const void* q, const void* k_pool,
                const float* k_scales, const void* v_pool,
                const float* v_scales, const int* block_table,
                const int* q_offset, const int* total_len, const void* k_raw,
                const void* v_raw, const float* slopes, void* out, int W,
                int H, int KV, int BS, int MB, int window, int use_alibi,
                cudaStream_t s) {
#define CHUNK_MMA(DD)                                                      \
  if (D == DD)                                                             \
    return launch_mma<DD, P>(q, k_pool, k_scales, v_pool, v_scales,        \
                             block_table, q_offset, total_len, k_raw,      \
                             v_raw, slopes, out, W, H, KV, BS, MB, window, \
                             use_alibi, s);
  CHUNK_MMA(128)
  CHUNK_MMA(64)
#undef CHUNK_MMA
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename P>
int launch_f32(const void* q, const void* k_pool, const float* k_scales,
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

// Pools in the activation dtype.  BQ (query tokens per block) is read by
// the f32 body only; the bf16 body takes head dim 64 or 128 and refuses
// any other.
extern "C" int flash_attention_chunk_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const int* block_table, const int* q_offset, const int* total_len,
    const void* k_raw, const void* v_raw, const float* slopes, void* out,
    int W, int H, int KV, int D, int BS, int MB, int BQ, int window,
    int use_alibi, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == rt::DTYPE_BF16)
    return launch_bf16<__nv_bfloat16>(
        D, q, k_pool, nullptr, v_pool, nullptr, block_table, q_offset,
        total_len, k_raw, v_raw, slopes, out, W, H, KV, BS, MB, window,
        use_alibi, s);
  return launch_f32<float, float>(q, k_pool, nullptr, v_pool, nullptr,
                                  block_table, q_offset, total_len, k_raw,
                                  v_raw, slopes, out, W, H, KV, D, BS, MB,
                                  BQ, window, use_alibi, s);
}

// int8 pools with [NB, KV] f32 scales; q, raw K/V and out in `dtype`.
extern "C" int flash_attention_chunk_int8_launch(
    int dtype, const void* q, const void* k_pool, const float* k_scales,
    const void* v_pool, const float* v_scales, const int* block_table,
    const int* q_offset, const int* total_len, const void* k_raw,
    const void* v_raw, const float* slopes, void* out, int W, int H, int KV,
    int D, int BS, int MB, int BQ, int window, int use_alibi,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == rt::DTYPE_BF16)
    return launch_bf16<int8_t>(D, q, k_pool, k_scales, v_pool,
                               v_scales, block_table, q_offset, total_len,
                               k_raw, v_raw, slopes, out, W, H, KV, BS, MB,
                               window, use_alibi, s);
  return launch_f32<float, int8_t>(q, k_pool, k_scales, v_pool, v_scales,
                                   block_table, q_offset, total_len, k_raw,
                                   v_raw, slopes, out, W, H, KV, D, BS, MB,
                                   BQ, window, use_alibi, s);
}
