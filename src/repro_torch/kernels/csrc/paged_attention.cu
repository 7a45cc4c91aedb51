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
// cores would be the limit.  At the serving batch (8 rows, 3.7 MB) that
// is about 1 us: the kernel has to put the whole card on the walk, not
// make the products fast.
//
// As in the JAX package, ONE kernel body serves both pool formats, so the
// softmax loop cannot diverge between them: the pool element type P is a
// template parameter.
//
// bf16 (the serving type), head dim 64 or 128: a split page walk
// (flash-decoding) on the tensor cores, in ONE launch.
//   * Grid (sequence, KV head, split): each split walks pps pages (the
//     host's plan, kernels/paged_attention.py :: plan, from MB and BS
//     only; seq_lens stay on the device), so 8 rows x 2 KV heads x 8
//     splits = 128 blocks at the serving shape instead of 16.  A split
//     past the live pages ceil(seq_len / BS), or wholly outside the
//     sliding window, writes an empty partial and stages nothing.
//   * Inside a block, tiles of 64 keys are staged by cp.async (two
//     stages, one block-table lookup per row; rows past seq_len are
//     zero-filled, never read) and each of the 4 warps takes 16 keys of
//     the tile in turn.  A warp's mma rows are the G heads of the KV head
//     (padded to 16, G <= 16) at one position q_pos = seq_len - 1, each
//     with its own ALiBi slope (max(q_pos - k_pos, 0) = |q_pos - k_pos|
//     on every live key): S = Q K^T and P V are mma.sync.m16n8k16 with Q
//     in registers, through the tile routine of mma_attention.cuh.  Only
//     a warp tile that crosses seq_len or the window's edge pays for the
//     mask.  An int8 tile is staged as codes plus one f32 scale per row
//     and dequantized to bf16 in shared memory (one rounding).
//   * The warps' softmax states merge in shared memory; each block writes
//     its partial (m, l, o[G][D]) to an f32 scratch.  The last block of
//     a (sequence, KV head) to arrive, found by a device counter
//     (__threadfence, then atomicAdd), combines the partials in split
//     order -- deterministic, no atomics on values -- writes the output
//     and resets the counter, so the launch can be captured in a graph.
//     The scratch and counters are the wrapper's, allocated once per
//     device, stream and shape.  A counter found above zero at the start
//     of a launch makes some block arrive to a count of S or more, which
//     traps (a sticky launch failure, never a silent early combine).  A
//     row with seq_len 0 writes exact zeros.
//
// f32 (a check path on the card, not serving), any head dim <= 128 that
// is a multiple of 8: CUDA cores, one block per (sequence, KV head) that
// walks the live pages in 32-token tiles (16-byte loads, all in flight
// at once) and contracts each against all G grouped heads with an f32
// online softmax, one warp per head row; tensor cores would need TF32 and
// change the numbers.
#include "common.cuh"
#include "mma_attention.cuh"

namespace {

// ---------------------------------------------------------------- f32 body

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
int launch_f32(const void* q, const void* k_pool, const float* k_scales,
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

// --------------------------------------------------- bf16 tensor-core body

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_TK = 16;                    // keys per warp tile
constexpr int MMA_BK = MMA_TK * MMA_WARPS;    // keys per staged tile
constexpr int MMA_STAGES = 2;

template <int D, typename P>
struct PagedSmem {
  static_assert(D % 16 == 0, "rows are staged unpadded");
  static constexpr bool QUANT = std::is_same<P, int8_t>::value;
  static constexpr int STR = D + rt::MMA_ATTN_PAD;
  static constexpr size_t Q = sizeof(__nv_bfloat16) * 16 * STR;
  static constexpr size_t KV =
      sizeof(__nv_bfloat16) * MMA_STAGES * 2 * MMA_BK * STR;
  static constexpr size_t CODES = QUANT ? MMA_STAGES * 2 * MMA_BK * D : 0;
  static constexpr size_t SCALES =
      QUANT ? sizeof(float) * MMA_STAGES * 2 * MMA_BK : 0;
  static constexpr size_t BYTES = Q + KV + CODES + SCALES;
  // after the walk the K/V stages hold the warps' states, then the
  // combine's weights: 16 floats per split and 16 for the sums, which
  // bounds the splits a launch can take (575 at D 64; the host's planner
  // asks for far fewer)
  static constexpr size_t MERGE =
      sizeof(float) * MMA_WARPS * 16 * (D + 2);
  static constexpr int SPLIT_CAP = (int)(KV / (sizeof(float) * 16)) - 1;
  static_assert(MERGE <= KV, "merge buffer does not fit");
};

template <int D, typename P>
__global__ void __launch_bounds__(MMA_THREADS) paged_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const P* __restrict__ k_pool,
    const float* __restrict__ k_scales, const P* __restrict__ v_pool,
    const float* __restrict__ v_scales, const int* __restrict__ block_table,
    const int* __restrict__ seq_lens, const float* __restrict__ slopes,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part,
    int* __restrict__ counters, int H, int KV, int BS, int MB, int pps,
    int window, int use_alibi) {
  using L = PagedSmem<D, P>;
  constexpr int NT = MMA_THREADS, BK = MMA_BK, TK = MMA_TK, STR = L::STR;
  const int b = blockIdx.x, kvh = blockIdx.y, sp = blockIdx.z;
  const int S = gridDim.z, G = H / KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kvs = qs + 16 * STR;   // [stage][K | V][BK][STR]
  int8_t* codes = reinterpret_cast<int8_t*>(smem_raw + L::Q + L::KV);
  float* scs = reinterpret_cast<float*>(smem_raw + L::Q + L::KV + L::CODES);
  __shared__ int is_last;

  const int seq_len = seq_lens[b];
  const int q_pos = seq_len - 1;
  const float scale = rsqrtf((float)D);
  // this split's live keys [k_begin, k_end), walked from t_begin (the
  // window's first key, rounded down to a warp tile)
  const int k_begin = sp * pps * BS;
  const int k_end = min(min((sp + 1) * pps, MB) * BS, seq_len);
  const int k_lo = window > 0 ? max(k_begin, q_pos - window + 1) : k_begin;
  const int t_begin = k_begin + max(k_lo - k_begin, 0) / TK * TK;
  const int n_tiles = k_end > t_begin ? (k_end - t_begin + BK - 1) / BK : 0;

  auto stage = [&](int it, int s) {
    const int t0 = t_begin + it * BK;
    auto row = [&](int r) -> rt::KVRow {
      const int k = t0 + r;
      if (k >= k_end) return {-1, 0};   // past the split or seq_len: zeros
      const long long blk = block_table[(size_t)b * MB + k / BS];
      return {((blk * BS + k % BS) * KV + kvh) * D, blk * KV + kvh};
    };
    __nv_bfloat16* kd = kvs + (size_t)s * 2 * BK * STR;
    if constexpr (L::QUANT) {
      int8_t* kc = codes + (size_t)s * 2 * BK * D;
      float* ksc = scs + s * 2 * BK;
      rt::stage_kv_codes<D, BK, NT>(kc, kc + BK * D, ksc, ksc + BK, k_pool,
                                    v_pool, k_scales, v_scales, row);
    } else {
      rt::stage_kv_rows<D, BK, NT>(kd, kd + BK * STR, k_pool, v_pool, row);
    }
  };

  rt::MmaAttnState<D> st;
  rt::mma_attn_init(st);
  if (n_tiles > 0) {
    // the G query heads of this KV head, rows past G zero-filled
    for (int i = tid; i < 16 * (D / 8); i += NT) {
      const int r = i / (D / 8), c = i - r * (D / 8);
      const bool ok = r < G;
      rt::cp_async16(qs + r * STR + c * 8,
                     q + ((size_t)b * H + kvh * G + (ok ? r : 0)) * D + c * 8,
                     ok);
    }
    stage(0, 0);
    rt::cp_async_commit();
    const int g = lane >> 2;
    const float s_lo = use_alibi && g < G ? slopes[kvh * G + g] : 0.f;
    const float s_hi = use_alibi && g + 8 < G ? slopes[kvh * G + g + 8] : 0.f;
    auto row = [=](int, int hi) {
      return rt::MmaRow{q_pos, hi ? s_hi : s_lo};
    };
    auto live = [&](int qp, int k) {
      return k < k_end && (window <= 0 || qp - k < window);
    };
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % MMA_STAGES;
      if (it + 1 < n_tiles) stage(it + 1, (it + 1) % MMA_STAGES);
      rt::cp_async_commit();
      rt::cp_async_wait<1>();   // this tile (and Q) landed; the next flies
      __syncthreads();
      if (it == 0) rt::mma_attn_load_q(st, qs, STR);
      __nv_bfloat16* ks = kvs + (size_t)s * 2 * BK * STR;
      if constexpr (L::QUANT) {
        const int8_t* kc = codes + (size_t)s * 2 * BK * D;
        const float* ksc = scs + s * 2 * BK;
        rt::dequant_kv_rows<D, BK, NT>(ks, ks + BK * STR, kc, kc + BK * D,
                                       ksc, ksc + BK);
        __syncthreads();
      }
      // this warp's 16 keys, if any of them is live
      const int k0 = t_begin + it * BK + warp * TK;
      if (k0 < k_end && (window <= 0 || k0 + TK - 1 > q_pos - window)) {
        const __nv_bfloat16* kw = ks + warp * TK * STR;
        const __nv_bfloat16* vw = kw + BK * STR;
        if (k0 + TK > k_end || (window > 0 && k0 <= q_pos - window))
          rt::mma_attend_tile<D, TK, true>(st, kw, vw, STR, k0, scale, row,
                                           live);
        else
          rt::mma_attend_tile<D, TK, false>(st, kw, vw, STR, k0, scale, row,
                                            live);
      }
      __syncthreads();        // every warp is done before the stage refills
    }
    rt::cp_async_wait<0>();
  }

  // merge the warps' states: lane (g, t) holds rows g and g + 8
  float* mo = reinterpret_cast<float*>(kvs);   // [warp][16][D]
  float* mml = mo + MMA_WARPS * 16 * D;        // [warp][16][m, l]
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      const float l = rt::quad_sum(st.l[r]);
      if (row >= G) continue;
      float* o = mo + (warp * 16 + row) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j * 8] = st.o[j][2 * r];
        o[j * 8 + 1] = st.o[j][2 * r + 1];
      }
      if (t == 0) {
        mml[(warp * 16 + row) * 2] = st.m[r];
        mml[(warp * 16 + row) * 2 + 1] = l;
      }
    }
  }
  __syncthreads();
  // this block's partial; with one split it is the output
  const size_t seg = (size_t)G * (D + 2);      // one split's partial
  float* base = part + ((size_t)b * KV + kvh) * S * seg;
  __nv_bfloat16* ob = out + ((size_t)b * H + kvh * G) * D;
  for (int i = tid; i < G * D; i += NT) {
    const int gg = i / D, d = i - gg * D;
    float m = rt::NEG_INF;
    for (int w = 0; w < MMA_WARPS; ++w)
      if (mml[(w * 16 + gg) * 2 + 1] > 0.f)
        m = fmaxf(m, mml[(w * 16 + gg) * 2]);
    float l = 0.f, o = 0.f;
    for (int w = 0; w < MMA_WARPS; ++w) {
      const float lw = mml[(w * 16 + gg) * 2 + 1];
      if (lw > 0.f) {
        const float e = expf(mml[(w * 16 + gg) * 2] - m);
        l += lw * e;
        o += mo[(w * 16 + gg) * D + d] * e;
      }
    }
    if (S == 1) {
      ob[i] = __float2bfloat16(l > 0.f ? o / l : 0.f);
    } else {
      float* ps = base + (size_t)sp * seg;
      ps[2 * G + i] = o;
      if (d == 0) {
        ps[2 * gg] = m;
        ps[2 * gg + 1] = l;
      }
    }
  }
  if (S == 1) return;

  // the last block of this (sequence, KV head) to arrive combines
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int n = atomicAdd(counters + b * KV + kvh, 1);
    // a counter some earlier launch left above zero (one that died part
    // way, or one on another stream sharing the scratch) lets a count
    // pass S - 1: fail the launch loudly instead of combining too early
    if (n >= S) __trap();
    is_last = n == S - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  float* wsm = reinterpret_cast<float*>(kvs);  // [split][16] weights, [16] l
  for (int gg = tid; gg < G; gg += NT) {
    float m = rt::NEG_INF;
    for (int s = 0; s < S; ++s)
      if (__ldcg(base + s * seg + 2 * gg + 1) > 0.f)
        m = fmaxf(m, __ldcg(base + s * seg + 2 * gg));
    float l = 0.f;
    for (int s = 0; s < S; ++s) {
      const float ls = __ldcg(base + s * seg + 2 * gg + 1);
      const float w = ls > 0.f ? expf(__ldcg(base + s * seg + 2 * gg) - m)
                               : 0.f;
      wsm[s * 16 + gg] = w;
      l += ls * w;
    }
    wsm[S * 16 + gg] = l;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += NT) {
    const int gg = i / D;
    float o = 0.f;
    for (int s = 0; s < S; ++s) {
      const float w = wsm[s * 16 + gg];
      if (w != 0.f) o += w * __ldcg(base + s * seg + 2 * G + i);
    }
    const float l = wsm[S * 16 + gg];
    ob[i] = __float2bfloat16(l > 0.f ? o / l : 0.f);
  }
  if (tid == 0) counters[b * KV + kvh] = 0;   // ready for the next launch
}

template <int D, typename P>
int launch_mma(const void* q, const void* k_pool, const float* k_scales,
               const void* v_pool, const float* v_scales,
               const int* block_table, const int* seq_lens,
               const float* slopes, void* out, float* part, int* counters,
               int B, int H, int KV, int BS, int MB, int pps, int splits,
               int window, int use_alibi, cudaStream_t stream) {
  static size_t granted = 0;
  constexpr size_t smem = PagedSmem<D, P>::BYTES;
  cudaError_t e =
      rt::allow_smem(paged_attention_mma_kernel<D, P>, smem, &granted);
  if (e != cudaSuccess) return (int)e;
  if (H / KV > 16 || splits < 1 || splits > PagedSmem<D, P>::SPLIT_CAP ||
      (long long)splits * pps < MB || (splits > 1 && (!part || !counters)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  paged_attention_mma_kernel<D, P>
      <<<dim3(B, KV, splits), MMA_THREADS, smem, stream>>>(
          (const __nv_bfloat16*)q, (const P*)k_pool, k_scales,
          (const P*)v_pool, v_scales, block_table, seq_lens, slopes,
          (__nv_bfloat16*)out, part, counters, H, KV, BS, MB, pps, window,
          use_alibi);
  return (int)cudaGetLastError();
}

template <typename P>
int launch_bf16(int D, const void* q, const void* k_pool,
                const float* k_scales, const void* v_pool,
                const float* v_scales, const int* block_table,
                const int* seq_lens, const float* slopes, void* out,
                float* part, int* counters, int B, int H, int KV, int BS,
                int MB, int pps, int splits, int window, int use_alibi,
                cudaStream_t s) {
  if (D == 128)
    return launch_mma<128, P>(q, k_pool, k_scales, v_pool, v_scales,
                              block_table, seq_lens, slopes, out, part,
                              counters, B, H, KV, BS, MB, pps, splits,
                              window, use_alibi, s);
  if (D == 64)
    return launch_mma<64, P>(q, k_pool, k_scales, v_pool, v_scales,
                             block_table, seq_lens, slopes, out, part,
                             counters, B, H, KV, BS, MB, pps, splits, window,
                             use_alibi, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Pools in the activation dtype.  part / counters, pps (pages per split)
// and splits are read by the bf16 body (head dim 64 or 128; any other is
// refused): an f32 scratch of B * KV * splits * G * (D + 2) floats and
// B * KV int32 counters, zero at the first launch.  The f32 body ignores
// them.
extern "C" int paged_attention_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const int* block_table, const int* seq_lens, const float* slopes,
    void* out, float* part, int* counters, int B, int H, int KV, int D,
    int BS, int MB, int pps, int splits, int window, int use_alibi,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == rt::DTYPE_BF16)
    return launch_bf16<__nv_bfloat16>(
        D, q, k_pool, nullptr, v_pool, nullptr, block_table, seq_lens,
        slopes, out, part, counters, B, H, KV, BS, MB, pps, splits, window,
        use_alibi, s);
  return launch_f32<float, float>(q, k_pool, nullptr, v_pool, nullptr,
                                  block_table, seq_lens, slopes, out, B, H,
                                  KV, D, BS, MB, window, use_alibi, s);
}

// int8 pools with [NB, KV] f32 scales; q and out in `dtype`.
extern "C" int paged_attention_quant_launch(
    int dtype, const void* q, const void* k_values, const float* k_scales,
    const void* v_values, const float* v_scales, const int* block_table,
    const int* seq_lens, const float* slopes, void* out, float* part,
    int* counters, int B, int H, int KV, int D, int BS, int MB, int pps,
    int splits, int window, int use_alibi, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == rt::DTYPE_BF16)
    return launch_bf16<int8_t>(D, q, k_values, k_scales, v_values, v_scales,
                               block_table, seq_lens, slopes, out, part,
                               counters, B, H, KV, BS, MB, pps, splits,
                               window, use_alibi, s);
  return launch_f32<float, int8_t>(q, k_values, k_scales, v_values,
                                   v_scales, block_table, seq_lens, slopes,
                                   out, B, H, KV, D, BS, MB, window,
                                   use_alibi, s);
}
