// Static-offset flash attention for whole-prompt prefill, for Hopper.
//
// Replaces: repro/kernels/flash_attention.py :: flash_attention
//           (body _fa_kernel).
//
// q [B, Sq, H, D] at absolute positions q_offset + i (q_offset a host
// integer) attends to k / v [B, Sk, KV, D]: causal or not, an optional
// sliding band (q_pos - k_pos < window), ALiBi from positions, keys
// masked at k_pos < Sk, softmax online in f32.  With ALiBi and no causal
// mask the distance is |q_pos - k_pos|, the plain version's (under the
// causal mask the two coincide on every live key).
//
// What bounds it on an H100: operations.  A causal wave of B sequences of
// S tokens does about 2 * 2 * B * H * D * S^2 / 2 flops against
// (2 * H + 4 * KV) * B * S * D bytes of q/k/v/out — thousands of flops per
// byte at S = 960, far above the ~295 at which the bf16 tensor cores stop
// waiting on memory.
//
// bf16 (the serving type), head dim 64, 80, 120, 128 or 256: wgmma, TMA
// and warp specialisation (the Hopper primitives of hopper.cuh).  One block
// of 384 threads per (query head, sequence, tile of 128 query tokens): a
// producer warpgroup, of which one thread issues every TMA load (Q once,
// then K and V tiles of BK keys into a ring of two stages, K and V each
// with their own full and empty mbarriers, since K is free again after
// S = Q K^T and V only after P V), and two consumer warpgroups of 64
// query rows each; setmaxnreg moves registers from the producer (24 a
// thread) to the consumers (240).  A consumer runs S = Q K^T as wgmma
// m64nBKk16 with Q and K from shared memory (both K-major), the online
// softmax on the S accumulators in registers (exp2 with log2 e folded into
// the scale, row max and sum over the quad of lanes that holds a row, as
// in the mma.sync fragment whose layout the accumulators share), then casts
// P to bf16 in registers and runs O += P V as wgmma m64nDk16 with P as the
// register A operand and V from shared memory as an MN-major B (its rows
// are keys).  The products of one tile overlap the softmax of the next:
// turn i issues S_i and P_{i-1} V_{i-1}, then runs the softmax of S_i
// while P_{i-1} V_{i-1} is on the tensor cores; the two consumers take
// turns to issue (two named barriers), so one's softmax runs beside the
// other's products.  O stays in f32 registers to the end, is normalised
// and stored at D columns.  Rows are staged as boxes of 64 values (128
// bytes, swizzled 128 B), so a head of D values takes DP = D rounded up to
// 64 in shared memory: TMA writes zeros past D (and past Sq or Sk), so
// head dim 120 runs Q K^T as 8 k-steps over a zero pad and head dim 80 as
// 5 (the fifth from the second box), with no staging code; P V runs at
// N = D (80 and 120 are whole 8-column groups), and only D columns are
// stored.  BK is 128 keys up to head dim 128 and 64 at 256, where O alone
// is 128 registers a consumer thread; shared memory is Q (128 x DP) plus
// 2 stages of K and V (2 x BK x DP) bf16: 160 KB at DP 128, 192 KB at
// 256, one block per SM.  A call whose wide blocks would not fill the 132
// SMs once takes a narrow block instead (FaTile: one consumer over 64
// query tokens, 64 keys a stage, two blocks an SM up to head dim 128), as
// its time is its longest block's chain of tiles.  Blocks run by KV
// head: the G query heads of one query tile are adjacent blocks, which run
// together and read the same K / V tiles, then the KV head's other query
// tiles, heaviest (the last, under the causal mask) first, then the next
// (sequence, KV head).  One
// (sequence, KV head)'s K / V (3.9 MB at h2o-danube-3-4b's 8192 tokens)
// is then read from device memory about once and from the 50 MB L2 after,
// where a query-tile-major order streamed the whole wave's K / V (251 MB
// there) once for each query tile.  Key tiles outside the causal / sliding
// band of the block's queries are never loaded (the tile skip of the
// Pallas kernel); only tiles that cross the band's edge of a warpgroup's
// rows, or Sk, pay for the mask.  Without the causal mask (hubert-xlarge's
// encoder, ALiBi by |q_pos - k_pos|) every block walks every key tile.  No
// atomics and no split of the keys across blocks: two calls give the same
// bits.
//
// f32 (a check path on the card, not serving): the CUDA-core body shared
// with the chunk kernel (common.cuh), any head dim that is a multiple of
// 8; tensor cores would need TF32 and change the numbers.  One block per
// (sequence, KV head, tile of BQ query tokens) holds all G grouped heads
// (BQ * G rows) and loops over 32-key tiles.
#include "common.cuh"
#include "hopper.cuh"
#include "mma_attention.cuh"

namespace {

// ---------------------------------------------------------------- f32 body

constexpr int THREADS = 256;
constexpr int TK = 32;         // keys per staged tile

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ slopes,
    T* __restrict__ out, int Sq, int Sk, int H, int KV, int D, int BQ,
    int q_offset, int causal, int window, int use_alibi) {
  const int b = blockIdx.x / KV, h = blockIdx.x - b * KV;
  const int q0 = blockIdx.y * BQ;
  const int G = H / KV, R = BQ * G;
  extern __shared__ float sm[];
  const rt::AttnSmem s = rt::carve_attn_smem<TK>(sm, R, D);
  const float scale = rsqrtf((float)D);
  const size_t qb = (size_t)b * Sq * H * D;   // this sequence's q / out
  const size_t kb = (size_t)b * Sk * KV * D;  // and k / v

  rt::load_q_rows<T, THREADS>(q + qb, s, R, G, D, H, h, q0, Sq);
  __syncthreads();

  // the band of keys some query of this block can see
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) / TK * TK : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += TK) {
    rt::load_kv_tile<T, THREADS>(
        k + kb, v + kb, nullptr, nullptr, s.ks, s.vs, TK, D,
        [&](int t) -> rt::KVRow {
          const int j = k0 + t;
          return {j < Sk ? ((long long)j * KV + h) * D : -1, 0};
        });
    __syncthreads();
    rt::attend_tile<THREADS, TK>(
        s, R, G, D, h, q_lo, k0, slopes, use_alibi, scale,
        [&](int q_pos, int k_pos) {
          return k_pos < Sk && (!causal || k_pos <= q_pos) &&
                 (window <= 0 || q_pos - k_pos < window);
        });
  }

  rt::store_rows<T, THREADS>(out + qb, s, R, G, D, H, h, q0, Sq);
}

// --------------------------------------------------- bf16 tensor-core body

constexpr int WG = 128;                 // threads of a warpgroup
constexpr int MMA_BQ = 128;             // query tokens of a wide block
constexpr int PRODUCER_REGS = 24;
constexpr float LOG2E = 1.4426950408889634f;

// The tiles at head dim D.  A row of Q, K or V is staged as NC boxes of 64
// values (128 bytes, one swizzled row), DP = 64 x NC values in all; TMA
// writes zeros in the columns from D to DP.  The wide block (SMALL false)
// has two consumer warpgroups over 128 query tokens and BK 128 keys (64 at
// head dim 256); the narrow one, for a grid of fewer blocks than the card
// has SMs, one consumer over 64 query tokens and 64 keys a stage, two
// blocks to an SM where shared memory allows: a call that fills less than
// one wave of wide blocks is bound by its longest block's chain of tiles,
// which the narrow block shortens (its band is cut to 64-key tiles around
// 64 queries) while doubling the blocks.
template <int D, bool SMALL>
struct FaTile {
  static constexpr int DP = (D + 63) / 64 * 64;
  static constexpr int NC = DP / 64;
  static constexpr int NCW = SMALL ? 1 : 2;        // consumer warpgroups
  static constexpr int BQ = 64 * NCW;              // query tokens a block
  static constexpr int THREADS = WG * (1 + NCW);
  // blocks an SM holds (shared memory keeps the narrow block at head dim
  // 256 to one)
  static constexpr int MIN_BLOCKS = SMALL && D <= 128 ? 2 : 1;
  // setmaxnreg moves registers from the producer to the consumers: a
  // consumer thread takes what the block's 65,536 / MIN_BLOCKS leave
  // beside the producer's 24 (168 x 384 = 24 x 128 + 240 x 256; 128 x 256
  // = 24 x 128 + 232 x 128).  The narrow block at head dim 256 keeps the
  // 255 a thread it starts with (256 threads, one block an SM): its O
  // alone is 128 registers, more than a narrow block's 128 at entry, where
  // ptxas must fit each product's operands.
  static constexpr bool REBALANCE = MIN_BLOCKS == 2 || !SMALL;
  static constexpr int CONSUMER_REGS = SMALL ? 232 : 240;
  static_assert(!REBALANCE || CONSUMER_REGS % 8 == 0,
                "setmaxnreg takes a multiple of 8");
  static constexpr int BK = SMALL || D > 128 ? 64 : 128;   // keys a stage
  static constexpr int STAGES = 2;
  static constexpr int KSTEPS = (D + 15) / 16;    // k-steps of Q K^T
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;    // K or V of one stage
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  // slack to align the base to the 1024-byte swizzle atom, the tiles,
  // then the barriers: Q's, and full / empty of K and of V per stage
  static constexpr size_t SMEM = 1024 + BAR_OFF + 8 * (1 + 4 * STAGES);
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A consumer's online-softmax step over one tile of BK keys at k0.  s
// holds the thread's scores Q K^T (wgmma's layout: s[4j + e] is row
// q_pos = qp + 8 (e >> 1), key k_pos = k0 + 8j + 2t + (e & 1)); m / l are
// the running max (log2 units) and sum of its two rows.  The logit of a
// score is s x scale (1/sqrt(D) x log2 e), minus slope (ALiBi x log2 e) x
// |q_pos - k_pos| with ALIBI, NEG_INF where MASK and live() refuses the
// key; on an unmasked tile without ALiBi the max is taken on s and the
// scale folded into the exponent's FMA.  s then holds the unnormalised probabilities, alpha
// the rescale of O.
template <int BK, bool MASK, bool ALIBI, typename LiveFn>
__device__ __forceinline__ void fa_softmax(float* s, float* m, float* l,
                                           float* alpha, int qp, int k0,
                                           float scale, float slope,
                                           LiveFn live) {
  const int t = threadIdx.x & 3;
  const float dq = (float)(qp - k0 - 2 * t);   // exact below 2^24
  float mx[2] = {rt::NEG_INF, rt::NEG_INF};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float y = s[4 * j + e];
      if (ALIBI)
        y = fmaf(y, scale,
                 -slope * fabsf(dq + (float)(8 * (e >> 1) - 8 * j - (e & 1))));
      else if (MASK)
        y *= scale;
      if (MASK) {
        const int q_pos = qp + (e >> 1) * 8;
        if (!live(q_pos, k0 + j * 8 + 2 * t + (e & 1))) y = rt::NEG_INF;
      }
      s[4 * j + e] = y;
      mx[e >> 1] = fmaxf(mx[e >> 1], y);
    }
  // from y's units to log2 units.  A masked logit is exactly NEG_INF, so
  // its exp2 is 0 once the row has a live key (and exp2(0) before that,
  // which the first live key's alpha of 0 clears), never the exp2 of the
  // rounding residue of an FMA on NEG_INF x scale, which can overflow
  const float ys = ALIBI || MASK ? 1.f : scale;
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(m[r], rt::quad_max(mx[r]) * ys);
    alpha[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    s[i] = ex2(fmaf(s[i], ys, -mx[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

template <int D, bool SMALL>
__global__ void __launch_bounds__(FaTile<D, SMALL>::THREADS,
                                  FaTile<D, SMALL>::MIN_BLOCKS)
    flash_attention_mma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const float* __restrict__ slopes,
    __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H, int KV,
    int q_offset, int causal, int window, int use_alibi) {
  namespace hp = rt::hopper;
  using T = FaTile<D, SMALL>;
  constexpr int ST = T::STAGES;
  // blocks in launch order: the G query heads of a KV head side by side,
  // then its query tiles heaviest (last) first, then the next (sequence,
  // KV head): the blocks that read one K / V run together, so it is read
  // from device memory about once and from L2 after
  const int G = H / KV, nq = (Sq + T::BQ - 1) / T::BQ;
  const int kvh = blockIdx.x / (G * nq) % KV, b = blockIdx.x / (G * nq * KV);
  const int h = kvh * G + blockIdx.x % G;
  const int q0 = (nq - 1 - blockIdx.x / G % nq) * T::BQ;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qs = (hp::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t kvs = qs + T::Q_BYTES;   // [stage][K | V][box][BK][64]
  const uint32_t bar_q = qs + T::BAR_OFF;
  const uint32_t k_full = bar_q + 8, k_empty = k_full + 8 * ST;
  const uint32_t v_full = k_empty + 8 * ST, v_empty = v_full + 8 * ST;

  // the band of keys some query of this block can see, in tiles of BK
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + T::BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int k_begin =
      window > 0 ? max(0, q_lo - window + 1) / T::BK * T::BK : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin - 1) / T::BK + 1 : 0;

  if (n_tiles == 0) {
    // no key in the band (an empty Sk, or a window past its end): zeros,
    // before any barrier or load is set up
    for (int i = threadIdx.x; i < T::BQ * D; i += T::THREADS) {
      const int tok = q0 + i / D;
      if (tok < Sq)
        out[((size_t)(b * Sq + tok) * H + h) * D + i % D] =
            __float2bfloat16(0.f);
    }
    return;
  }
  if (threadIdx.x == 0) {
    hp::mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      hp::mbar_init(k_full + 8 * s, 1);
      hp::mbar_init(v_full + 8 * s, 1);
      hp::mbar_init(k_empty + 8 * s, T::NCW * WG);
      hp::mbar_init(v_empty + 8 * s, T::NCW * WG);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < WG) {
    // producer: one thread keeps TMA loads in flight, K and V of a tile
    // each with their own barriers (K is released after S, V after P V)
    if constexpr (T::REBALANCE) hp::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hp::prefetch_map(&tk);
      hp::prefetch_map(&tv);
      hp::mbar_arrive_expect_tx(bar_q, T::Q_BYTES);
      for (int c = 0; c < T::NC; ++c)
        hp::tma_load_4d(qs + c * T::BQ * 128, &tq, bar_q, 64 * c, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST, k0 = k_begin + i * T::BK;
        const uint32_t ks = kvs + s * 2 * T::KV_BYTES;
        const uint32_t parity = ((i / ST) & 1) ^ 1;
        hp::mbar_wait(k_empty + 8 * s, parity);
        hp::mbar_arrive_expect_tx(k_full + 8 * s, T::KV_BYTES);
        for (int c = 0; c < T::NC; ++c)
          hp::tma_load_4d(ks + c * T::BK * 128, &tk, k_full + 8 * s, 64 * c,
                          kvh, k0, b);
        hp::mbar_wait(v_empty + 8 * s, parity);
        hp::mbar_arrive_expect_tx(v_full + 8 * s, T::KV_BYTES);
        for (int c = 0; c < T::NC; ++c)
          hp::tma_load_4d(ks + T::KV_BYTES + c * T::BK * 128, &tv,
                          v_full + 8 * s, 64 * c, kvh, k0, b);
      }
    }
  } else {
    // consumers: warpgroup cw owns the block's query rows 64 cw .. + 63
    if constexpr (T::REBALANCE) hp::setmaxnreg_inc<T::CONSUMER_REGS>();
    const int ct = threadIdx.x - WG, cw = ct / WG;
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const int r0 = cw * 64 + ((ct % WG) >> 5) * 16 + g;   // rows r0, r0 + 8
    const int qp = q_lo + r0;
    const int w_lo = q_lo + cw * 64;
    const int w_hi = q_offset + min(q0 + cw * 64 + 64, Sq) - 1;
    const float scale = rsqrtf((float)D) * LOG2E;
    const float slope = use_alibi ? slopes[h] * LOG2E : 0.f;
    auto live = [&](int q_pos, int k_pos) {
      return k_pos < Sk && (!causal || k_pos <= q_pos) &&
             (window <= 0 || q_pos - k_pos < window);
    };
    float o[D / 2], sc[T::BK / 2];
    uint32_t pa[T::BK / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {rt::NEG_INF, rt::NEG_INF}, l[2] = {0.f, 0.f};
    const uint32_t qa = qs + cw * 64 * 128;
    hp::mbar_wait(bar_q, 0);

    auto issue_s = [&](int i) {
      // S = Q K^T, both K-major; k-step kk is 16 columns of box kk / 4
      const uint32_t ks = kvs + (i % ST) * 2 * T::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < T::KSTEPS; ++kk)
        hp::Wgmma<T::BK>::template ss<0>(
            sc,
            hp::desc_sw128(qa + (kk >> 2) * T::BQ * 128 + (kk & 3) * 32, 16,
                           1024),
            hp::desc_sw128(ks + (kk >> 2) * T::BK * 128 + (kk & 3) * 32, 16,
                           1024),
            kk > 0);
      hp::wgmma_commit();
    };
    auto issue_pv = [&](int i) {
      // O += P V: P the register A operand (the S accumulators of keys
      // 16c .. 16c + 15 are the A fragment of k-step c), V MN-major
      const uint32_t vs = kvs + (i % ST) * 2 * T::KV_BYTES + T::KV_BYTES;
#pragma unroll
      for (int c = 0; c < T::BK / 16; ++c)
        hp::Wgmma<D>::template rs<1>(
            o, pa[c], hp::desc_sw128(vs + c * 16 * 128, T::BK * 128, 1024),
            1);
      hp::wgmma_commit();
    };
    auto softmax = [&](int i, float* alpha) {
#pragma unroll
      for (int j = 0; j < T::BK / 2; ++j) hp::fence_reg(sc[j]);
      hp::mbar_arrive(k_empty + 8 * (i % ST));
      // only tiles that cross Sk or the causal / sliding edge of this
      // warpgroup's rows need the mask
      const int k0 = k_begin + i * T::BK;
      const bool edge = k0 + T::BK > Sk ||
                        (causal && k0 + T::BK - 1 > w_lo) ||
                        (window > 0 && k0 < w_hi - window + 1);
      if (edge) {
        if (use_alibi)
          fa_softmax<T::BK, true, true>(sc, m, l, alpha, qp, k0, scale,
                                        slope, live);
        else
          fa_softmax<T::BK, true, false>(sc, m, l, alpha, qp, k0, scale,
                                         slope, live);
      } else {
        if (use_alibi)
          fa_softmax<T::BK, false, true>(sc, m, l, alpha, qp, k0, scale,
                                         slope, live);
        else
          fa_softmax<T::BK, false, false>(sc, m, l, alpha, qp, k0, scale,
                                          slope, live);
      }
    };
    auto pv_done = [&](int i) {
#pragma unroll
      for (int j = 0; j < D / 2; ++j) hp::fence_reg(o[j]);
#pragma unroll
      for (int c = 0; c < T::BK / 16; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) hp::fence_reg(pa[c][e]);
      hp::mbar_arrive(v_empty + 8 * (i % ST));
    };
    auto next_p = [&](const float* alpha) {
      // P V of the last tile is done: rescale O to this tile's max and
      // round P to bf16 for the next turn
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
#pragma unroll
      for (int c = 0; c < T::BK / 16; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[c][e] = rt::pack_bf16(sc[8 * c + 2 * e], sc[8 * c + 2 * e + 1]);
    };

    // Turn i issues S_i = Q K_i^T and O += P_{i-1} V_{i-1}, then runs the
    // softmax of S_i while P_{i-1} V_{i-1} is on the tensor cores (the
    // first turn has no P V, the last no S).  The two warpgroups take
    // turns to issue (named barrier 1 + cw is warpgroup cw's turn; the
    // second gives the first its first turn, and takes no arrival back
    // after its own last), so one's softmax runs beside the other's
    // products.  Every wgmma of a turn is issued on every path: ptxas
    // serialises wgmma that sits in a branch.
    const int n = n_tiles;
    float alpha[2];
    auto take_turn = [&] {
      if constexpr (T::NCW == 2) hp::named_sync(1 + cw, 2 * WG);
    };
    auto pass_turn = [&](bool last) {
      // the second consumer takes no arrival back after its last turn
      if constexpr (T::NCW == 2)
        if (!last || cw == 0) hp::named_arrive(2 - cw, 2 * WG);
    };
    if constexpr (T::NCW == 2)
      if (cw == 1) hp::named_arrive(1, 2 * WG);
    hp::mbar_wait(k_full, 0);
    take_turn();
    hp::wgmma_fence();
    issue_s(0);
    pass_turn(false);
    hp::wgmma_wait<0>();
    softmax(0, alpha);
    next_p(alpha);
    for (int i = 1; i < n; ++i) {
      hp::mbar_wait(k_full + 8 * (i % ST), (i / ST) & 1);
      hp::mbar_wait(v_full + 8 * ((i - 1) % ST), ((i - 1) / ST) & 1);
      take_turn();
      hp::wgmma_fence();
      issue_s(i);
      issue_pv(i - 1);
      pass_turn(false);
      hp::wgmma_wait<1>();
      softmax(i, alpha);
      hp::wgmma_wait<0>();
      pv_done(i - 1);
      next_p(alpha);
    }
    hp::mbar_wait(v_full + 8 * ((n - 1) % ST), ((n - 1) / ST) & 1);
    take_turn();
    hp::wgmma_fence();
    issue_pv(n - 1);
    pass_turn(true);
    hp::wgmma_wait<0>();
    pv_done(n - 1);

    // normalise and store the thread's two rows (D columns)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tok = q0 + r0 + 8 * r;
      const float inv = 1.f / fmaxf(rt::quad_sum(l[r]), 1e-30f);
      if (tok >= Sq) continue;
      __nv_bfloat16* row = out + ((size_t)(b * Sq + tok) * H + h) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + j * 8) =
            rt::pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

// q, k or v [B, S, heads, D] as a TMA tensor map: boxes of 64 values of
// one head over `rows` tokens (an empty S is given one row, never read).
int fa_map(CUtensorMap* map, const void* p, int B, int S, int heads, int D,
           int rows) {
  const cuuint64_t n = S > 0 ? (cuuint64_t)S : 1;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, n,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * heads,
                                 2ull * D * heads * n};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return rt::hopper::encode_bf16_sw128(map, p, 4, dims, strides, box);
}

template <int D, bool SMALL>
int launch_tiles(const void* q, const void* k, const void* v,
                 const float* slopes, void* out, int B, int Sq, int Sk, int H,
                 int KV, int q_offset, int causal, int window, int use_alibi,
                 cudaStream_t stream) {
  using T = FaTile<D, SMALL>;
  static size_t granted = 0;
  cudaError_t e = rt::allow_smem(flash_attention_mma_kernel<D, SMALL>,
                                 T::SMEM, &granted);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tq, tk, tv;
  int r = fa_map(&tq, q, B, Sq, H, D, T::BQ);
  if (r == 0) r = fa_map(&tk, k, B, Sk, KV, D, T::BK);
  if (r == 0) r = fa_map(&tv, v, B, Sk, KV, D, T::BK);
  if (r != 0) return r;
  const int blocks = B * H * ((Sq + T::BQ - 1) / T::BQ);
  flash_attention_mma_kernel<D, SMALL>
      <<<blocks, T::THREADS, T::SMEM, stream>>>(
          tq, tk, tv, slopes, (__nv_bfloat16*)out, Sq, Sk, H, KV, q_offset,
          causal, window, use_alibi);
  return (int)cudaGetLastError();
}

// The wide block, or the narrow one where the wide blocks would not fill
// the card's SMs once.
template <int D>
int launch_mma(const void* q, const void* k, const void* v,
               const float* slopes, void* out, int B, int Sq, int Sk, int H,
               int KV, int q_offset, int causal, int window, int use_alibi,
               cudaStream_t stream) {
  if (B == 0 || Sq == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long wide = (long long)B * H * ((Sq + MMA_BQ - 1) / MMA_BQ);
  return wide < sms ? launch_tiles<D, true>(q, k, v, slopes, out, B, Sq, Sk,
                                            H, KV, q_offset, causal, window,
                                            use_alibi, stream)
                    : launch_tiles<D, false>(q, k, v, slopes, out, B, Sq,
                                             Sk, H, KV, q_offset, causal,
                                             window, use_alibi, stream);
}

int launch_f32(const void* q, const void* k, const void* v,
               const float* slopes, void* out, int B, int Sq, int Sk, int H,
               int KV, int D, int BQ, int q_offset, int causal, int window,
               int use_alibi, cudaStream_t stream) {
  static size_t granted = 0;
  const size_t smem = rt::attn_smem_bytes<TK>(BQ * (H / KV), D);
  cudaError_t e =
      rt::allow_smem(flash_attention_kernel<float>, smem, &granted);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || Sq == 0) return (int)cudaGetLastError();
  dim3 grid(B * KV, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<float><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, slopes,
      (float*)out, Sq, Sk, H, KV, D, BQ, q_offset, causal, window,
      use_alibi);
  return (int)cudaGetLastError();
}

}  // namespace

// BQ (query tokens per block) is read by the f32 body only; the bf16 body
// takes head dim 64, 80, 120, 128 or 256 and refuses any other.
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v,
    const float* slopes, void* out, int B, int Sq, int Sk, int H, int KV,
    int D, int BQ, int q_offset, int causal, int window, int use_alibi,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == rt::DTYPE_BF16) {
    if (D == 256)
      return launch_mma<256>(q, k, v, slopes, out, B, Sq, Sk, H, KV,
                             q_offset, causal, window, use_alibi, s);
    if (D == 128)
      return launch_mma<128>(q, k, v, slopes, out, B, Sq, Sk, H, KV,
                             q_offset, causal, window, use_alibi, s);
    if (D == 120)
      return launch_mma<120>(q, k, v, slopes, out, B, Sq, Sk, H, KV,
                             q_offset, causal, window, use_alibi, s);
    if (D == 80)
      return launch_mma<80>(q, k, v, slopes, out, B, Sq, Sk, H, KV,
                            q_offset, causal, window, use_alibi, s);
    if (D == 64)
      return launch_mma<64>(q, k, v, slopes, out, B, Sq, Sk, H, KV,
                            q_offset, causal, window, use_alibi, s);
    return (int)cudaErrorInvalidValue;
  }
  return launch_f32(q, k, v, slopes, out, B, Sq, Sk, H, KV, D, BQ, q_offset,
                    causal, window, use_alibi, s);
}
