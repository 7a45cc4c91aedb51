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
// bf16 (the serving type), head dim 64, 80, 120, 128 or 256: tensor cores.  One
// block of 4 warps per (query head, sequence, tile of 64 query tokens);
// each warp owns 16 query rows and runs the FlashAttention-2 tile routine
// of mma_attention.cuh (mma.sync.m16n8k16, Q in registers, online softmax
// in registers, P kept in registers as the A operand of P V).  K/V tiles of
// 64 keys are staged in shared memory as bf16 by cp.async, two stages, so
// the next tile loads while this one is multiplied.  mma.sync rather than
// wgmma: its per-warp fragments need no warpgroup-wide shared-memory
// descriptors or swizzled layouts, so the whole routine is checked on the
// card in one call; wgmma's 64-row warpgroup tile is later work.  The G
// query heads of a KV head are separate blocks that read the same K/V
// tiles: the whole wave's K/V (7.9 MB at [8, 960, 2, 128]) stays in the
// 50 MB L2, which serves the reuse.  Blocks are ordered heaviest first
// (the last query tiles see the most keys under the causal mask) so the
// triangle balances across the 132 SMs.  Key tiles outside the causal /
// sliding band of the block's queries are never loaded (the tile skip of
// the Pallas kernel); only tiles that cross the band's edge or Sk pay for
// the mask.  Head dim 120 (h2o-danube-3-4b) is staged padded to 128 with
// zero columns (mma_attention.cuh): global memory is read and written at
// exactly 120 values a row (240 bytes, still fifteen 16-byte vectors), and
// the extra k-step of Q K^T costs 1/16 of its products.  Head dim 256
// (recurrentgemma-2b, 10 query heads over 1 KV head) keeps the same tiles:
// O's accumulators alone take 128 registers a thread there, so Q's
// fragments are read from the staged Q at each k-step instead of held
// (mma_q_in_regs), and the block's shared memory is (64 + 2 x 2 x 64)
// rows of 264 bf16 = 168,960 bytes, one block per SM.  Its ten query
// heads are ten blocks over the same K/V tiles, which L2 serves.  Head dim
// 80 (hubert-xlarge, an encoder: 16 query heads over 16 KV heads, not
// causal, ALiBi) is five k-steps of 16, so it runs unpadded: Q K^T takes
// 5 k-steps and P V 10 C tiles of 8 columns, where padding to 128 would
// spend 3/8 of both products on zeros.  Its staged rows are 80 + 8 = 88
// bf16 = 176 bytes = 11 16-byte chunks, an odd count, so the 8 rows of an
// ldmatrix 8 x 8 matrix fall in 8 distinct bank groups, as at 128 + 8.
// Without the causal mask every block walks every key tile (k_end = Sk),
// so the heaviest-first order does nothing there, and only the tile that
// crosses Sk pays for the mask.
//
// f32 (a check path on the card, not serving): the CUDA-core body shared
// with the chunk kernel (common.cuh), any head dim that is a multiple of
// 8; tensor cores would need TF32 and change the numbers.  One block per
// (sequence, KV head, tile of BQ query tokens) holds all G grouped heads
// (BQ * G rows) and loops over 32-key tiles.
#include "common.cuh"
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

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_BQ = 16 * MMA_WARPS;   // query tokens per block
constexpr int MMA_BK = 64;               // keys per staged tile
constexpr int MMA_STAGES = 2;

// shared row stride of a head of D values: padded to 16, plus the pad
template <int D>
__host__ __device__ constexpr int mma_stride() {
  return rt::mma_padded(D) + rt::MMA_ATTN_PAD;
}

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * mma_stride<D>() *
         (MMA_BQ + 2 * MMA_STAGES * MMA_BK);
}

// Copy rows tok0 .. tok0 + ROWS of one head out of x [.., n, heads, D]
// (base already at the sequence and head) into shared rows of STR values;
// rows at or past n, and the columns from D to the padded width, are
// zero-filled (nothing is read for them).
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* x,
                                           size_t row_stride, int tok0,
                                           int n) {
  constexpr int CH = rt::mma_padded(D) / 8, STR = mma_stride<D>();
  for (int i = threadIdx.x; i < ROWS * CH; i += MMA_THREADS) {
    const int r = i / CH, c = i - r * CH;
    const int tok = tok0 + r;
    const bool ok = tok < n && c < D / 8;
    rt::cp_async16(dst + r * STR + c * 8,
                   x + (size_t)(ok ? tok : 0) * row_stride + c * 8, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ slopes,
    __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H, int KV,
    int q_offset, int causal, int window, int use_alibi) {
  constexpr int STR = mma_stride<D>();
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * MMA_BQ;   // heaviest first
  const int kvh = h / (H / KV), warp = threadIdx.x >> 5;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kvs = qs + MMA_BQ * STR;   // [stage][K | V][MMA_BK][STR]
  const __nv_bfloat16* qh = q + ((size_t)b * Sq * H + h) * D;
  const __nv_bfloat16* kh = k + ((size_t)b * Sk * KV + kvh) * D;
  const __nv_bfloat16* vh = v + ((size_t)b * Sk * KV + kvh) * D;
  const float scale = rsqrtf((float)D);
  const float slope = use_alibi ? slopes[h] : 0.f;

  // the band of keys some query of this block can see
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + MMA_BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int k_begin =
      window > 0 ? max(0, q_lo - window + 1) / MMA_BK * MMA_BK : 0;

  auto stage_kv = [&](int k0, int stage) {
    __nv_bfloat16* ks = kvs + (size_t)stage * 2 * MMA_BK * STR;
    stage_rows<D, MMA_BK>(ks, kh, (size_t)KV * D, k0, Sk);
    stage_rows<D, MMA_BK>(ks + MMA_BK * STR, vh, (size_t)KV * D, k0, Sk);
  };
  stage_rows<D, MMA_BQ>(qs, qh, (size_t)H * D, q0, Sq);
  if (k_begin < k_end) stage_kv(k_begin, 0);
  rt::cp_async_commit();

  rt::MmaAttnState<D> st;
  rt::mma_attn_init(st);
  const int q_pos0 = q_lo + warp * 16;
  auto row = [=](int g, int hi) {
    return rt::MmaRow{q_pos0 + g + hi * 8, slope};
  };
  auto live = [&](int q_pos, int k_pos) {
    return k_pos < Sk && (!causal || k_pos <= q_pos) &&
           (window <= 0 || q_pos - k_pos < window);
  };
  int it = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += MMA_BK, ++it) {
    if (k0 + MMA_BK < k_end) stage_kv(k0 + MMA_BK, (it + 1) % MMA_STAGES);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();   // this tile (and Q) landed; the next flies
    __syncthreads();
    if (it == 0) rt::mma_attn_load_q(st, qs + warp * 16 * STR, STR);
    const __nv_bfloat16* ks =
        kvs + (size_t)(it % MMA_STAGES) * 2 * MMA_BK * STR;
    const __nv_bfloat16* vs = ks + MMA_BK * STR;
    // only tiles that cross Sk or the causal / sliding edge need the mask
    const bool edge = k0 + MMA_BK > Sk ||
                      (causal && k0 + MMA_BK - 1 > q_lo) ||
                      (window > 0 && k0 < q_hi - window + 1);
    if (edge)
      rt::mma_attend_tile<D, MMA_BK, true>(st, ks, vs, STR, k0, scale, row,
                                           live);
    else
      rt::mma_attend_tile<D, MMA_BK, false>(st, ks, vs, STR, k0, scale,
                                            row, live);
    __syncthreads();          // every warp is done before the stage refills
  }
  rt::cp_async_wait<0>();

  rt::mma_attn_store(st, out + ((size_t)b * Sq * H + h) * D, (size_t)H * D,
                     q0 + warp * 16, Sq);
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v,
               const float* slopes, void* out, int B, int Sq, int Sk, int H,
               int KV, int q_offset, int causal, int window, int use_alibi,
               cudaStream_t stream) {
  static size_t granted = 0;
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t e =
      rt::allow_smem(flash_attention_mma_kernel<D>, smem, &granted);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || Sq == 0) return (int)cudaGetLastError();
  dim3 grid(H, B, (Sq + MMA_BQ - 1) / MMA_BQ);
  flash_attention_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, slopes, (__nv_bfloat16*)out, Sq, Sk, H, KV,
      q_offset, causal, window, use_alibi);
  return (int)cudaGetLastError();
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
