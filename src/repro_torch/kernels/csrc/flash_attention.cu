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
// Design: the TPU grid walks its K axis in order and carries the softmax
// state in VMEM scratch; here the blocks run in parallel, so one thread
// block per (sequence, KV head, tile of BQ query tokens) holds all G
// grouped query heads of its KV head (BQ * G rows, each K/V tile read once
// for G heads) and a loop over 32-key tiles inside the block takes the
// place of the sequential K axis.  Tiles outside the causal / sliding band
// of the block's queries are never loaded (the tile skip of the Pallas
// kernel).  The loop body — staging, scores, online softmax, P @ V — is
// the chunk-prefill kernel's raw-key loop, shared through common.cuh.
// Plain CUDA-core FMAs; the tensor-core (wgmma) form is later work.
#include "common.cuh"

namespace {

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

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* slopes,
           void* out, int B, int Sq, int Sk, int H, int KV, int D, int BQ,
           int q_offset, int causal, int window, int use_alibi,
           cudaStream_t stream) {
  static size_t granted = 0;
  const size_t smem = rt::attn_smem_bytes<TK>(BQ * (H / KV), D);
  cudaError_t e = rt::allow_smem(flash_attention_kernel<T>, smem, &granted);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || Sq == 0) return (int)cudaGetLastError();
  dim3 grid(B * KV, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, slopes, (T*)out, Sq, Sk, H, KV,
      D, BQ, q_offset, causal, window, use_alibi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v,
    const float* slopes, void* out, int B, int Sq, int Sk, int H, int KV,
    int D, int BQ, int q_offset, int causal, int window, int use_alibi,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == rt::DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k, v, slopes, out, B, Sq, Sk, H, KV, D,
                                 BQ, q_offset, causal, window, use_alibi, s);
  return launch<float>(q, k, v, slopes, out, B, Sq, Sk, H, KV, D, BQ,
                       q_offset, causal, window, use_alibi, s);
}
