// W4A16 GPTQ matmul for Hopper: y = x @ ((codes - zeros[g]) * scales[g]).
//
// Replaces: repro/kernels/gptq_matmul.py :: gptq_matmul (body _gptq_mm_kernel).
//
// x [M, K] (bf16 or f32), qweight [K/8, N] int32 (8 codes per word, little
// nibble first), scales / zeros [K/gs, N] f32, group g = k // gs over
// contiguous groups only (the caller rejects any other g_idx).  Codes
// are unpacked as UNSIGNED nibbles (an int32 >> would smear the sign of a
// top-nibble code >= 8), and the output is written in x's dtype.  Bias
// stays outside the kernel.
//
// What bounds it on an H100: at decode (M <= 16) bytes — 4 bits of codes
// plus 8 / gs bytes of f32 scale and zero per weight, each read once; at a
// prefill chunk (M = 256) and above, operations (2 * M flops per weight).
//
// bf16 x (the serving type): wgmma with the weight as the register
// operand.  The block computes the transposed tile y^T [BN = 128 weight
// columns, NT tokens] = W^T x^T: two consumer warpgroups of 64 columns
// each run wgmma m64nNTk16 with A = their 64 columns' dequantized weights
// (built in registers, mma.sync's A layout) and B = x's tile by descriptor
// (K-major rows of 64 k, the 128-byte swizzle B5 uses for its K tiles).
// The token tile NT (8, 16, 32, 64, 128 or 256) follows M, so decode's 8
// rows pad nothing and one body serves M = 1 ... 65,536.  A producer warp
// (at NT 256 a warpgroup, whose registers setmaxnreg hands to the
// consumers' 128 accumulators) keeps every stage of a ring of 64-wide k
// tiles in flight by TMA — x [NT][64] bf16, the codes [8][BN] int32 and
// the scale and zero rows of the groups the tile spans [sr][BN] f32 —
// each stage with a full and an empty mbarrier.  Dequant costs a few
// integer and f32 operations a weight: one byte permute picks byte t of
// two code words (the k of an A register pair come from one byte each), a
// lop3 or two put the nibbles under the exponent of bf16 128.0 (0x4300 |
// q = 128 + q, exact), a shift or a mask makes each an f32 (exact), one
// f32 FMA with (scale, -(128 + zero) x scale), taken once per group per
// lane, gives (q - zero) x scale, and the pack rounds two to bf16.  So a
// weight is the Pallas kernel's f32 (q - z) x s rounded to bf16 once, off
// by at most 2^-8 of itself (bf16 keeps 8 significant bits), as in the
// mma.sync body.  (Rounding the scale and (8 - zero) x scale to bf16 and
// applying them with one fma.rn.bf16x2 a pair, at a third of the
// operations, was tried on an H100: up to (|q - 8| s + |8 - z| s + |w|)
// 2^-8 a weight, errors coherent over a group; llava's served tokens
// then agreed with teacher forcing on 0.88 of them, under chip_smoke.py's
// 0.9, and decode ran 2-10% faster.)  Tile i's wgmma run while tile
// i + 1 is dequantized.  When the output tiles would leave SMs idle
// (decode's N = 256 or 8960, or a chunk's few tiles) the K tiles split
// across blocks (grid z): each split writes f32 partials, and the block
// that arrives last at its tile's counter sums them in split order in the
// same launch — no float atomics, so two calls give the same bits.  The
// epilogue takes y^T through shared memory to rows of y along N.  The
// planner (kernels/gptq_matmul.py :: plan) picks NT, the split, sr and
// the stages; this file derives the grid from the same numbers.
//
// An N that is not a multiple of 4 gives code, scale and zero rows whose
// stride TMA cannot describe: the planner sends those (a check shape; no
// served linear has one) to the mma.sync body, m16n8k16 over cp.async
// stages with the f32 dequant, split the same way.
//
// f32 x (a check path on the card): the CUDA-core body.  A block owns 32
// output columns (one per lane) and BM rows; its 8 warps split the K
// groups, dequantize a group's codes in registers once and apply them to
// all BM rows of x held transposed in shared memory, then reduce their
// partial sums through shared memory.
#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int PACK = 8;
constexpr int ROUTE_WGMMA = 0, ROUTE_MMA = 1;   // as kernels/gptq_matmul.py

// ---------------------------------------------------------------- f32 body

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <typename T, int BM>
__global__ void __launch_bounds__(THREADS) gptq_matmul_kernel(
    const T* __restrict__ x, const int* __restrict__ qweight,
    const float* __restrict__ scales, const float* __restrict__ zeros,
    T* __restrict__ y, int M, int K, int N, int gs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const int m0 = blockIdx.y * BM;
  extern __shared__ float sm[];
  float* xs = sm + (size_t)warp * gs * BM;      // this warp's [gs][BM]
  float acc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0.f;

  const int ngroups = K / gs;
  for (int g = warp; g < ngroups; g += WARPS) {
    for (int i = lane; i < BM * gs; i += 32) {   // coalesced along k
      const int m = i / gs, kk = i - m * gs;
      xs[kk * BM + m] =
          (m0 + m < M) ? rt::to_f32(x[(size_t)(m0 + m) * K + g * gs + kk]) : 0.f;
    }
    __syncwarp();
    if (n < N) {
      const float s = scales[(size_t)g * N + n];
      const float z = zeros[(size_t)g * N + n];
      const int w0 = g * (gs / PACK);
      for (int j = 0; j < gs / PACK; ++j) {
        const uint32_t word = (uint32_t)qweight[(size_t)(w0 + j) * N + n];
#pragma unroll
        for (int i = 0; i < PACK; ++i) {
          const float w = ((float)((word >> (4u * i)) & 0xFu) - z) * s;
          const float4* xv =
              reinterpret_cast<const float4*>(xs + (j * PACK + i) * BM);
#pragma unroll
          for (int m4 = 0; m4 < BM / 4; ++m4) {
            const float4 v = xv[m4];
            acc[4 * m4 + 0] += v.x * w;
            acc[4 * m4 + 1] += v.y * w;
            acc[4 * m4 + 2] += v.z * w;
            acc[4 * m4 + 3] += v.w * w;
          }
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();
  float* red = sm;                                // [WARPS][BM][32]
#pragma unroll
  for (int m = 0; m < BM; ++m) red[(warp * BM + m) * 32 + lane] = acc[m];
  __syncthreads();
  for (int i = threadIdx.x; i < BM * 32; i += THREADS) {
    const int m = i / 32, l = i - m * 32;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[(w * BM + m) * 32 + l];
    const int nn = blockIdx.x * 32 + l;
    if (m0 + m < M && nn < N) y[(size_t)(m0 + m) * N + nn] = rt::from_f32<T>(sum);
  }
}

template <int BM>
int launch_f32_bm(const void* x, const int* qweight, const float* scales,
                  const float* zeros, void* y, int M, int K, int N, int gs,
                  cudaStream_t stream) {
  static size_t granted = 0;
  const int span = gs > 32 ? gs : 32;             // staging or reduction
  const size_t smem = sizeof(float) * (size_t)WARPS * BM * span;
  cudaError_t e =
      rt::allow_smem(gptq_matmul_kernel<float, BM>, smem, &granted);
  if (e != cudaSuccess) return (int)e;
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  dim3 grid((N + 31) / 32, (M + BM - 1) / BM);
  gptq_matmul_kernel<float, BM><<<grid, THREADS, smem, stream>>>(
      (const float*)x, qweight, scales, zeros, (float*)y, M, K, N, gs);
  return (int)cudaGetLastError();
}

int launch_f32(const void* x, const int* qweight, const float* scales,
               const float* zeros, void* y, int M, int K, int N, int gs,
               cudaStream_t stream) {
  if (M <= 8)
    return launch_f32_bm<8>(x, qweight, scales, zeros, y, M, K, N, gs, stream);
  if (M <= 16)
    return launch_f32_bm<16>(x, qweight, scales, zeros, y, M, K, N, gs,
                             stream);
  return launch_f32_bm<32>(x, qweight, scales, zeros, y, M, K, N, gs, stream);
}

// ------------------------------------------------ split-K fix-up, in launch

// Each split of an output tile has written its f32 partials (``partial``
// [splits][M][N]).  The block that arrives last at the tile's counter
// (zero between launches) resets it and returns true; the others return
// false.  A counter found at ``splits`` or above (left by a launch that
// died part way, or shared with another stream) traps: a sticky launch
// failure, never a sum taken too early.
template <typename Sync>
__device__ __forceinline__ bool arrive_last(int* counter, int splits,
                                            int tid, Sync sync, int* flag) {
  sync();
  if (tid == 0) {
    // after the block's barrier, one gpu-scope fence orders the writes of
    // every thread of the block before the arrival (fences are cumulative)
    __threadfence();
    const int n = atomicAdd(counter, 1);
    if (n >= splits) __trap();
    *flag = n == splits - 1;
    if (*flag) *counter = 0;      // every split has arrived: reset for the next
  }
  sync();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// y[m0 .. m0 + rows, n0 .. n0 + cols] = the sum of the splits' partials,
// taken in split order (the same bits on every call, whichever block came
// last).  One block reads every split of the tile from L2, so a thread
// keeps G runs of V columns and four splits of each in flight at once.
template <int NTH, int V>
__device__ __forceinline__ void sum_runs(const float* __restrict__ partial,
                                         __nv_bfloat16* __restrict__ y,
                                         int M, int N, int m0, int n0,
                                         int rows, int cols, int splits,
                                         int tid) {
  constexpr int G = 4;
  const size_t MN = (size_t)M * N;
  const int runs = rows * (cols / V);
  for (int i0 = tid; i0 < runs; i0 += G * NTH) {
    const float* p[G];
    size_t at[G];
    float acc[G][V];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int i = i0 + q * NTH, r = i / (cols / V);
      const int m = m0 + r, n = n0 + (i - r * (cols / V)) * V;
      // a run is whole or wholly out: V divides N and the tile's columns
      const bool ok = i < runs && m < M && n < N;
      at[q] = ok ? (size_t)m * N + n : 0;
      p[q] = ok ? partial + at[q] : nullptr;
#pragma unroll
      for (int v = 0; v < V; ++v) acc[q][v] = 0.f;
    }
#pragma unroll 4
    for (int z = 0; z < splits; ++z)
#pragma unroll
      for (int q = 0; q < G; ++q) {
        if (p[q] == nullptr) continue;
        if constexpr (V == 4) {
          const float4 a =
              __ldcg(reinterpret_cast<const float4*>(p[q] + z * MN));
          acc[q][0] = z ? acc[q][0] + a.x : a.x;
          acc[q][1] = z ? acc[q][1] + a.y : a.y;
          acc[q][2] = z ? acc[q][2] + a.z : a.z;
          acc[q][3] = z ? acc[q][3] + a.w : a.w;
        } else {
          const float a = __ldcg(p[q] + z * MN);
          acc[q][0] = z ? acc[q][0] + a : a;
        }
      }
#pragma unroll
    for (int q = 0; q < G; ++q) {
      if (p[q] == nullptr) continue;
#pragma unroll
      for (int v = 0; v < V; ++v) y[at[q] + v] = __float2bfloat16(acc[q][v]);
    }
  }
}

template <int NTH>
__device__ __forceinline__ void sum_splits(const float* __restrict__ partial,
                                           __nv_bfloat16* __restrict__ y,
                                           int M, int N, int m0, int n0,
                                           int rows, int cols, int splits,
                                           int tid) {
  if ((N & 3) == 0 && (cols & 3) == 0)
    sum_runs<NTH, 4>(partial, y, M, N, m0, n0, rows, cols, splits, tid);
  else
    sum_runs<NTH, 1>(partial, y, M, N, m0, n0, rows, cols, splits, tid);
}

// ----------------------------------------- bf16 mma.sync body (ragged N)

constexpr int BK = 64;            // k per staged tile
constexpr int KW = BK / PACK;     // packed qweight rows per tile
constexpr int XSTR = BK + 8;      // staged x row, padded by 16 bytes

template <int MT, int NT, int NWARPS>
struct Tile {
  static constexpr int BM = 16 * MT, BN = 8 * NT * NWARPS;
  static constexpr int THREADS = 32 * NWARPS;
  // one stage: x [BM][XSTR] bf16, qweight [KW][BN] u32, scale and zero
  // rows [SR][BN] f32 each
  static __host__ __device__ size_t stage_bytes(int SR) {
    return (size_t)BM * XSTR * 2 + (size_t)KW * BN * 4 +
           2 * (size_t)SR * BN * 4;
  }
};

// Rows row0 .. row0 + rows of a [nrows, N] 32-bit matrix, columns
// n0 .. n0 + BN, into shared [rows][BN]; anything out of range is zero.
template <int BN, int NTHREADS>
__device__ __forceinline__ void stage_cols(uint32_t* dst, const void* src,
                                           int row0, int rows, int nrows,
                                           int n0, int N) {
  const uint32_t* s = static_cast<const uint32_t*>(src);
  constexpr int CH = BN / 4;
  for (int i = threadIdx.x; i < rows * CH; i += NTHREADS) {
    const int r = i / CH, c = i - r * CH;
    const int gr = row0 + r, n = n0 + c * 4;
    if ((N & 3) == 0) {           // 16-byte rows: one copy per 4 columns
      const bool ok = gr < nrows && n < N;
      rt::cp_async16(dst + r * BN + c * 4, s + (ok ? (size_t)gr * N + n : 0),
                     ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = gr < nrows && n + e < N;
        rt::cp_async4(dst + r * BN + c * 4 + e,
                      s + (ok ? (size_t)gr * N + n + e : 0), ok);
      }
    }
  }
}

template <int MT, int NT, int NWARPS, int STAGES>
__global__ void __launch_bounds__(32 * NWARPS) gptq_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ qweight,
    const float* __restrict__ scales, const float* __restrict__ zeros,
    __nv_bfloat16* __restrict__ y, float* __restrict__ partial,
    int* __restrict__ counters, int M, int K, int N, int gs, int SR,
    int kt_per) {
  using TL = Tile<MT, NT, NWARPS>;
  constexpr int BM = TL::BM, BN = TL::BN, NTH = TL::THREADS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int KT = (K + BK - 1) / BK, KP = K / PACK, NG = K / gs;
  const int kt0 = blockIdx.z * kt_per, kt1 = min(kt0 + kt_per, KT);
  // k -> group: a shift for a power-of-two group size (a division by a
  // run-time value costs some 20 instructions, and it runs per 16 k)
  const int gs_shift = (gs & (gs - 1)) == 0 ? __ffs(gs) - 1 : -1;
  auto group = [&](int k) { return gs_shift >= 0 ? k >> gs_shift : k / gs; };
  const size_t sbytes = TL::stage_bytes(SR);
  extern __shared__ __align__(16) unsigned char smem_raw[];

  auto stage_at = [&](int st, __nv_bfloat16*& xs, uint32_t*& qs, float*& ss,
                      float*& zs) {
    unsigned char* base = smem_raw + st * sbytes;
    xs = reinterpret_cast<__nv_bfloat16*>(base);
    qs = reinterpret_cast<uint32_t*>(base + (size_t)BM * XSTR * 2);
    ss = reinterpret_cast<float*>(qs + KW * BN);
    zs = ss + SR * BN;
  };
  auto load = [&](int kt, int st) {
    __nv_bfloat16* xs;
    uint32_t* qs;
    float *ss, *zs;
    stage_at(st, xs, qs, ss, zs);
    const int k0 = kt * BK;
    for (int i = threadIdx.x; i < BM * KW; i += NTH) {
      const int r = i / KW, c = i - r * KW;
      const int m = m0 + r, k = k0 + c * 8;
      const bool ok = m < M && k < K;
      rt::cp_async16(xs + r * XSTR + c * 8, x + (ok ? (size_t)m * K + k : 0),
                     ok);
    }
    stage_cols<BN, NTH>(qs, qweight, kt * KW, KW, KP, n0, N);
    // the groups of k0 .. k0 + BK (at most SR rows; unused rows are zero)
    const int g_lo = group(k0);
    const int g_end = min(NG, group(min(k0 + BK, K) - 1) + 1);
    stage_cols<BN, NTH>(reinterpret_cast<uint32_t*>(ss), scales, g_lo, SR,
                        g_end, n0, N);
    stage_cols<BN, NTH>(reinterpret_cast<uint32_t*>(zs), zeros, g_lo, SR,
                        g_end, n0, N);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (kt0 + s < kt1) load(kt0 + s, s);
    rt::cp_async_commit();
  }
  const int wn = warp * 8 * NT;       // the warp's first column in the tile
  for (int kt = kt0; kt < kt1; ++kt) {
    const int it = kt - kt0;
    if (kt + STAGES - 1 < kt1)
      load(kt + STAGES - 1, (it + STAGES - 1) % STAGES);
    rt::cp_async_commit();
    rt::cp_async_wait<STAGES - 1>();  // tile kt landed
    __syncthreads();
    __nv_bfloat16* xs;
    uint32_t* qs;
    float *ss, *zs;
    stage_at(it % STAGES, xs, qs, ss, zs);
    const int k0 = kt * BK, g_lo = group(k0);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // B fragments: b0 holds k 2t, 2t+1 of packed row 2kk (byte t of the
      // word), b1 the same of row 2kk + 1, both at column g of the n tile
      const int ga = group(k0 + kk * 16) - g_lo;
      const int gb = group(k0 + kk * 16 + 8) - g_lo;
      uint32_t bf[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = wn + j * 8 + g;
        const uint32_t wa = qs[(2 * kk) * BN + n] >> (8 * t);
        const uint32_t wb = qs[(2 * kk + 1) * BN + n] >> (8 * t);
        const float sa = ss[ga * BN + n], za = zs[ga * BN + n];
        const float sb = ss[gb * BN + n], zb = zs[gb * BN + n];
        bf[j][0] = rt::pack_bf16(((float)(wa & 0xFu) - za) * sa,
                                 ((float)((wa >> 4) & 0xFu) - za) * sa);
        bf[j][1] = rt::pack_bf16(((float)(wb & 0xFu) - zb) * sb,
                                 ((float)((wb >> 4) & 0xFu) - zb) * sb);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[4];
        rt::ldmatrix_x4(a, xs + (i * 16 + (lane & 15)) * XSTR + kk * 16 +
                               (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < NT; ++j) rt::mma_bf16_16816(acc[i][j], a, bf[j]);
      }
    }
    __syncthreads();                  // the stage is free to refill
  }
  rt::cp_async_wait<0>();

  // lane (g, t) of C tile (i, j) holds rows g, g + 8 and columns 2t, 2t+1
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + i * 16 + g + 8 * r;
        const int col = n0 + wn + j * 8 + 2 * t;
        if (row >= M || col >= N) continue;
        const float v0 = acc[i][j][2 * r], v1 = acc[i][j][2 * r + 1];
        const bool pair = col + 1 < N && (N & 1) == 0;
        if (partial != nullptr) {
          float* p = partial + ((size_t)blockIdx.z * M + row) * N + col;
          if (pair) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            p[0] = v0;
            if (col + 1 < N) p[1] = v1;
          }
        } else {
          __nv_bfloat16* p = y + (size_t)row * N + col;
          if (pair) {
            *reinterpret_cast<uint32_t*>(p) = rt::pack_bf16(v0, v1);
          } else {
            p[0] = __float2bfloat16(v0);
            if (col + 1 < N) p[1] = __float2bfloat16(v1);
          }
        }
      }
  __shared__ int flag;
  if (partial != nullptr &&
      arrive_last(counters + blockIdx.y * gridDim.x + blockIdx.x, gridDim.z,
                  threadIdx.x, [] { __syncthreads(); }, &flag))
    sum_splits<NTH>(partial, y, M, N, m0, n0, BM, BN, gridDim.z,
                    threadIdx.x);
}


template <int MT, int NT, int NWARPS, int STAGES>
int launch_mma(const void* x, const int* qweight, const float* scales,
               const float* zeros, void* y, float* partial, int* counters,
               int M, int K, int N, int gs, int SR, int kt_per,
               cudaStream_t stream) {
  using TL = Tile<MT, NT, NWARPS>;
  static size_t granted = 0;
  auto kernel = gptq_mma_kernel<MT, NT, NWARPS, STAGES>;
  const size_t smem = STAGES * TL::stage_bytes(SR);
  cudaError_t e = rt::allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return (int)e;
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  const int KT = (K + BK - 1) / BK;
  const int splits = (KT + kt_per - 1) / kt_per;
  if (splits > 1 && (partial == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + TL::BN - 1) / TL::BN, (M + TL::BM - 1) / TL::BM, splits);
  kernel<<<grid, TL::THREADS, smem, stream>>>(
      (const __nv_bfloat16*)x, (const uint32_t*)qweight, scales, zeros,
      (__nv_bfloat16*)y, splits > 1 ? partial : nullptr, counters, M, K, N,
      gs, SR, kt_per);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16 wgmma body

constexpr int BN = 128;                 // weight columns a block
constexpr int WG = 128;                 // threads of a warpgroup
constexpr int CONSUMERS = 2 * WG;       // two warpgroups of 64 columns
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;      // 24 x 128 + 240 x 256 <= 65,536
constexpr int Q_BYTES = KW * BN * 4;    // a stage's codes [8][BN] u32
constexpr int OUT_STRIDE = BN + 8;      // the epilogue's rows, in bf16
constexpr int MAGIC = 0x43004300;       // bf16 128.0 twice: 128 + q exact

template <int NT>
struct GTile {
  // blocks an SM holds: the decode tiles keep two blocks' stages in
  // flight; from NT 64 one block's accumulators take the registers
  static constexpr int MIN_BLOCKS = NT <= 32 ? 2 : 1;
  // the producer: one warp, or at NT 256 a warpgroup whose registers
  // setmaxnreg hands to the consumers (128 accumulators a thread; ptxas
  // budgets 168 a thread for 288 threads, and spills and serialises the
  // wgmma there)
  static constexpr bool REBALANCE = NT >= 256;
  static constexpr int THREADS = CONSUMERS + (REBALANCE ? WG : 32);
  static constexpr int X_BYTES = NT * 128;     // x [NT][64] bf16, swizzled
  static constexpr int OUT_BYTES = NT * OUT_STRIDE * 2;
  static __host__ __device__ int stage_bytes(int sr) {
    return X_BYTES + Q_BYTES + 2 * sr * BN * 4;
  }
  static __host__ __device__ int ring_bytes(int sr, int stages) {
    const int r = stages * stage_bytes(sr);
    return r > OUT_BYTES ? r : OUT_BYTES;
  }
  // slack to align the ring to the 1024-byte swizzle atom, the ring (the
  // epilogue's tile once the stages are drained), full and empty
  // barriers per stage, the split-K flag
  static size_t smem(int sr, int stages) {
    return 1024 + (size_t)ring_bytes(sr, stages) + 16 * stages + 16;
  }
};

// The codes of one A register pair: byte t of w0 (k 2t, 2t + 1 of its 8)
// and byte t of w1 (the next 8 k), as bf16 128 + q.  lo = (k 2t of w0,
// k 2t of w1), hi = (k 2t + 1 of w0, k 2t + 1 of w1).
__device__ __forceinline__ void nibbles(uint32_t w0, uint32_t w1,
                                        uint32_t sel, uint32_t& lo,
                                        uint32_t& hi) {
  const uint32_t b = __byte_perm(w0, w1, sel);   // bytes [t, t, 4 + t, 4 + t]
  lo = (b & 0x000F000Fu) | MAGIC;
  hi = ((b >> 4) & 0x000F000Fu) | MAGIC;
}

// A register of two weights, (q - z) x s rounded to bf16 once: the low
// halves of lo and hi (k 2t and 2t + 1 of the first word, half = 0) or
// their high halves (half = 1), each 128 + q, become f32 exactly (a bf16
// is the top half of an f32), and one f32 FMA each with c = -(128 + z) s
// gives (q - z) s to within 2^-24 of it, rounded to bf16 in the pack.
template <int HALF>
__device__ __forceinline__ uint32_t dequant(uint32_t lo, uint32_t hi,
                                            float s, float c) {
  const float k0 = __uint_as_float(HALF ? lo & 0xFFFF0000u : lo << 16);
  const float k1 = __uint_as_float(HALF ? hi & 0xFFFF0000u : hi << 16);
  return rt::pack_bf16(fmaf(k0, s, c), fmaf(k1, s, c));
}

template <int NT>
__global__ void __launch_bounds__(GTile<NT>::THREADS, GTile<NT>::MIN_BLOCKS)
    gptq_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap ts,
                      const __grid_constant__ CUtensorMap tz,
                      __nv_bfloat16* __restrict__ y,
                      float* __restrict__ partial, int* __restrict__ counters,
                      int M, int K, int N, int gs, int sr, int kt_per,
                      int stages) {
  namespace hp = rt::hopper;
  using T = GTile<NT>;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * NT;
  const int KT = (K + BK - 1) / BK;
  const int kt0 = blockIdx.z * kt_per;
  const int n_tiles = min(kt0 + kt_per, KT) - kt0;
  const int stage = T::stage_bytes(sr);
  const int ring = T::ring_bytes(sr, stages);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hp::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // stage s at base + s stage:
  unsigned char* gbase = smem_raw + (base - raw);  // x, codes, scales, zeros
  const uint32_t full = base + ring, empty = full + 8 * stages;
  int* flag = reinterpret_cast<int*>(gbase + ring + 16 * stages);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hp::mbar_init(full + 8 * s, 1);
      hp::mbar_init(empty + 8 * s, CONSUMERS);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer: one thread keeps every stage's four TMA loads in flight
    if constexpr (T::REBALANCE) hp::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      hp::prefetch_map(&tx);
      hp::prefetch_map(&tq);
      hp::prefetch_map(&ts);
      hp::prefetch_map(&tz);
      for (int i = 0, s = 0, ph = 0; i < n_tiles; ++i) {
        const int kt = kt0 + i;
        const uint32_t st = base + s * stage, bar = full + 8 * s;
        hp::mbar_wait(empty + 8 * s, ph ^ 1);
        hp::mbar_arrive_expect_tx(bar, stage);
        hp::tma_load_2d(st, &tx, bar, kt * BK, m0);
        hp::tma_load_2d(st + T::X_BYTES, &tq, bar, n0, kt * KW);
        hp::tma_load_2d(st + T::X_BYTES + Q_BYTES, &ts, bar, n0,
                        kt * BK / gs);
        hp::tma_load_2d(st + T::X_BYTES + Q_BYTES + sr * BN * 4, &tz, bar,
                        n0, kt * BK / gs);
        if (++s == stages) s = 0, ph ^= 1;
      }
    }
    return;
  }

  if constexpr (T::REBALANCE) hp::setmaxnreg_inc<CONSUMER_REGS>();
  // consumers: warpgroup cw owns the block's weight columns 64 cw .. + 63;
  // lane (g, t) of warp w builds the A fragments of its rows g and g + 8
  // (mma.sync's A layout: a0 / a1 the k 2t, 2t + 1 of a 16-k step, a2 / a3
  // its k 2t + 8, 2t + 9, for the two rows), which hold the adjacent
  // columns col_a = 64 cw + 16 w + 2g and col_a + 1: one 8-byte load
  // brings both columns' code words, scales or zeros, and the epilogue
  // stores both as a pair
  const int ct = threadIdx.x, cw = ct / WG, w = (ct / 32) % 4;
  const int g = (ct & 31) >> 2, t = ct & 3;
  const int col_a = cw * 64 + w * 16 + 2 * g;
  const uint32_t sel = t | t << 4 | (4 + t) << 8 | (4 + t) << 12;
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  uint32_t an[4][4], ac[4][4];
  // the group of the k being dequantized (cur), where the next one starts
  // (nb), and the group of the stage's first scale row (g_lo); scale and
  // offset -(128 + zero) x scale of columns a and b
  int cur = kt0 * BK / gs, nb = (cur + 1) * gs, g_lo = cur;
  float sa = 0.f, ca = 0.f, sb = 0.f, cb = 0.f;
  auto load_sz = [&](const float* ss, const float* zs, int row) {
    const float2 s2 = *reinterpret_cast<const float2*>(ss + row * BN + col_a);
    const float2 z2 = *reinterpret_cast<const float2*>(zs + row * BN + col_a);
    sa = s2.x;
    sb = s2.y;
    ca = fmaf(-z2.x, sa, -128.f * sa);
    cb = fmaf(-z2.y, sb, -128.f * sb);
  };
  // advance to the group of k (at most one boundary since the last k,
  // 8 back) and reload the pairs when it starts there
  auto step_group = [&](const float* ss, const float* zs, int k) {
    if (k >= nb) {
      ++cur;
      nb += gs;
      load_sz(ss, zs, cur - g_lo);
    }
  };
  // A fragments of tile i (stage s) into an: each 8-k block takes its
  // group's scale, the groups being contiguous along k
  auto build = [&](int i, int s) {
    const unsigned char* st = gbase + s * stage;
    const uint32_t* qs = reinterpret_cast<const uint32_t*>(st + T::X_BYTES);
    const float* ss = reinterpret_cast<const float*>(st + T::X_BYTES +
                                                     Q_BYTES);
    const float* zs = ss + sr * BN;
    const int k0 = (kt0 + i) * BK;
    if (k0 >= nb) ++cur, nb += gs;
    g_lo = cur;
    load_sz(ss, zs, 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t lo_a, hi_a, lo_b, hi_b;
      const uint2 r0 = *reinterpret_cast<const uint2*>(qs + 2 * kk * BN + col_a);
      const uint2 r1 =
          *reinterpret_cast<const uint2*>(qs + (2 * kk + 1) * BN + col_a);
      nibbles(r0.x, r1.x, sel, lo_a, hi_a);
      nibbles(r0.y, r1.y, sel, lo_b, hi_b);
      if (kk > 0) step_group(ss, zs, k0 + 16 * kk);
      an[kk][0] = dequant<0>(lo_a, hi_a, sa, ca);
      an[kk][1] = dequant<0>(lo_b, hi_b, sb, cb);
      step_group(ss, zs, k0 + 16 * kk + 8);
      an[kk][2] = dequant<1>(lo_a, hi_a, sa, ca);
      an[kk][3] = dequant<1>(lo_b, hi_b, sb, cb);
    }
  };

  // Tile i's four wgmma (A = the dequantized weights from registers, B =
  // x's stage by descriptor, K-major) run while tile i + 1 is dequantized
  // into the other fragments; the stage is released when they are done.
  int s = 0, ph = 0;
  hp::mbar_wait(full, 0);
  build(0, 0);
  for (int i = 0; i < n_tiles; ++i) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) ac[kk][e] = an[kk][e];
    hp::wgmma_fence();
    const uint32_t xs = base + s * stage;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hp::Wgmma<NT>::template rs<0>(acc, ac[kk],
                                     hp::desc_sw128(xs + kk * 32, 16, 1024),
                                     1);
    hp::wgmma_commit();
    int s2 = s + 1, ph2 = ph;
    if (s2 == stages) s2 = 0, ph2 ^= 1;
    if (i + 1 < n_tiles) {
      hp::mbar_wait(full + 8 * s2, ph2);
      build(i + 1, s2);
    }
    hp::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) hp::fence_reg(acc[j]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) hp::fence_reg(ac[kk][e]);
    hp::mbar_arrive(empty + 8 * s);
    s = s2, ph = ph2;
  }

  // acc[4j + e] is y^T at column col_a + (e >> 1), token 8j + 2t + (e & 1)
  auto sync = [] { hp::named_sync(1, CONSUMERS); };
  if (partial == nullptr) {
    // through shared memory (the drained ring) to rows of y along N
    sync();
    __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(gbase);
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<uint32_t*>(
            os + (8 * j + 2 * t + e) * OUT_STRIDE + col_a) =
            rt::pack_bf16(acc[4 * j + e], acc[4 * j + e + 2]);
    sync();
    const int rows = min(NT, M - m0);
    constexpr int CH = BN / 8;                   // 16-byte chunks a row
    for (int i = ct; i < rows * CH; i += CONSUMERS) {
      const int r = i / CH, c = (i - r * CH) * 8, n = n0 + c;
      const __nv_bfloat16* src = os + r * OUT_STRIDE + c;
      __nv_bfloat16* dst = y + (size_t)(m0 + r) * N + n;
      if ((N & 7) == 0 && n + 8 <= N) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && n + e < N; ++e) dst[e] = src[e];
      }
    }
    return;
  }
  float* p = partial + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * t + e, n = n0 + col_a;
      if (m < M && n < N)
        *reinterpret_cast<float2*>(p + (size_t)m * N + n) =
            make_float2(acc[4 * j + e], acc[4 * j + e + 2]);
    }
  if (arrive_last(counters + blockIdx.y * gridDim.x + blockIdx.x, gridDim.z,
                  ct, sync, flag))
    sum_splits<CONSUMERS>(partial, y, M, N, m0, n0, NT, BN, gridDim.z, ct);
}

template <int NT>
int launch_wgmma(const void* x, const int* qweight, const float* scales,
                 const float* zeros, void* y, float* partial, int* counters,
                 int M, int K, int N, int gs, int sr, int kt_per, int stages,
                 cudaStream_t stream) {
  namespace hp = rt::hopper;
  using T = GTile<NT>;
  static size_t granted = 0;
  // a ring of one stage deadlocks past one tile: the next tile's wait
  // comes before this one's release
  if (stages <= 0 || (stages == 1 && kt_per > 1) || (N & 3) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e =
      rt::allow_smem(gptq_wgmma_kernel<NT>, T::smem(sr, stages), &granted);
  if (e != cudaSuccess) return (int)e;
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  const int KT = (K + BK - 1) / BK;
  const int splits = (KT + kt_per - 1) / kt_per;
  if (splits > 1 && (partial == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  // x [M, K] bf16 in boxes of 64 k x NT tokens, swizzled for wgmma's B;
  // codes [K/8, N] int32 in boxes of BN x 8; scales / zeros [K/gs, N] f32
  // in boxes of BN x sr; reads past an edge land as zeros
  CUtensorMap tx, tq, ts, tz;
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t xs[1] = {2ull * K};
  const cuuint32_t xb[2] = {64, NT};
  int r = hp::encode_bf16_sw128(&tx, x, 2, xd, xs, xb);
  const cuuint64_t qd[2] = {(cuuint64_t)N, (cuuint64_t)(K / PACK)};
  const cuuint32_t qb[2] = {BN, KW};
  if (r == 0)
    r = hp::encode_32bit_2d(&tq, CU_TENSOR_MAP_DATA_TYPE_INT32, qweight, qd,
                            4ull * N, qb);
  const cuuint64_t sd[2] = {(cuuint64_t)N, (cuuint64_t)(K / gs)};
  const cuuint32_t sb[2] = {BN, (cuuint32_t)sr};
  if (r == 0)
    r = hp::encode_32bit_2d(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales, sd,
                            4ull * N, sb);
  if (r == 0)
    r = hp::encode_32bit_2d(&tz, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, zeros, sd,
                            4ull * N, sb);
  if (r != 0) return r;
  dim3 grid((N + BN - 1) / BN, (M + NT - 1) / NT, splits);
  gptq_wgmma_kernel<NT><<<grid, T::THREADS, T::smem(sr, stages), stream>>>(
      tx, tq, ts, tz, (__nv_bfloat16*)y, splits > 1 ? partial : nullptr,
      counters, M, K, N, gs, sr, kt_per, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// route 0 (ROUTE_WGMMA): the wgmma body, tile = NT tokens a block (8, 16,
// 32, 64, 128 or 256) and `stages` stages; route 1 (ROUTE_MMA, for an N
// that is not a multiple of 4, a row stride TMA cannot describe): the
// mma.sync body, tile = m16 tiles a block (1 or 8).  sr (scale rows
// staged per k tile), kt_per (64-wide k tiles per split), partial (f32
// [splits, M, N]) and counters (one int a output tile, zero) come from
// the planner in kernels/gptq_matmul.py; partial is read only when the K
// tiles split.  The f32 body reads none of them.
extern "C" int gptq_matmul_launch(int dtype, const void* x, const int* qweight,
                                  const float* scales, const float* zeros,
                                  void* y, float* partial, int* counters,
                                  int M, int K, int N, int gs, int route,
                                  int tile, int sr, int kt_per, int stages,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != rt::DTYPE_BF16)
    return launch_f32(x, qweight, scales, zeros, y, M, K, N, gs, s);
  if (kt_per <= 0 || sr <= 0 || sr > KW) return (int)cudaErrorInvalidValue;
  if (route == ROUTE_WGMMA) {
    switch (tile) {
      case 8:
        return launch_wgmma<8>(x, qweight, scales, zeros, y, partial,
                               counters, M, K, N, gs, sr, kt_per, stages, s);
      case 16:
        return launch_wgmma<16>(x, qweight, scales, zeros, y, partial,
                                counters, M, K, N, gs, sr, kt_per, stages, s);
      case 32:
        return launch_wgmma<32>(x, qweight, scales, zeros, y, partial,
                                counters, M, K, N, gs, sr, kt_per, stages, s);
      case 64:
        return launch_wgmma<64>(x, qweight, scales, zeros, y, partial,
                                counters, M, K, N, gs, sr, kt_per, stages, s);
      case 128:
        return launch_wgmma<128>(x, qweight, scales, zeros, y, partial,
                                 counters, M, K, N, gs, sr, kt_per, stages,
                                 s);
      case 256:
        return launch_wgmma<256>(x, qweight, scales, zeros, y, partial,
                                 counters, M, K, N, gs, sr, kt_per, stages,
                                 s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (route != ROUTE_MMA) return (int)cudaErrorInvalidValue;
  switch (tile) {
    case 1:
      return launch_mma<1, 2, 4, 8>(x, qweight, scales, zeros, y, partial,
                                    counters, M, K, N, gs, sr, kt_per, s);
    case 8:
      return launch_mma<8, 2, 8, 3>(x, qweight, scales, zeros, y, partial,
                                    counters, M, K, N, gs, sr, kt_per, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
