// W4A16 GPTQ matmul for Hopper: y = x @ ((codes - zeros[g]) * scales[g]).
//
// Replaces: repro/kernels/gptq_matmul.py :: gptq_matmul (body _gptq_mm_kernel).
//
// x [M, K] (bf16 or f32), qweight [K/8, N] int32 (8 codes per word, little
// nibble first), scales / zeros [K/gs, N] f32, group g = k // gs over
// contiguous groups only (the caller rejects any other g_idx).  Codes
// are unpacked with UNSIGNED shifts (an int32 >> would smear the sign of a
// top-nibble code >= 8), dequantized as (code - zero) * scale in f32, and
// the output is written in x's dtype.  Bias stays outside the kernel.
//
// What bounds it on an H100: at decode (M = 8) bytes — 4 bits of codes
// plus 8 / gs bytes of f32 scale and zero per weight, each read once; at a
// prefill chunk (M = 256) and above, operations (2 * M flops per weight).
//
// bf16 x (the serving type): tensor cores.  A block computes a BM x BN
// output tile with mma.sync.m16n8k16 (bf16 x bf16 -> f32); its warps split
// the BN columns (each warp covers all BM rows of 8 * NT columns), so every
// weight is dequantized exactly once per block.  Tiles of BK = 64 k — x
// [BM, 64] bf16, qweight [8, BN] int32 (coalesced along N) and the scale /
// zero rows of the groups they span — are staged in shared memory by
// cp.async, STAGES deep, so later tiles load while this one is multiplied.
// Each lane builds its B fragments in registers straight from the packed
// words: the two codes of a fragment register are one byte of a word, so
// a lane reads 2 words per 16 x 8 fragment, takes (code - zero) * scale in
// f32 and rounds to bf16 once.  That rounding adds about 2^-9 relative
// error per weight against the Pallas kernel's f32 product (the f32
// dequantized weight times f32 x), well inside the 2e-2 bf16 tolerance the
// card checks hold the kernel to.  x is read with ldmatrix from rows
// padded by 16 bytes (conflict-free).  Tiles: BM x BN = 16 x 64 (4 warps,
// 8 stages) for M <= 16, where decode's few rows pad to one mma tile;
// 64 x 128 and 128 x 128 (8 warps, 3 stages) above.  When the output
// tiles would leave SMs idle (decode's N = 256 or 1536, or few M tiles),
// or, at decode, give them too few bytes in flight, the K tiles are split
// across blocks (grid z): each split writes f32 partials to a scratch the
// wrapper allocates, and a second launch sums them in split order — no
// float atomics, so the result is bitwise the same on every call.  The
// planner (kernels/gptq_matmul.py :: plan) picks the tile and the split;
// this file derives the grid from the same numbers.
//
// f32 x (a check path on the card): the CUDA-core body.  A block owns 32
// output columns (one per lane) and BM rows; its 8 warps split the K
// groups, dequantize a group's codes in registers once and apply them to
// all BM rows of x held transposed in shared memory, then reduce their
// partial sums through shared memory.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int PACK = 8;

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

// --------------------------------------------------- bf16 tensor-core body

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
    __nv_bfloat16* __restrict__ y, float* __restrict__ partial, int M, int K,
    int N, int gs, int SR, int kt_per) {
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
}

// y = the sum of the split-K partials [splits][MN], in split order.
__global__ void __launch_bounds__(256) splitk_reduce_kernel(
    const float* __restrict__ partial, __nv_bfloat16* __restrict__ y,
    size_t MN, int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += partial[(size_t)sp * MN + i];
    y[i] = __float2bfloat16(s);
  }
}

template <int MT, int NT, int NWARPS, int STAGES>
int launch_mma(const void* x, const int* qweight, const float* scales,
               const float* zeros, void* y, float* partial, int M, int K,
               int N, int gs, int SR, int kt_per, cudaStream_t stream) {
  using TL = Tile<MT, NT, NWARPS>;
  static size_t granted = 0;
  auto kernel = gptq_mma_kernel<MT, NT, NWARPS, STAGES>;
  const size_t smem = STAGES * TL::stage_bytes(SR);
  cudaError_t e = rt::allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return (int)e;
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  const int KT = (K + BK - 1) / BK;
  const int splits = (KT + kt_per - 1) / kt_per;
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  dim3 grid((N + TL::BN - 1) / TL::BN, (M + TL::BM - 1) / TL::BM, splits);
  kernel<<<grid, TL::THREADS, smem, stream>>>(
      (const __nv_bfloat16*)x, (const uint32_t*)qweight, scales, zeros,
      (__nv_bfloat16*)y, splits > 1 ? partial : nullptr, M, K, N, gs, SR,
      kt_per);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t MN = (size_t)M * N;
  const size_t blocks = (MN + 255) / 256;
  splitk_reduce_kernel<<<(unsigned)(blocks < 2048 ? blocks : 2048), 256, 0,
                         stream>>>(partial, (__nv_bfloat16*)y, MN, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// mt (m16 tiles per block: 1, 4 or 8), SR (scale rows staged per tile),
// kt_per (64-wide k tiles per split) and partial (f32 [splits, M, N]
// scratch, read only when the K tiles split) come from the planner in
// kernels/gptq_matmul.py and are read by the bf16 body only.
extern "C" int gptq_matmul_launch(int dtype, const void* x, const int* qweight,
                                  const float* scales, const float* zeros,
                                  void* y, float* partial, int M, int K,
                                  int N, int gs, int mt, int SR, int kt_per,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != rt::DTYPE_BF16)
    return launch_f32(x, qweight, scales, zeros, y, M, K, N, gs, s);
  if (kt_per <= 0 || SR <= 0 || SR > KW) return (int)cudaErrorInvalidValue;
  switch (mt) {
    case 1:
      return launch_mma<1, 2, 4, 8>(x, qweight, scales, zeros, y, partial, M,
                                    K, N, gs, SR, kt_per, s);
    case 4:
      return launch_mma<4, 2, 8, 3>(x, qweight, scales, zeros, y, partial, M,
                                    K, N, gs, SR, kt_per, s);
    case 8:
      return launch_mma<8, 2, 8, 3>(x, qweight, scales, zeros, y, partial, M,
                                    K, N, gs, SR, kt_per, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
