// Time scans of the attention-free mixers for Hopper: the Mamba-1
// selective scan and the RG-LRU's linear recurrence, each one launch per
// layer and call.
//
// Replaces: not a Pallas site.  The JAX package scans time with lax.scan
// (repro/models/ssm.py :: _chunked_time_scan, the Mamba-1 step of
// _ssm_inner and the RG-LRU step of _rglru_scan); its torch counterpart
// would be a few launches per time step and layer, which leaves the card
// waiting on the host (a [8, 1024] wave of 64 layers: ~330,000 launches).
//
// selective_scan (Mamba-1), two entries on one templated body:
//  * the scan alone: dt, u [Bt, S, din] f32; B, C [Bt, S, N] f32; A [din,
//    N] f32; h0 [Bt, din, N] f32.  For t = 0 .. S-1:
//      h = exp(dt_t * A) * h + (dt_t * u_t) * B_t,   y_t = sum_n h * C_t
//    gives y [Bt, S, din] f32 and h_last [Bt, din, N].  A position with
//    dt = 0 and u = 0 (the callers' masked padding) leaves h as it is.
//  * the fused mixer core (models/ssm.py :: _ssm_inner after its two
//    matmuls), in the activation type T (f32 or bf16): dt_lin, xc [Bt, S,
//    din]; B, C and z read in place as strided rows (token strides b_row,
//    c_row, z_row); dt_bias, D [din], A_log [din, N], h0 [Bt, din, N] f32;
//    an optional mask [Bt, S].  In registers, at the plain version's
//    rounding points (each "T(.)" rounds to T, a no-op at f32):
//      dt = T(softplus(T(dt_lin + T(dt_bias))))  (torch's softplus:
//           x > 20 ? x : log1p(exp(x)));  dt = 0 where the mask is False
//      A  = -exp(A_log)
//      (the scan above on dt, u = xc, B, C)
//      out = T(T(T(y) + T(xc * T(D))) * T(silu(z))),  silu(z) = z / (1 +
//            exp(-z))
//    gives out [Bt, S, din] in T and h_last f32.
//
// What bounds them on an H100.  The selective scan moves 8 bytes a
// (token, channel) in bf16 (dt_lin, xc, z in, the gated y out; 12 in
// f32 through the scan alone) and does, per state element and step, one
// exponential and four f32 operations: at the serve's wave [8, 960] x
// 8192 x 16 that is 1.0 G exponentials, ~0.24 ms on the MUFU (16 a clock
// an SM at 1.98 GHz) against ~0.15 ms of bytes, and the softplus and the
// gate add ~60 instructions a (token, channel).  So it is bound by the
// MUFU and by instruction issue, not by bytes: the design spends one
// MUFU instruction per state element and keeps the rest of a step to a
// few issue slots a state.  The linear scan does 2 flops against 12
// bytes: bytes.
//
// Design of the selective scan:
//  * States across lanes.  A (sequence, channel) is LANES = N / NS
//    adjacent threads, each owning NS states in registers (h and A
//    log2(e)).  A step's lanes write their partial sums of y_t to shared
//    memory, and the elementwise pass adds a channel's partials pairwise
//    in a fixed order, so two calls are bitwise equal (a __shfl_xor_sync
//    butterfly a step timed slower on the H100).  NS = 8 (128 channels a
//    256-thread block) where its grid still gives nearly every SM a
//    block, else NS = 4: a single prompt (Bt = 1) at din 8192 takes 64
//    channels a block, 128 blocks (kernels/time_scan.py :: plan).  Time
//    is not split across blocks: a split scan does each state element's
//    exponential twice (a local pass, then the pass from the carried
//    state), and at the rate this body reaches on a full grid that costs
//    a single prompt what its under-filled grid does.
//  * Staged time tiles.  A block walks its sequence in tiles of TT steps:
//    the tile's rows of dt(_lin), u / xc and z (its CH channels, 16-byte
//    cp.async vectors) and of B and C are staged in shared memory, two
//    buffers deep, so the next tile loads while this one scans.  One
//    elementwise pass a tile, all threads on contiguous channels, writes
//    the previous tile's outputs (the D skip and the gate fused, stores
//    along the channels) and this tile's dt and dt * u in f32 (the
//    softplus, the bias and the mask fused); the lanes then read dt and dt
//    * u broadcast per channel and B_t, C_t as 16-byte vectors.  Decode
//    (S = 1) takes TT = 1: one row staged, no time loop.  __launch_bounds__
//    holds a thread to 64 registers, so that four blocks fit an SM by
//    registers.  Decode's tiles (a few KB of shared memory) and the
//    64-channel blocks (NS = 4, 40,960 B in bf16) reach four; the
//    128-channel wave tiles are held by shared memory to three (bf16
//    fused 61,440 B, f32 scan alone 71,680 B) or two (f32 fused 88,064
//    B) of the H100's 228 KB.  (Each warp staging and scanning its own
//    channels with no block barrier timed slower on the H100: 32-byte
//    rows, B and C staged once a warp.)
//  * One exponential per state element, from A log2(e) formed once per
//    lane: exp(dt A) = ex2.approx.ftz(dt A log2(e) + 1) / 2, the + 1 in
//    the FFMA that forms the argument.  ex2.approx reduces a negative
//    argument x to a fraction 1 + x that it truncates, a bias of ~1-2 ulp
//    on every factor of a slow state (x near 0), and a slow state
//    remembers ~1 / |x| steps: with ex2(x) alone h_last missed
//    chip_smoke.py's limit of 1e-4 of its RMS at the ragged wave; with x
//    + 1 (rounded to nearest) the bias is gone and h_last is within 9e-6
//    of its RMS on the H100 (chip_smoke.py; tests/test_torch_scan_plan.py
//    shows that a same-signed bias of even 1 ulp a factor breaches 1e-4
//    of the RMS over 1,024 steps at the dt that softplus gives).  The
//    halving costs nothing: within a tile the state is kept scaled by
//    2^(tt + 1) (dt u scaled by it in the pass, y and the state scaled
//    back), which powers of two do exactly, so the bits are those of h =
//    (e / 2) h + (dt u) B.
//    A masked step (dt = 0) gives ex2(1) = 2: the state passes through
//    bitwise.  The softplus keeps torch's expf and log1pf (the scan's dt
//    must round to torch's); the gate's SiLU takes __expf and __fdividef
//    (within 2 ulp of torch's before its bf16 rounding).
//
// The backward kernels (the trainer's autograd rules, kernels/time_scan.py
// :: LinearScanFn, SelectiveScanFn, SsmScanFn).  The JAX package
// differentiates its lax.scan with XLA; the port's forward replaced that
// lax.scan, and each backward is a recurrence of the same shape run
// backward in time, so each gets a reverse-time kernel of its own, one
// launch a call.
//  * linear_scan_bwd: lambda = dL/dh_t walked t = S-1 .. 0 from g_hlast:
//    lambda += ghs_t; gg_t = lambda; ga_t = lambda h_{t-1} (h_{-1} = h0,
//    h_{t-1} read from the forward's hs); lambda = a_t lambda; gh0 =
//    lambda.  One thread a (sequence, channel), as linear_scan_kernel,
//    tiles of LIN_TT steps loaded into registers before they are walked;
//    every operation rounds as the plain version's (no contraction), so
//    the two agree bit for bit.  Bound by bytes (20 a (token, channel)).
//  * selective_scan_bwd, two entries on one templated body: the scan
//    alone in f32 (SelectiveScanFn) and the fused mixer core in T
//    (SsmScanFn, the trainer's Mamba path).  With e_t = exp(dt_t A) and
//    lambda_t = dL/dh_t (lambda_{S-1} = g_hlast + gy_{S-1} C_{S-1},
//    lambda_t = e_{t+1} lambda_{t+1} + gy_t C_t):
//      gC_t[n]  = sum_d gy_t[d] h_t[d, n]
//      gB_t[n]  = sum_d lambda_t[d, n] dt_t[d] u_t[d]
//      gu_t[d]  = dt_t[d] sum_n lambda_t[d, n] B_t[n]
//      gdt_t[d] = sum_n lambda_t[d, n] (A e_t h_{t-1} + u_t[d] B_t[n])
//      gA       = sum_{b, t} lambda_t dt_t e_t h_{t-1},  gh0 = e_0 lambda_0
//    The fused entry applies, in f32 registers, the derivatives of the
//    forward's rounding points: gy = g silu(z) (g the gated output's
//    gradient), gz = g s silu'(z) with s = T(T(y) + T(xc T(D))) and y
//    recomputed from the tile's states, g_xc = gu + gy T(D), gD = sum gy
//    xc, g_dt_lin = gdt sigmoid(x) (gdt past x = 20, torch's softplus),
//    g_dt_bias = sum g_dt_lin, g_A_log = gA A.
//    What bounds it: per state element and step one exponential (two as
//    built: the recompute's and the step back's), ~13 f32 operations and
//    two shuffled sums a channel, against ~4 bytes of inputs and outputs
//    a (token, channel) per state: the MUFU, the shuffles and shared
//    memory (one MIO queue an SM partition) and instruction issue, then
//    bytes.
//    Design:
//    - Checkpoints from the forward.  Running h backward divides by e,
//      which is unstable, so h is recomputed forward.  Under autograd the
//      forward stores the state entering each of its staged tiles
//      (TT_WAVE steps) into ck [Bt, tiles, din, N] (134 MB at [8, 512] x
//      8192 x 16), and the backward walks the tiles from the last.
//    - States across lanes, the tile's states in registers.  A channel's
//      16 states are spread over BWD_LANES = 4 lanes of 4 (64 channels a
//      256-thread block, two blocks an SM by registers): the tile's
//      recompute keeps h_{t-1} of all its 16 steps in registers (64 a
//      thread), in the forward's form h = ex2(dt A log2(e) + 1) / 2 h + dt
//      u B, which gives the recomputed h_t bitwise equal to the forward's
//      (its scaled form carries the same bits); the step back recomputes
//      e_t.  e_t kept as well would take 64 more registers (one block an
//      SM) or as many shared-memory reads as the MUFU's second pass costs
//      (measured free on the H100); at 8 states a lane the tile's states
//      alone take 128 registers, and at 2 (h and e both in registers) the
//      per-channel loads and sums cost more than the exponential saves.
//    - Staged tiles.  dt(_lin), u / xc, gy and z (the block's 64 channels),
//      the B and C rows and the tile's checkpoint rows are staged with
//      16-byte cp.async, two buffers deep (the tile before loads while this
//      one runs); one elementwise pass a tile forms dt, dt u and the scan's
//      gy in f32 (the softplus and the gate fused), another writes gu, gdt
//      (fused: every input's gradient) along the channels.
//    - Sums without float atomics.  sum_n lambda B and sum_n A q of a
//      channel: a shuffle level that splits the two, then one that adds
//      (fixed order).  gC and gB: a reduce-scatter over the warp's 8
//      channels, the warps added in order in shared memory, each block's
//      sums of a tile to a partial [Bt, tiles, blocks, TT, 2N]; the block
//      that arrives last at a (sequence, group of BWD_GROUP tiles)'s
//      counter adds the blocks' partials in channel order in the same
//      launch (as gptq_matmul.cu's split-K fix-up).  A block learns at its
//      next arrival whether it came last, so no warp waits for an atomic.
//      gA (fused: g_dt_bias and gD) per sequence, added over the sequences
//      by the last block of each channel column.  Two calls give the same
//      bits.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int N_STATE = 16;     // the state size instantiated
constexpr int THREADS = 256;    // threads of a selective-scan block
constexpr int TT_WAVE = 16;     // time steps of a staged tile (S > 1)
constexpr int MIN_BLOCKS = 4;   // blocks an SM by registers: 64 a thread
constexpr int LIN_THREADS = 64; // channels of a linear-scan block
constexpr int LIN_TT = 16;      // linear scan: time steps a register tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float SOFTPLUS_THRESHOLD = 20.f;
// selective_scan_bwd: states a lane, lanes a channel, threads and
// channels a block, time steps a tile (the forward's checkpoints), blocks
// an SM by registers (128 a thread)
constexpr int BWD_NS = 4;
constexpr int BWD_LANES = N_STATE / BWD_NS;
constexpr int BWD_THREADS = 256;
constexpr int BWD_CH = BWD_THREADS / BWD_LANES;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_TT = TT_WAVE;
constexpr int BWD_MIN_BLOCKS = 2;
constexpr int BWD_PART_A = N_STATE + 4;   // floats a (sequence, channel)
                                          // of part_a: gA, g_dt_bias, gD
constexpr int BWD_GROUP = 4;    // tiles a block's arrival counts for

struct ScanArgs {
  const void* dt;      // dt (f32), or dt_lin (T) when fused
  const void* u;       // u (f32), or xc (T)
  const void* z;       // fused: the gate's rows
  const void* B;
  const void* C;
  const float* A;      // A [din, N], or A_log when fused
  const float* dt_bias;
  const float* D;
  const float* h0;
  const uint8_t* mask; // fused: [Bt, S] or null
  void* y;
  float* h_last;
  float* ck;           // [Bt, ceil(S / TT_WAVE), din, N] or null: the state
                       // entering each staged tile (the backward's
                       // checkpoints; autograd's calls only)
  long long b_row, c_row, z_row;   // token strides of B, C, z (elements)
  int S, din;
};

__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// x rounded to the activation type T and back (a no-op at f32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return rt::to_f32(rt::from_f32<T>(x));
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, float* out) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(v.x << 16);
    out[1] = __uint_as_float(v.x & 0xFFFF0000u);
    out[2] = __uint_as_float(v.y << 16);
    out[3] = __uint_as_float(v.y & 0xFFFF0000u);
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float* v) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&lo);
    w.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = w;
  }
}

// NS consecutive floats (NS a multiple of 4, 16-byte aligned) as 16-byte
// vectors
template <int NS>
__device__ __forceinline__ void load_states(const float* p, float* v) {
  static_assert(NS % 4 == 0, "NS is a multiple of 4");
#pragma unroll
  for (int i = 0; i < NS; i += 4) {
    const float4 w = *reinterpret_cast<const float4*>(p + i);
    v[i] = w.x; v[i + 1] = w.y; v[i + 2] = w.z; v[i + 3] = w.w;
  }
}

template <int NS>
__device__ __forceinline__ void store_states(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < NS; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

// The plain version's dt from dt_lin (already in f32) and the T-rounded
// bias: T(softplus(T(dt_lin + bias))), torch's softplus at beta 1.
template <typename T>
__device__ __forceinline__ float softplus_dt(float lin, float bias_t) {
  const float x = round_to<T>(__fadd_rn(lin, bias_t));
  return round_to<T>(x > SOFTPLUS_THRESHOLD ? x : log1pf(expf(x)));
}

// The plain version's gated output from the scan's f32 y.
template <typename T>
__device__ __forceinline__ float gate_out(float y, float xc, float d_t,
                                          float z) {
  const float skip = round_to<T>(__fmul_rn(xc, d_t));
  const float s = round_to<T>(__fadd_rn(round_to<T>(y), skip));
  const float g = round_to<T>(__fdividef(z, 1.f + __expf(-z)));
  return __fmul_rn(s, g);
}

// 2^k as a float, exactly (k in -126 .. 127)
__device__ __forceinline__ float pow2(int k) {
  return __int_as_float((127 + k) << 23);
}

// The dynamic shared memory of a block (byte offsets): two buffers of
// the tile's raw rows ([NARR][TT][CH] of dt(_lin), u / xc, z, then [TT][2
// N] of B, C, all in T), then this tile's f32 dt, dt * u 2^(tt + 1)
// [TT][CH], the lanes' partial y [TT][THREADS] and B, C [TT][2 N].
template <typename T, bool FUSED, int NS, int TT>
struct Smem {
  static constexpr int LANES = N_STATE / NS;
  static constexpr int CH = THREADS / LANES;
  static constexpr int NARR = FUSED ? 3 : 2;
  static constexpr int RAW = (NARR * TT * CH + TT * 2 * N_STATE) * sizeof(T);
  static constexpr int F_DT = 2 * RAW;
  static constexpr int F_DX = F_DT + TT * CH * 4;
  static constexpr int F_PART = F_DX + TT * CH * 4;
  static constexpr int F_BC = F_PART + TT * THREADS * 4;
  static constexpr int BYTES = F_BC + TT * 2 * N_STATE * 4;
  static_assert(RAW % 16 == 0, "16-byte aligned buffers");
};

// T: the activation type; FUSED: the mixer core (else the scan alone);
// NS: states a lane; TT: time steps a staged tile.
template <typename T, bool FUSED, int NS, int TT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    selective_scan_kernel(const ScanArgs p) {
  using L = Smem<T, FUSED, NS, TT>;
  constexpr int LANES = L::LANES;          // lanes a channel
  constexpr int CH = L::CH;                // channels a block
  constexpr int VEC = 16 / sizeof(T);      // T values a 16-byte vector
  constexpr int ROW_VECS = CH / VEC;       // vectors a staged channel row
  constexpr int BC_VECS = N_STATE / VEC;   // vectors a row of B (or C)
  constexpr int ITEMS = TT * CH / 4;       // elementwise items a tile (x4)
  static_assert(CH % 8 == 0 && THREADS % (CH / 4) == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem[];
  auto raw = [&](int buf, int arr, int tt) {     // a staged channel row
    return reinterpret_cast<T*>(smem + buf * L::RAW) + (arr * TT + tt) * CH;
  };
  auto raw_bc = [&](int buf, int tt) {           // a staged B, C row
    return reinterpret_cast<T*>(smem + buf * L::RAW) + L::NARR * TT * CH
           + tt * 2 * N_STATE;
  };
  float* f_dt = reinterpret_cast<float*>(smem + L::F_DT);      // [TT][CH]
  float* f_dx = reinterpret_cast<float*>(smem + L::F_DX);      // [TT][CH]
  float* f_part = reinterpret_cast<float*>(smem + L::F_PART);  // [TT][THREADS]
  float* f_bc = reinterpret_cast<float*>(smem + L::F_BC);      // [TT][2N]

  const T* dt = static_cast<const T*>(p.dt);
  const T* u = static_cast<const T*>(p.u);
  const T* z = static_cast<const T*>(p.z);
  const T* Bm = static_cast<const T*>(p.B);
  const T* Cm = static_cast<const T*>(p.C);
  T* y = static_cast<T*>(p.y);
  const int S = p.S, din = p.din;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int tid = threadIdx.x;
  const long long row0 = (long long)b * S;   // this sequence's first token

  // the elementwise pass's channels: 4 from c4, the same on every item
  const int c4 = (tid % (CH / 4)) * 4;

  // the scan's lane: channel c, states l * NS .. l * NS + NS - 1
  const int c = tid / LANES, l = tid % LANES;
  const long long state = ((long long)b * din + d0 + c) * N_STATE + l * NS;
  float a2[NS], h[NS];

  auto load_tile = [&](int t0, int buf) {
    const int nt = min(TT, S - t0);
    constexpr int PER_ROW = L::NARR * ROW_VECS + 2 * BC_VECS;
    for (int i = tid; i < TT * PER_ROW; i += THREADS) {
      const int tt = i / PER_ROW;        // a row's vectors on adjacent
      const int k = i % PER_ROW;         // threads
      const bool in = tt < nt;
      const long long tok = row0 + t0 + (in ? tt : 0);
      if (k < L::NARR * ROW_VECS) {
        const int arr = k / ROW_VECS, v = k % ROW_VECS;
        const T* src = arr == 0 ? dt + tok * din
                       : arr == 1 ? u + tok * din : z + tok * p.z_row;
        rt::cp_async16(raw(buf, arr, tt) + v * VEC, src + d0 + v * VEC, in);
      } else {
        const int v = k - L::NARR * ROW_VECS;   // 0 .. 2 BC_VECS - 1
        const bool is_c = v >= BC_VECS;
        const int w = is_c ? v - BC_VECS : v;
        const T* src = is_c ? Cm + tok * p.c_row : Bm + tok * p.b_row;
        rt::cp_async16(raw_bc(buf, tt) + (is_c ? N_STATE : 0) + w * VEC,
                       src + w * VEC, in);
      }
    }
    rt::cp_async_commit();
  };

  // the previous tile's outputs (tile t0 in buffer buf): y_t of a channel
  // is its lanes' partial sums added pairwise in a fixed order, scaled
  // back by 2^-(tt + 1)
  auto write_out = [&](int t0, int buf) {
    const int nt = min(TT, S - t0);
    for (int i = tid; i < ITEMS; i += THREADS) {
      const int tt = i / (CH / 4);
      if (tt >= nt) continue;
      float yv[4], out[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* part = f_part + tt * THREADS + (c4 + j) * LANES;
        float v[LANES];
#pragma unroll
        for (int q = 0; q < LANES; q += 2) {
          const float2 w = *reinterpret_cast<const float2*>(part + q);
          v[q] = w.x; v[q + 1] = w.y;
        }
#pragma unroll
        for (int m = 1; m < LANES; m <<= 1)
#pragma unroll
          for (int q = 0; q < LANES; q += 2 * m) v[q] += v[q + m];
        yv[j] = v[0] * pow2(-(tt + 1));
      }
      if constexpr (FUSED) {
        float xv[4], zv[4], d_t[4];
        load_states<4>(p.D + d0 + c4, d_t);
        load4(raw(buf, 1, tt) + c4, xv);
        load4(raw(buf, 2, tt) + c4, zv);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          out[j] = gate_out<T>(yv[j], xv[j], round_to<T>(d_t[j]), zv[j]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) out[j] = yv[j];
      }
      store4(y + (row0 + t0 + tt) * din + d0 + c4, out);
    }
  };

  // this tile's dt and dt * u 2^(tt + 1) in f32, and its B, C rows in f32
  auto prepare = [&](int t0, int buf) {
    const int nt = min(TT, S - t0);
    float bias_t[4];
    if (FUSED) load_states<4>(p.dt_bias + d0 + c4, bias_t);
    for (int i = tid; i < ITEMS; i += THREADS) {
      const int tt = i / (CH / 4);
      float dv[4], uv[4];
      load4(raw(buf, 0, tt) + c4, dv);
      load4(raw(buf, 1, tt) + c4, uv);
      bool live = tt < nt;
      if (FUSED && live && p.mask != nullptr)
        live = p.mask[row0 + t0 + tt] != 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d =
            FUSED ? softplus_dt<T>(dv[j], round_to<T>(bias_t[j])) : dv[j];
        dv[j] = live ? d : 0.f;
        uv[j] = __fmul_rn(dv[j], uv[j]) * pow2(tt + 1);
      }
      *reinterpret_cast<float4*>(f_dt + tt * CH + c4) =
          make_float4(dv[0], dv[1], dv[2], dv[3]);
      *reinterpret_cast<float4*>(f_dx + tt * CH + c4) =
          make_float4(uv[0], uv[1], uv[2], uv[3]);
    }
    for (int i = tid; i < TT * 2 * N_STATE / 4; i += THREADS) {
      const int tt = i / (2 * N_STATE / 4), n = (i % (2 * N_STATE / 4)) * 4;
      float v[4];
      load4(raw_bc(buf, tt) + n, v);
      *reinterpret_cast<float4*>(f_bc + tt * 2 * N_STATE + n) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  };

  // one step of the recurrence on this lane's states, kept scaled by 2^(tt
  // + 1) within the tile: h' = ex2(dt A log2(e) + 1) h' + 2^(tt + 1) (dt u)
  // B; its partial y_t, scaled the same
  auto step = [&](int tt) {
    const float dtv = f_dt[tt * CH + c], dx = f_dx[tt * CH + c];
    float bv[NS], cv[NS];
    load_states<NS>(f_bc + tt * 2 * N_STATE + l * NS, bv);
    load_states<NS>(f_bc + tt * 2 * N_STATE + N_STATE + l * NS, cv);
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float e = ex2_approx(fmaf(dtv, a2[j], 1.f));
      h[j] = fmaf(e, h[j], dx * bv[j]);
      acc = j == 0 ? h[0] * cv[0] : fmaf(h[j], cv[j], acc);
    }
    f_part[tt * THREADS + tid] = acc;
  };

  const int ntiles = (S + TT - 1) / TT;
  if (ntiles > 0) load_tile(0, 0);    // in flight while A and h0 load
  load_states<NS>(p.A + (long long)(d0 + c) * N_STATE + l * NS, a2);
  load_states<NS>(p.h0 + state, h);
#pragma unroll
  for (int j = 0; j < NS; ++j) a2[j] = (FUSED ? -expf(a2[j]) : a2[j]) * LOG2E;
  for (int k = 0; k < ntiles; ++k) {
    const int t0 = k * TT, buf = k & 1;
    if (p.ck != nullptr)        // the state entering tile k, unscaled
      store_states<NS>(p.ck + (((long long)b * ntiles + k) * din + d0 + c)
                                  * N_STATE + l * NS, h);
    rt::cp_async_wait<0>();
    __syncthreads();            // tile k landed; scan k - 1 done
    if (k > 0) write_out(t0 - TT, buf ^ 1);
    prepare(t0, buf);
    __syncthreads();            // f_dt / f_dx / f_bc ready; buf ^ 1 free
    if (k + 1 < ntiles) load_tile(t0 + TT, buf ^ 1);
    const int nt = min(TT, S - t0);
    if (nt == TT) {
#pragma unroll
      for (int tt = 0; tt < TT; ++tt) step(tt);
    } else {
      for (int tt = 0; tt < nt; ++tt) step(tt);
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) h[j] *= pow2(-nt);
  }
  if (ntiles > 0) {
    __syncthreads();
    write_out((ntiles - 1) * TT, (ntiles - 1) & 1);
  }
  store_states<NS>(p.h_last + state, h);
}

__global__ void __launch_bounds__(LIN_THREADS) linear_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ g,
    const float* __restrict__ h0, float* __restrict__ hs,
    float* __restrict__ h_last, int S, int w) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * LIN_THREADS + threadIdx.x;
  if (c >= w) return;
  float h = h0[(size_t)b * w + c];
  const size_t base = (size_t)b * S * w + c;
  for (int t0 = 0; t0 < S; t0 += LIN_TT) {
    const int nt = min(LIN_TT, S - t0);
    float av[LIN_TT], gv[LIN_TT];
#pragma unroll
    for (int tt = 0; tt < LIN_TT; ++tt) {
      const size_t at = base + (size_t)(t0 + tt) * w;
      av[tt] = tt < nt ? a[at] : 0.f;
      gv[tt] = tt < nt ? g[at] : 0.f;
    }
#pragma unroll
    for (int tt = 0; tt < LIN_TT; ++tt) {
      if (tt < nt) {
        h = fmaf(av[tt], h, gv[tt]);
        hs[base + (size_t)(t0 + tt) * w] = h;
      }
    }
  }
  h_last[(size_t)b * w + c] = h;
}

__global__ void __launch_bounds__(LIN_THREADS) linear_scan_bwd_kernel(
    const float* __restrict__ a, const float* __restrict__ hs,
    const float* __restrict__ h0, const float* __restrict__ ghs,
    const float* __restrict__ g_hlast, float* __restrict__ ga,
    float* __restrict__ gg, float* __restrict__ gh0, int S, int w) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * LIN_THREADS + threadIdx.x;
  if (c >= w) return;
  float lam = g_hlast != nullptr ? g_hlast[(size_t)b * w + c] : 0.f;
  const float h_init = h0[(size_t)b * w + c];
  const size_t base = (size_t)b * S * w + c;
  for (int t1 = S; t1 > 0; t1 -= LIN_TT) {
    const int t0 = max(t1 - LIN_TT, 0), nt = t1 - t0;
    float av[LIN_TT], gv[LIN_TT], hp[LIN_TT];
#pragma unroll
    for (int tt = 0; tt < LIN_TT; ++tt) {
      const int t = t0 + tt;
      const size_t at = base + (size_t)t * w;
      av[tt] = tt < nt ? a[at] : 0.f;
      gv[tt] = tt < nt ? ghs[at] : 0.f;
      hp[tt] = tt >= nt ? 0.f : t > 0 ? hs[at - w] : h_init;
    }
#pragma unroll
    for (int tt = LIN_TT - 1; tt >= 0; --tt) {
      if (tt < nt) {
        const size_t at = base + (size_t)(t0 + tt) * w;
        lam = __fadd_rn(lam, gv[tt]);
        gg[at] = lam;
        ga[at] = __fmul_rn(lam, hp[tt]);
        lam = __fmul_rn(av[tt], lam);
      }
    }
  }
  gh0[(size_t)b * w + c] = lam;
}

// Channel-major rows of either entry (T) and the tile's checkpoints; see
// the header.  Pointers the scan alone does not use are null.
struct BwdArgs {
  const void* dt;        // dt [Bt, S, din] (f32), or dt_lin (T) when fused
  const void* u;         // u (f32), or xc (T)
  const void* gy;        // the output's gradient [Bt, S, din]: gy (f32),
                         // or the gated output's (T) when fused
  const void* z;         // fused: the gate's rows (token stride z_row)
  const void* B;         // [Bt, S, N] rows (token strides b_row, c_row)
  const void* C;
  const float* A;        // A [din, N], or A_log when fused
  const float* dt_bias;  // fused: [din]
  const float* D;        // fused: [din]
  const float* ck;       // the forward's checkpoints [Bt, tiles, din, N]
  const float* g_hlast;  // [Bt, din, N] or null (zero)
  void* gdt;             // gdt (f32), or g_dt_lin (T) when fused
  void* gu;              // gu (f32), or g_xc (T)
  void* gz;              // fused: [Bt, S, din] (T)
  void* gB;              // [Bt, S, N] contiguous (f32, or T when fused)
  void* gC;
  float* gA;             // [din, N]: gA, or g_A_log when fused
  float* g_dt_bias;      // fused: [din]
  float* gD;             // fused: [din]
  float* gh0;            // [Bt, din, N]
  float* part_bc;        // [Bt, tiles, din / BWD_CH, BWD_TT, 2N]: a block's
                         // gC, gB sums of each step of a tile
  float* part_a;         // [Bt, din, BWD_PART_A]: a sequence's gA (and,
                         // fused, g_dt_bias and gD) of each channel
  int* counters;         // Bt x ceil(tiles / BWD_GROUP) + din / BWD_CH,
                         // zero between launches
  float* h_end;          // [Bt, tiles, din, N] or null: the recomputed state
                         // at the end of each tile (chip_smoke.py's check)
  long long b_row, c_row, z_row;
  int S, din;
};

// One level of a reduce-scatter over the lanes that differ in lane bit
// BIT: of v[0 .. 2M - 1] a lane keeps the half its bit names and adds its
// partner's copy of that half (every sum in a fixed order)
template <int BIT, int M>
__device__ __forceinline__ void scatter_level(float* v, int lane) {
  const bool upper = (lane & BIT) != 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float send = upper ? v[i] : v[i + M];
    const float keep = upper ? v[i + M] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, BIT);
  }
}

template <typename T>
__device__ __forceinline__ void load2(const T* p, float* out) {
  if constexpr (std::is_same<T, float>::value) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
    out[0] = __uint_as_float(v << 16);
    out[1] = __uint_as_float(v & 0xFFFF0000u);
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
}

// The dynamic shared memory of a backward block (byte offsets): two
// buffers of the tile's raw rows ([NARR][TT][CH] of dt(_lin), u / xc, gy,
// z, then [TT][2N] of B, C, all in T); this tile's f32 (dt, dt u, the
// scan's gy) [TT][CH] as float4, B, C [TT][2N], each channel's sum_n
// lambda B and sum_n A q [TT][CH][2], the warps' gC, gB sums
// [TT][WARPS][2N]; fused: the lanes' partial y [TT][THREADS] and each
// elementwise item's sums of g_dt_bias and gD [TT][CH][2]; then two
// buffers of the tile's checkpoint rows [CH][N] (staged with the tile).
template <typename T, bool FUSED>
struct BwdSmem {
  static constexpr int NARR = FUSED ? 4 : 3;
  static constexpr int RAW =
      (NARR * BWD_TT * BWD_CH + BWD_TT * 2 * N_STATE) * sizeof(T);
  static constexpr int F_SC = 2 * RAW;
  static constexpr int F_BC = F_SC + BWD_TT * BWD_CH * 16;
  static constexpr int F_SQ = F_BC + BWD_TT * 2 * N_STATE * 4;
  static constexpr int F_RED = F_SQ + BWD_TT * BWD_CH * 2 * 4;
  static constexpr int F_Y = F_RED + BWD_TT * BWD_WARPS * 2 * N_STATE * 4;
  static constexpr int F_ACC = F_Y + (FUSED ? BWD_TT * BWD_THREADS * 4 : 0);
  static constexpr int F_CK = F_ACC + (FUSED ? BWD_TT * BWD_CH * 2 * 4 : 0);
  static constexpr int BYTES = F_CK + 2 * BWD_CH * N_STATE * 4;
  static_assert(RAW % 16 == 0, "16-byte aligned buffers");
};

// A gpu-scope acquire-release fence: orders the block's writes (after its
// barrier) before an arrival, and the last arrival before its reads
__device__ __forceinline__ void fence_gpu() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// exp(dt A) from dt and A log2(e): the forward's ex2(dt A log2(e) + 1) / 2
__device__ __forceinline__ float decay(float dt, float a2) {
  return ex2_approx(fmaf(dt, a2, 1.f)) * 0.5f;
}

// T: the activation type; FUSED: the mixer core's backward (else the scan
// alone's).  A block: BWD_CH channels of one sequence, BWD_LANES lanes a
// channel, BWD_NS states a lane; it walks the sequence's tiles from the
// last.
template <typename T, bool FUSED>
__global__ void __launch_bounds__(BWD_THREADS, BWD_MIN_BLOCKS)
    selective_scan_bwd_kernel(const BwdArgs p) {
  using L = BwdSmem<T, FUSED>;
  constexpr int NS = BWD_NS, LANES = BWD_LANES, CH = BWD_CH, TT = BWD_TT;
  constexpr int THREADS_B = BWD_THREADS, N2 = 2 * N_STATE;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int ROW_VECS = CH / VEC;
  constexpr int BC_VECS = N_STATE / VEC;
  constexpr int OUTS = TT * N2;          // gC, gB values of a tile
  static_assert(THREADS_B * 4 == TT * CH, "an item: 4 channels, 1 step");
  static_assert(THREADS_B * 2 == OUTS, "a thread: 2 of a tile's gC, gB");
  static_assert(LANES == 4 && NS == 4, "lane layout of the reductions");

  extern __shared__ __align__(16) unsigned char smem[];
  auto raw = [&](int buf, int arr, int tt) {
    return reinterpret_cast<T*>(smem + buf * L::RAW) + (arr * TT + tt) * CH;
  };
  auto raw_bc = [&](int buf, int tt) {
    return reinterpret_cast<T*>(smem + buf * L::RAW) + L::NARR * TT * CH
           + tt * N2;
  };
  float4* f_sc = reinterpret_cast<float4*>(smem + L::F_SC);  // [TT][CH]
  float* f_bc = reinterpret_cast<float*>(smem + L::F_BC);    // [TT][2N]
  float* f_sq = reinterpret_cast<float*>(smem + L::F_SQ);    // [TT][CH][2]
  float* f_red = reinterpret_cast<float*>(smem + L::F_RED);  // [TT][W][2N]
  float* f_y = reinterpret_cast<float*>(smem + L::F_Y);      // [TT][THREADS]
  float* f_acc = reinterpret_cast<float*>(smem + L::F_ACC);  // [TT][CH][2]
  auto f_ck = [&](int buf) {                                 // [CH][N]
    return reinterpret_cast<float*>(smem + L::F_CK) + buf * CH * N_STATE;
  };
  __shared__ int last_flag;

  const T* dt = static_cast<const T*>(p.dt);
  const T* u = static_cast<const T*>(p.u);
  const T* gy = static_cast<const T*>(p.gy);
  const T* z = static_cast<const T*>(p.z);
  const T* Bm = static_cast<const T*>(p.B);
  const T* Cm = static_cast<const T*>(p.C);
  const int S = p.S, din = p.din;
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int d0 = blk * CH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (S + TT - 1) / TT;
  const long long row0 = (long long)b * S;

  // the scan's lane: channel c, states l * NS .. l * NS + NS - 1
  const int c = tid / LANES, l = tid % LANES;
  const long long st = ((long long)b * din + d0 + c) * N_STATE + l * NS;
  // the elementwise items: step e_tt of channels e_c .. e_c + 3
  const int e_tt = tid / (CH / 4), e_c = (tid % (CH / 4)) * 4;

  float a[NS], a2[NS], lam[NS], gA[NS];
  load_states<NS>(p.A + (long long)(d0 + c) * N_STATE + l * NS, a);
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (FUSED) a[j] = -expf(a[j]);
    a2[j] = a[j] * LOG2E;          // the forward's A log2(e), bit for bit
    gA[j] = 0.f;
    lam[j] = 0.f;
  }
  if (p.g_hlast != nullptr) load_states<NS>(p.g_hlast + st, lam);
  if (FUSED) {
    for (int i = tid; i < TT * CH * 2; i += THREADS_B) f_acc[i] = 0.f;
  }

  auto load_tile = [&](int k, int buf) {
    const int t0 = k * TT, nt = min(TT, S - t0);
    constexpr int PER_ROW = L::NARR * ROW_VECS + 2 * BC_VECS;
    for (int i = tid; i < TT * PER_ROW; i += THREADS_B) {
      const int tt = i / PER_ROW, kk = i % PER_ROW;
      const bool in = tt < nt;
      const long long tok = row0 + t0 + (in ? tt : 0);
      if (kk < L::NARR * ROW_VECS) {
        const int arr = kk / ROW_VECS, v = kk % ROW_VECS;
        const T* src = arr == 0 ? dt + tok * din
                       : arr == 1 ? u + tok * din
                       : arr == 2 ? gy + tok * din : z + tok * p.z_row;
        rt::cp_async16(raw(buf, arr, tt) + v * VEC, src + d0 + v * VEC, in);
      } else {
        const int v = kk - L::NARR * ROW_VECS;
        const bool is_c = v >= BC_VECS;
        const int w = is_c ? v - BC_VECS : v;
        const T* src = is_c ? Cm + tok * p.c_row : Bm + tok * p.b_row;
        rt::cp_async16(raw_bc(buf, tt) + (is_c ? N_STATE : 0) + w * VEC,
                       src + w * VEC, in);
      }
    }
    // the state entering tile k, as the forward stored it
    const float* ck = p.ck + ((long long)b * ntiles + k) * din * N_STATE
                      + (long long)d0 * N_STATE;
    for (int i = tid; i < CH * N_STATE / 4; i += THREADS_B)
      rt::cp_async16(f_ck(buf) + 4 * i, ck + 4 * i, true);
    rt::cp_async_commit();
  };

  // this tile's dt, dt u and the scan's gy in f32 (fused: the softplus and
  // the bias, the gate's silu(z) times the output's gradient), B and C; a
  // step past S gets dt = 0 and gy = 0: the state passes it unchanged
  auto prepare = [&](int k, int buf) {
    const int nt = min(TT, S - k * TT);
    float dv[4], uv[4], gv[4];
    load4(raw(buf, 0, e_tt) + e_c, dv);
    load4(raw(buf, 1, e_tt) + e_c, uv);
    load4(raw(buf, 2, e_tt) + e_c, gv);
    const bool live = e_tt < nt;
    if (FUSED) {
      float zv[4], bias[4];
      load4(raw(buf, 3, e_tt) + e_c, zv);
      load_states<4>(p.dt_bias + d0 + e_c, bias);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dv[i] = softplus_dt<T>(dv[i], round_to<T>(bias[i]));
        gv[i] *= round_to<T>(__fdividef(zv[i], 1.f + __expf(-zv[i])));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dv[i] = live ? dv[i] : 0.f;
      gv[i] = live ? gv[i] : 0.f;
      f_sc[e_tt * CH + e_c + i] =
          make_float4(dv[i], __fmul_rn(dv[i], uv[i]), gv[i], 0.f);
    }
    for (int i = tid; i < TT * N2 / 4; i += THREADS_B) {
      const int tt = i / (N2 / 4), n = (i % (N2 / 4)) * 4;
      float v[4];
      load4(raw_bc(buf, tt) + n, v);
      *reinterpret_cast<float4*>(f_bc + tt * N2 + n) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  };

  // the tile's outputs from the step back's sums: gu, gdt (fused: the
  // softplus', the D skip's and the gate's derivatives applied)
  auto write_out = [&](int k, int buf) {
    const int t0 = k * TT, nt = min(TT, S - t0);
    if (e_tt >= nt) return;
    const long long at = (row0 + t0 + e_tt) * din + d0 + e_c;
    float sb[4], sq[4], uv[4], dv[4], gs[4];
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const float4 q = *reinterpret_cast<const float4*>(
          f_sq + (e_tt * CH + e_c + i) * 2);
      sb[i] = q.x; sq[i] = q.y; sb[i + 1] = q.z; sq[i + 1] = q.w;
    }
    load4(raw(buf, 1, e_tt) + e_c, uv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = f_sc[e_tt * CH + e_c + i];
      dv[i] = v.x;
      gs[i] = v.z;
    }
    if constexpr (!FUSED) {
      float gu[4], gdt[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        gu[i] = dv[i] * sb[i];
        gdt[i] = fmaf(uv[i], sb[i], sq[i]);
      }
      store4(static_cast<float*>(p.gu) + at, gu);
      store4(static_cast<float*>(p.gdt) + at, gdt);
    } else {
      float lin[4], zv[4], go[4], bias[4], dd[4], gx[4], gxc[4], gz[4];
      load4(raw(buf, 0, e_tt) + e_c, lin);
      load4(raw(buf, 2, e_tt) + e_c, go);
      load4(raw(buf, 3, e_tt) + e_c, zv);
      load_states<4>(p.dt_bias + d0 + e_c, bias);
      load_states<4>(p.D + d0 + e_c, dd);
      float* acc = f_acc + (e_tt * CH + e_c) * 2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // y_t: the channel's lanes' partial sums, pairwise in a fixed order
        const float4 w = *reinterpret_cast<const float4*>(
            f_y + e_tt * THREADS_B + (e_c + i) * LANES);
        const float yt = (w.x + w.y) + (w.z + w.w);
        const float d_t = round_to<T>(dd[i]);
        const float skip = round_to<T>(__fmul_rn(uv[i], d_t));
        const float s = round_to<T>(__fadd_rn(round_to<T>(yt), skip));
        const float sg = 1.f / (1.f + __expf(-zv[i]));
        gz[i] = go[i] * s * (sg * fmaf(zv[i], 1.f - sg, 1.f));
        gxc[i] = fmaf(gs[i], d_t, dv[i] * sb[i]);
        const float gdt = fmaf(uv[i], sb[i], sq[i]);
        const float x = round_to<T>(__fadd_rn(lin[i], round_to<T>(bias[i])));
        const float ex = expf(x);
        gx[i] = x > SOFTPLUS_THRESHOLD ? gdt : gdt * (ex / (ex + 1.f));
        acc[2 * i] += gx[i];
        acc[2 * i + 1] = fmaf(gs[i], uv[i], acc[2 * i + 1]);
      }
      store4(static_cast<T*>(p.gdt) + at, gx);
      store4(static_cast<T*>(p.gu) + at, gxc);
      store4(static_cast<T*>(p.gz) + at, gz);
    }
  };

  // gC, gB of a tile: the block's sums over its warps go to its partial;
  // a block arrives once a group of BWD_GROUP tiles, and the block that
  // arrives last among the sequence's blocks adds the blocks' partials of
  // the group's tiles in channel order.  A block learns whether it came
  // last at a group when it arrives at the next (its arrival's result is
  // not waited for in between: a fence and an arrival each tile held the
  // block's warps at the next barrier), and sums that group then.
  int pending = 0, pending_k = -1;       // thread 0: its last arrival
  const int o = 2 * tid, o_tt = o / N2, o_v = o % N2;
  auto part_of = [&](int k) {
    return p.part_bc + ((long long)b * ntiles + k) * nblk * OUTS;
  };
  const int ngroups = (ntiles + BWD_GROUP - 1) / BWD_GROUP;
  // a tile's gC, gB: each thread 2 values, the blocks' partials added in
  // channel order, 8 blocks in flight at once
  auto sum_tile = [&](int k) {
    const int t0 = k * TT, nt = min(TT, S - t0);
    const float* part = part_of(k);
    float2 acc = make_float2(0.f, 0.f);
    int jb = 0;
    for (; jb + 8 <= nblk; jb += 8) {
      float2 w[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        w[q] = __ldcg(reinterpret_cast<const float2*>(
            part + (long long)(jb + q) * OUTS + o));
#pragma unroll
      for (int q = 0; q < 8; ++q) { acc.x += w[q].x; acc.y += w[q].y; }
    }
    for (; jb < nblk; ++jb) {
      const float2 w = __ldcg(reinterpret_cast<const float2*>(
          part + (long long)jb * OUTS + o));
      acc.x += w.x; acc.y += w.y;
    }
    if (o_tt < nt) {   // values 0 .. N - 1 gC, N .. 2N - 1 gB
      T* dst = static_cast<T*>(o_v < N_STATE ? p.gC : p.gB);
      store2(dst + (row0 + t0 + o_tt) * N_STATE + o_v % N_STATE, acc.x,
             acc.y);
    }
  };
  auto sum_pending = [&](int g) {        // group g, after resolve()'s barrier
    if (!last_flag) return;
    fence_gpu();
    for (int k = g * BWD_GROUP; k < min(ntiles, (g + 1) * BWD_GROUP); ++k)
      sum_tile(k);
  };
  auto resolve = [&]() {                 // thread 0, before a barrier
    if (tid != 0) return;
    last_flag = 0;
    if (pending_k < 0) return;
    if (pending >= nblk) __trap();       // a launch that died part way
    last_flag = pending == nblk - 1;
    if (last_flag) p.counters[b * ngroups + pending_k] = 0;
  };
  auto write_bc = [&](int k) {
    float s0 = f_red[o_tt * BWD_WARPS * N2 + o_v];
    float s1 = f_red[o_tt * BWD_WARPS * N2 + o_v + 1];
#pragma unroll
    for (int w = 1; w < BWD_WARPS; ++w) {
      s0 += f_red[(o_tt * BWD_WARPS + w) * N2 + o_v];
      s1 += f_red[(o_tt * BWD_WARPS + w) * N2 + o_v + 1];
    }
    *reinterpret_cast<float2*>(part_of(k) + (long long)blk * OUTS + o) =
        make_float2(s0, s1);
    if (k % BWD_GROUP != 0) return;      // the group's first tile: arrive
    const int g = k / BWD_GROUP;
    resolve();
    __syncthreads();            // the partials written; last_flag set
    sum_pending(g + 1);         // the group before arrived one group ago
    if (tid == 0) {
      // one gpu-scope fence after the barrier orders every thread's
      // partials before the arrival (fences are cumulative)
      fence_gpu();
      pending = atomicAdd(p.counters + b * ngroups + g, 1);
      pending_k = g;
    }
  };

  float hp[TT][NS], h[NS];
  if (ntiles > 0) load_tile(ntiles - 1, 0);
  for (int k = ntiles - 1; k >= 0; --k) {
    const int buf = (ntiles - 1 - k) & 1;
    rt::cp_async_wait<0>();
    __syncthreads();            // tile k landed; tile k + 1's outputs done
    load_states<NS>(f_ck(buf) + c * N_STATE + l * NS, h);
    prepare(k, buf);
    __syncthreads();            // f_sc, f_bc ready
    if (k > 0) load_tile(k - 1, buf ^ 1);

    // the recompute: h_{t-1} of every step, h_t as the forward's (its
    // halved form: the same bits)
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      const float4 sc = f_sc[tt * CH + c];
      float bb[NS];
      load_states<NS>(f_bc + tt * N2 + l * NS, bb);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        hp[tt][j] = h[j];
        h[j] = fmaf(decay(sc.x, a2[j]), h[j], sc.y * bb[j]);
      }
      if (FUSED) {
        float cc[NS];
        load_states<NS>(f_bc + tt * N2 + N_STATE + l * NS, cc);
        float acc = h[0] * cc[0];
#pragma unroll
        for (int j = 1; j < NS; ++j) acc = fmaf(h[j], cc[j], acc);
        f_y[tt * THREADS_B + tid] = acc;
      }
    }
    if (p.h_end != nullptr)
      store_states<NS>(p.h_end + ((long long)b * ntiles + k) * din * N_STATE
                           + (long long)(d0 + c) * N_STATE + l * NS, h);

    // the step back, t = t0 + TT - 1 .. t0
#pragma unroll
    for (int tt = TT - 1; tt >= 0; --tt) {
      const float4 sc = f_sc[tt * CH + c];   // dt, dt u, gy
      float bb[NS], cc[NS], v[2 * NS];
      load_states<NS>(f_bc + tt * N2 + l * NS, bb);
      load_states<NS>(f_bc + tt * N2 + N_STATE + l * NS, cc);
      float sb = 0.f, sq = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float ht = tt == TT - 1 ? h[j] : hp[tt < TT - 1 ? tt + 1 : tt][j];
        const float e = decay(sc.x, a2[j]);
        lam[j] = fmaf(sc.z, cc[j], lam[j]);
        v[j] = sc.z * ht;                        // gC_t's part
        v[NS + j] = lam[j] * sc.y;               // gB_t's part
        const float le = lam[j] * e;             // lambda_{t-1}'s
        const float q = le * hp[tt][j];
        sb = fmaf(lam[j], bb[j], sb);
        sq = fmaf(a[j], q, sq);
        gA[j] = fmaf(sc.x, q, gA[j]);
        lam[j] = le;
      }
      // sum_n lambda B and sum_n A q over the channel's 4 lanes: lane bit
      // 0 splits the two, bit 1 adds
      float r[2] = {sb, sq};
      scatter_level<1, 1>(r, lane);
      r[0] += __shfl_xor_sync(0xffffffffu, r[0], 2);
      if (l < 2) f_sq[(tt * CH + c) * 2 + l] = r[0];
      // gC, gB over the warp's 8 channels (lane bits 4, 3, 2): the lane
      // keeps value (bit 4 ? gB : gC)[l NS + 2 bit 3 + bit 2]
      scatter_level<16, 4>(v, lane);
      scatter_level<8, 2>(v, lane);
      scatter_level<4, 1>(v, lane);
      f_red[(tt * BWD_WARPS + warp) * N2 + ((lane >> 4) & 1) * N_STATE
            + l * NS + ((lane >> 2) & 3)] = v[0];
    }
    __syncthreads();            // the tile's sums ready
    write_out(k, buf);
    write_bc(k);
  }
  resolve();
  __syncthreads();
  sum_pending(0);

  // gh0; each sequence's gA (fused: and g_dt_bias, gD) of the block's
  // channels, summed over the sequences by the column's last block
  store_states<NS>(p.gh0 + st, lam);
  constexpr int NA = BWD_PART_A;
  float* pa = p.part_a + (long long)b * din * NA;
  store_states<NS>(pa + (long long)(d0 + c) * NA + l * NS, gA);
  if (FUSED) {
    __syncthreads();            // every item's sums in f_acc
    if (tid < 2 * CH) {         // over the item rows, in order
      float s = f_acc[tid];
      for (int r = 1; r < TT; ++r) s += f_acc[r * CH * 2 + tid];
      pa[(long long)(d0 + tid / 2) * NA + N_STATE + tid % 2] = s;
    }
  }
  const int Bt = gridDim.y;
  __syncthreads();
  if (tid == 0) {
    fence_gpu();
    const int n = atomicAdd(p.counters + Bt * ngroups + blk, 1);
    if (n >= Bt) __trap();
    last_flag = n == Bt - 1;
    if (last_flag) p.counters[Bt * ngroups + blk] = 0;
  }
  __syncthreads();
  if (!last_flag) return;
  fence_gpu();
  float ga[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) ga[j] = 0.f;
  for (int bb = 0; bb < Bt; ++bb) {
    const float4 w = __ldcg(reinterpret_cast<const float4*>(
        p.part_a + ((long long)bb * din + d0 + c) * NA + l * NS));
    ga[0] += w.x; ga[1] += w.y; ga[2] += w.z; ga[3] += w.w;
  }
  if (FUSED) {
#pragma unroll
    for (int j = 0; j < NS; ++j) ga[j] *= a[j];
  }
  store_states<NS>(p.gA + (long long)(d0 + c) * N_STATE + l * NS, ga);
  if (FUSED && tid < 2 * CH) {
    float s = 0.f;
    for (int bb = 0; bb < Bt; ++bb)
      s += __ldcg(p.part_a + ((long long)bb * din + d0 + tid / 2) * NA
                  + N_STATE + tid % 2);
    (tid % 2 ? p.gD : p.g_dt_bias)[d0 + tid / 2] = s;
  }
}

template <typename T, bool FUSED, int NS, int TT>
int launch_one(const ScanArgs& p, int Bt, cudaStream_t s) {
  using L = Smem<T, FUSED, NS, TT>;
  if (p.din % L::CH != 0) return (int)cudaErrorInvalidValue;
  auto kernel = selective_scan_kernel<T, FUSED, NS, TT>;
  static size_t granted = 0;
  const cudaError_t e = rt::allow_smem(kernel, L::BYTES, &granted);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(p.din / L::CH, Bt), THREADS, L::BYTES, s>>>(p);
  return (int)cudaGetLastError();
}

// ns states a lane (8 or 4); a tile of TT_WAVE steps, or of 1 at decode
template <typename T, bool FUSED>
int launch_scan(const ScanArgs& p, int Bt, int ns, cudaStream_t s) {
  const bool decode = p.S == 1;
  if (ns == 8)
    return decode ? launch_one<T, FUSED, 8, 1>(p, Bt, s)
                  : launch_one<T, FUSED, 8, TT_WAVE>(p, Bt, s);
  if (ns == 4)
    return decode ? launch_one<T, FUSED, 4, 1>(p, Bt, s)
                  : launch_one<T, FUSED, 4, TT_WAVE>(p, Bt, s);
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int Bt, int S, int din, int N) {
  return Bt <= 0 || Bt > 65535 || din <= 0 || S < 0 || N != N_STATE;
}

}  // namespace

// The scan alone: f32 in, f32 out; ns states a lane (8 or 4); ck may be
// null.
extern "C" int selective_scan_launch(const float* dt, const float* u,
                                     const float* B, const float* C,
                                     const float* A, const float* h0,
                                     float* y, float* h_last, float* ck,
                                     int Bt, int S, int din, int N, int ns,
                                     void* stream) {
  if (bad_shape(Bt, S, din, N)) return (int)cudaErrorInvalidValue;
  ScanArgs p{dt, u, nullptr, B, C, A, nullptr, nullptr, h0, nullptr, y,
             h_last, ck, N, N, 0, S, din};
  return launch_scan<float, false>(p, Bt, ns, (cudaStream_t)stream);
}

// The fused mixer core; dtype 0 = f32, 1 = bf16 (dt_lin, xc, z, B, C and
// the output); mask and ck may be null.
extern "C" int selective_scan_fused_launch(
    const void* dt_lin, const float* dt_bias, const void* xc, const void* B,
    const void* C, const void* z, const float* A_log, const float* D,
    const float* h0, const uint8_t* mask, void* y, float* h_last,
    float* ck, long long b_row, long long c_row, long long z_row, int Bt,
    int S, int din, int N, int ns, int dtype, void* stream) {
  if (bad_shape(Bt, S, din, N)) return (int)cudaErrorInvalidValue;
  ScanArgs p{dt_lin, xc, z, B, C, A_log, dt_bias, D, h0, mask, y, h_last,
             ck, b_row, c_row, z_row, S, din};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == rt::DTYPE_F32) return launch_scan<float, true>(p, Bt, ns, s);
  if (dtype == rt::DTYPE_BF16)
    return launch_scan<__nv_bfloat16, true>(p, Bt, ns, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int linear_scan_launch(const float* a, const float* g,
                                  const float* h0, float* hs, float* h_last,
                                  int Bt, int S, int w, void* stream) {
  if (Bt <= 0 || Bt > 65535 || w <= 0 || S < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w + LIN_THREADS - 1) / LIN_THREADS, Bt);
  linear_scan_kernel<<<grid, LIN_THREADS, 0, (cudaStream_t)stream>>>(
      a, g, h0, hs, h_last, S, w);
  return (int)cudaGetLastError();
}

// The linear scan's backward; g_hlast may be null (a zero gradient).
extern "C" int linear_scan_bwd_launch(const float* a, const float* hs,
                                      const float* h0, const float* ghs,
                                      const float* g_hlast, float* ga,
                                      float* gg, float* gh0, int Bt, int S,
                                      int w, void* stream) {
  if (Bt <= 0 || Bt > 65535 || w <= 0 || S < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w + LIN_THREADS - 1) / LIN_THREADS, Bt);
  linear_scan_bwd_kernel<<<grid, LIN_THREADS, 0, (cudaStream_t)stream>>>(
      a, hs, h0, ghs, g_hlast, ga, gg, gh0, S, w);
  return (int)cudaGetLastError();
}

template <typename T, bool FUSED>
int launch_bwd(const BwdArgs& p, int Bt, cudaStream_t s) {
  using L = BwdSmem<T, FUSED>;
  if (p.din % BWD_CH != 0) return (int)cudaErrorInvalidValue;
  auto kernel = selective_scan_bwd_kernel<T, FUSED>;
  static size_t granted = 0;
  const cudaError_t e = rt::allow_smem(kernel, L::BYTES, &granted);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(p.din / BWD_CH, Bt), BWD_THREADS, L::BYTES, s>>>(p);
  return (int)cudaGetLastError();
}

// The selective scan's backward (the scan alone, f32): the forward's
// inputs, its checkpoints ck [Bt, ceil(S / TT_WAVE), din, N], gy and
// g_hlast (may be null); part (floats: Bt x tiles x din / BWD_CH x
// BWD_TT x 2N, then Bt x din x BWD_PART_A) and counters (Bt x
// ceil(tiles / BWD_GROUP) + din / BWD_CH ints, zero) are the caller's
// scratch (kernels/time_scan.py);
// h_end may be null.
extern "C" int selective_scan_bwd_launch(
    const float* dt, const float* u, const float* B, const float* C,
    const float* A, const float* ck, const float* gy, const float* g_hlast,
    float* gdt, float* gu, float* gB, float* gC, float* gA, float* gh0,
    float* part, int* counters, float* h_end, int Bt, int S, int din, int N,
    void* stream) {
  if (bad_shape(Bt, S, din, N)) return (int)cudaErrorInvalidValue;
  const long long tiles = (S + BWD_TT - 1) / BWD_TT;
  BwdArgs p{dt, u, gy, nullptr, B, C, A, nullptr, nullptr, ck, g_hlast, gdt,
            gu, nullptr, gB, gC, gA, nullptr, nullptr, gh0, part,
            part + Bt * tiles * din * BWD_TT * 2 * N_STATE / BWD_CH,
            counters, h_end, N, N, 0, S, din};
  return launch_bwd<float, false>(p, Bt, (cudaStream_t)stream);
}

// The fused mixer core's backward; dtype 0 = f32, 1 = bf16 (dt_lin, xc,
// z, B, C, g_out and their gradients); scratch as above.
extern "C" int selective_scan_fused_bwd_launch(
    const void* dt_lin, const float* dt_bias, const void* xc, const void* B,
    const void* C, const void* z, const float* A_log, const float* D,
    const float* ck, const void* g_out, const float* g_hlast,
    void* g_dt_lin, float* g_dt_bias, void* g_xc, void* gB, void* gC,
    void* gz, float* g_A_log, float* gD, float* gh0, float* part,
    int* counters, float* h_end, long long b_row, long long c_row,
    long long z_row, int Bt, int S, int din, int N, int dtype,
    void* stream) {
  if (bad_shape(Bt, S, din, N)) return (int)cudaErrorInvalidValue;
  const long long tiles = (S + BWD_TT - 1) / BWD_TT;
  BwdArgs p{dt_lin, xc, g_out, z, B, C, A_log, dt_bias, D, ck, g_hlast,
            g_dt_lin, g_xc, gz, gB, gC, g_A_log, g_dt_bias, gD, gh0, part,
            part + Bt * tiles * din * BWD_TT * 2 * N_STATE / BWD_CH,
            counters, h_end, b_row, c_row, z_row, S, din};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == rt::DTYPE_F32) return launch_bwd<float, true>(p, Bt, s);
  if (dtype == rt::DTYPE_BF16)
    return launch_bwd<__nv_bfloat16, true>(p, Bt, s);
  return (int)cudaErrorInvalidValue;
}
