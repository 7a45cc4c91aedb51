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
// :: LinearScanFn, SelectiveScanFn).  The JAX package differentiates its
// lax.scan with XLA; the port's forward replaced that lax.scan, and each
// backward is a recurrence of the same shape run backward in time, so
// each gets a reverse-time kernel of its own, one launch a call.
//  * linear_scan_bwd: lambda = dL/dh_t walked t = S-1 .. 0 from g_hlast:
//    lambda += ghs_t; gg_t = lambda; ga_t = lambda h_{t-1} (h_{-1} = h0,
//    h_{t-1} read from the forward's hs); lambda = a_t lambda; gh0 =
//    lambda.  One thread a (sequence, channel), as linear_scan_kernel,
//    tiles of LIN_TT steps loaded into registers before they are walked;
//    every operation rounds as the plain version's (no contraction), so
//    the two agree bit for bit.  Bound by bytes (20 a (token, channel)).
//  * selective_scan_bwd, the scan alone in f32 at state size 16: with
//    e_t = exp(dt_t A) and lambda_t = dL/dh_t (lambda_{S-1} = g_hlast +
//    gy_{S-1} C_{S-1}, lambda_t = e_{t+1} lambda_{t+1} + gy_t C_t):
//      gC_t[n]  = sum_d gy_t[d] h_t[d, n]
//      gB_t[n]  = sum_d lambda_t[d, n] dt_t[d] u_t[d]
//      gu_t[d]  = dt_t[d] sum_n lambda_t[d, n] B_t[n]
//      gdt_t[d] = sum_n lambda_t[d, n] (A e_t h_{t-1} + u_t[d] B_t[n])
//      gA       = sum_{b, t} lambda_t dt_t e_t h_{t-1},  gh0 = e_0 lambda_0
//    Running h backward divides by e, which is unstable, so the kernel
//    recomputes h forward from checkpoints.  One thread owns a (sequence,
//    channel) with its 16 states in registers (BWD_CH channels a block).
//    Pass 1 runs the forward from h0 and writes the state entering each
//    chunk of BWD_K steps into a scratch buffer [Bt, ceil(S / BWD_K),
//    din, N] (the wrapper allocates it for the call: 537 MB at [8, 512]
//    x 8192 x 16).  Pass 2 walks the
//    chunks from the last: it recomputes the chunk's states h_{t-1} into
//    shared memory ([BWD_K][N][BWD_CH], each thread its own column), then
//    steps back through them.  gu and gdt are sums over the thread's own
//    states.  gB and gC sum over din, across threads and blocks, and are
//    summed without float atomics: each warp adds its lanes' 32 values
//    (gC then gB) by a reduce-scatter butterfly of shuffles (lane j ends
//    with value j), the block adds its warps' in order, and writes a
//    partial [Bt, S, din / BWD_CH, 2N]; gA is written per sequence [Bt,
//    din, N].  The wrapper sums both partials in a fixed order, so two
//    calls agree bit for bit.  Exponentials as the forward's: ex2(dt A
//    log2(e) + 1) / 2.  Per state element and step it does three (pass
//    1, the recompute, the step back) and ~12 other f32 operations, and
//    moves ~4 bytes of inputs and outputs: bound by the MUFU and by its
//    instruction rate (a simple body; making it fast is later work).
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
constexpr int BWD_CH = 64;      // selective_scan_bwd: channels a block
constexpr int BWD_K = 4;        // time steps between its checkpoints:
                                // its shared memory (17 KB a block)
                                // leaves registers to set the blocks an
                                // SM (8); at 16 steps, 3 blocks of 70 KB
                                // took 2x as long on the H100
constexpr int BWD_WARPS = BWD_CH / 32;

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

struct BwdArgs {
  const float* dt;       // [Bt, S, din]
  const float* u;        // [Bt, S, din]
  const float* B;        // [Bt, S, N]
  const float* C;        // [Bt, S, N]
  const float* A;        // [din, N]
  const float* h0;       // [Bt, din, N]
  const float* gy;       // [Bt, S, din]
  const float* g_hlast;  // [Bt, din, N] or null (zero)
  float* ck;             // scratch [Bt, ceil(S / BWD_K), din, N]
  float* gdt;            // [Bt, S, din]
  float* gu;             // [Bt, S, din]
  float* gcb;            // partials [Bt, S, din / BWD_CH, 2 N]: gC, gB
  float* ga;             // partials [Bt, din, N]
  float* gh0;            // [Bt, din, N]
  int S, din;
};

// exp(dt A) from dt log2(e) and A: ex2(dt A log2(e) + 1) / 2 (the
// forward's argument, its fraction rounded to nearest, not truncated)
__device__ __forceinline__ float decay(float dl, float a) {
  return ex2_approx(fmaf(dl, a, 1.f)) * 0.5f;
}

// One level of the reduce-scatter below: of v[0 .. 2M - 1], a lane keeps
// the half its lane bit M names and adds its partner's copy of it
template <int M>
__device__ __forceinline__ void reduce_scatter_level(float* v, int lane) {
  const bool upper = (lane & M) != 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float send = upper ? v[i] : v[i + M];
    const float keep = upper ? v[i + M] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// v[0 .. 31] summed over the warp's lanes: lane j ends with the sum of
// v[j] in v[0] (a butterfly that halves the values at each level: 31
// shuffles, every sum in a fixed order)
__device__ __forceinline__ void warp_reduce_scatter32(float* v, int lane) {
  reduce_scatter_level<16>(v, lane);
  reduce_scatter_level<8>(v, lane);
  reduce_scatter_level<4>(v, lane);
  reduce_scatter_level<2>(v, lane);
  reduce_scatter_level<1>(v, lane);
}

constexpr int BWD_SMEM = (BWD_K * N_STATE * BWD_CH + BWD_K * BWD_WARPS * 32)
                         * (int)sizeof(float);

__global__ void __launch_bounds__(BWD_CH) selective_scan_bwd_kernel(
    const BwdArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* hbuf = reinterpret_cast<float*>(smem);     // [BWD_K][N][BWD_CH]
  float* red = hbuf + BWD_K * N_STATE * BWD_CH;      // [BWD_K][WARPS][32]
  const int S = p.S, din = p.din;
  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int d = blockIdx.x * BWD_CH + tid;
  const int nck = (S + BWD_K - 1) / BWD_K;
  const long long row0 = (long long)b * S;
  const long long st = ((long long)b * din + d) * N_STATE;
  float a[N_STATE], h[N_STATE];
  load_states<N_STATE>(p.A + (long long)d * N_STATE, a);
  load_states<N_STATE>(p.h0 + st, h);

  // one step forward on this thread's states: h = e h + (dt u) B
  auto forward = [&](int t) {
    const long long at = (row0 + t) * din + d;
    const float dtv = p.dt[at];
    const float dx = dtv * p.u[at], dl = dtv * LOG2E;
    float bv[N_STATE];
    load_states<N_STATE>(p.B + (row0 + t) * N_STATE, bv);
#pragma unroll
    for (int j = 0; j < N_STATE; ++j)
      h[j] = fmaf(decay(dl, a[j]), h[j], dx * bv[j]);
  };
  auto ck_at = [&](int c) {
    return p.ck + (((long long)b * nck + c) * din + d) * N_STATE;
  };

  // pass 1: the state entering each chunk
  for (int t = 0; t < S; ++t) {
    if (t % BWD_K == 0) store_states<N_STATE>(ck_at(t / BWD_K), h);
    forward(t);
  }

  // pass 2: the chunks from the last
  float lam[N_STATE], gA[N_STATE];
  if (p.g_hlast != nullptr) {
    load_states<N_STATE>(p.g_hlast + st, lam);
  } else {
#pragma unroll
    for (int j = 0; j < N_STATE; ++j) lam[j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < N_STATE; ++j) gA[j] = 0.f;
  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * BWD_K, nt = min(BWD_K, S - t0);
    load_states<N_STATE>(ck_at(c), h);
    for (int tt = 0; tt < nt; ++tt) {            // h_{t-1} of each step
#pragma unroll
      for (int j = 0; j < N_STATE; ++j)
        hbuf[(tt * N_STATE + j) * BWD_CH + tid] = h[j];
      forward(t0 + tt);
    }
    for (int tt = nt - 1; tt >= 0; --tt) {
      const long long at = (row0 + t0 + tt) * din + d;
      const float dtv = p.dt[at], uv = p.u[at], g = p.gy[at];
      const float dx = dtv * uv, dl = dtv * LOG2E;
      float bv[N_STATE], cv[N_STATE], v[2 * N_STATE];
      load_states<N_STATE>(p.B + (row0 + t0 + tt) * N_STATE, bv);
      load_states<N_STATE>(p.C + (row0 + t0 + tt) * N_STATE, cv);
      float sb = 0.f, sq = 0.f;
#pragma unroll
      for (int j = 0; j < N_STATE; ++j) {
        const float hp = hbuf[(tt * N_STATE + j) * BWD_CH + tid];
        const float e = decay(dl, a[j]);
        const float hc = fmaf(e, hp, dx * bv[j]);     // h_t, as pass 1's
        lam[j] = fmaf(g, cv[j], lam[j]);
        v[j] = g * hc;                                // gC_t's part
        v[N_STATE + j] = lam[j] * dx;                 // gB_t's part
        const float q = lam[j] * e * hp;
        sb = fmaf(lam[j], bv[j], sb);
        sq = fmaf(a[j], q, sq);
        gA[j] = fmaf(dtv, q, gA[j]);
        lam[j] *= e;
      }
      p.gu[at] = dtv * sb;
      p.gdt[at] = fmaf(uv, sb, sq);
      warp_reduce_scatter32(v, lane);
      red[(tt * BWD_WARPS + warp) * 32 + lane] = v[0];
    }
    __syncthreads();                              // the chunk's warp sums
    for (int i = tid; i < nt * 2 * N_STATE; i += BWD_CH) {
      const int tt = i / (2 * N_STATE), j = i % (2 * N_STATE);
      float sum = red[tt * BWD_WARPS * 32 + j];
#pragma unroll
      for (int w = 1; w < BWD_WARPS; ++w)
        sum += red[(tt * BWD_WARPS + w) * 32 + j];
      p.gcb[((row0 + t0 + tt) * gridDim.x + blockIdx.x) * 2 * N_STATE + j]
          = sum;
    }
    __syncthreads();                              // red free again
  }
  store_states<N_STATE>(p.gh0 + st, lam);
  store_states<N_STATE>(p.ga + st, gA);
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

// The scan alone: f32 in, f32 out; ns states a lane (8 or 4).
extern "C" int selective_scan_launch(const float* dt, const float* u,
                                     const float* B, const float* C,
                                     const float* A, const float* h0,
                                     float* y, float* h_last, int Bt, int S,
                                     int din, int N, int ns, void* stream) {
  if (bad_shape(Bt, S, din, N)) return (int)cudaErrorInvalidValue;
  ScanArgs p{dt, u, nullptr, B, C, A, nullptr, nullptr, h0, nullptr, y,
             h_last, N, N, 0, S, din};
  return launch_scan<float, false>(p, Bt, ns, (cudaStream_t)stream);
}

// The fused mixer core; dtype 0 = f32, 1 = bf16 (dt_lin, xc, z, B, C and
// the output); mask may be null.
extern "C" int selective_scan_fused_launch(
    const void* dt_lin, const float* dt_bias, const void* xc, const void* B,
    const void* C, const void* z, const float* A_log, const float* D,
    const float* h0, const uint8_t* mask, void* y, float* h_last,
    long long b_row, long long c_row, long long z_row, int Bt, int S,
    int din, int N, int ns, int dtype, void* stream) {
  if (bad_shape(Bt, S, din, N)) return (int)cudaErrorInvalidValue;
  ScanArgs p{dt_lin, xc, z, B, C, A_log, dt_bias, D, h0, mask, y, h_last,
             b_row, c_row, z_row, S, din};
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

// The selective scan's backward (the scan alone, f32); g_hlast may be
// null; ck [Bt, ceil(S / BWD_K), din, N], gcb [Bt, S, din / BWD_CH, 2 N]
// and ga [Bt, din, N] are the caller's scratch and partials
// (kernels/time_scan.py: BWD_CHANNELS, BWD_CHUNK).
extern "C" int selective_scan_bwd_launch(
    const float* dt, const float* u, const float* B, const float* C,
    const float* A, const float* h0, const float* gy, const float* g_hlast,
    float* ck, float* gdt, float* gu, float* gcb, float* ga, float* gh0,
    int Bt, int S, int din, int N, void* stream) {
  if (bad_shape(Bt, S, din, N) || din % BWD_CH != 0)
    return (int)cudaErrorInvalidValue;
  static size_t granted = 0;
  const cudaError_t e =
      rt::allow_smem(selective_scan_bwd_kernel, BWD_SMEM, &granted);
  if (e != cudaSuccess) return (int)e;
  BwdArgs p{dt, u, B, C, A, h0, gy, g_hlast, ck, gdt, gu, gcb, ga, gh0, S,
            din};
  selective_scan_bwd_kernel<<<dim3(din / BWD_CH, Bt), BWD_CH, BWD_SMEM,
                              (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

