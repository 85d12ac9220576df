// RG-LRU linear-recurrence scan for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (_rglru_kernel, l.30; rglru_scan_kernel, l.83) and computes what it
// computes, channel by channel, in f32:
//
//   a_t = exp(log_a_t),  b_t = sqrt(max(1 - exp(2 log_a_t), 0)) x_t,
//   h_t = a_t h_{t-1} + b_t  from h_{-1} = h0 (or 0),
//
// returning every h_t and h_last = h_{S-1}. The input weight keeps the TPU
// kernel's exp(2 log_a) form, evaluated as -expm1(2 log_a): 1 - exp(2 log_a)
// cancels when a is near 1 (the model's decays reach a = 0.9995), and with
// expf's error of up to 2 ulp the cancellation alone moves h by more than
// the 1e-5 the kernel is held to; expm1f has none. The plain version
// (repro.kernels.ref.rglru) uses 1 - a * a, which cancels the same way, so
// where the recurrence is long the kernel is held to a float64 run.
//
// Layout. x, log_a and h are (B, S, C) with unit channel stride; the
// caller passes element strides for batch and sequence. h0 and h_last are
// (B, C) with unit channel stride. Loads and stores are 4 bytes a thread,
// so no alignment and no shape is refused.
//
// Bound. About 8 operations an element against 12 bytes moved (x and
// log_a read, h written, all f32, each once): bound by bytes, far below
// the card's ridge. At recurrentgemma-9b's (4, 3000, 4096) that is 0.59 GB,
// 0.176 ms at 3.35 TB/s.
//
// Design. The TPU kernel walks a batch row's time blocks in order along a
// sequential grid axis and scans inside a block with a log-depth doubling
// scan (log2 256 = 8 passes over the tile). Here a block owns one batch
// row and a tile of LANES = 32 channels (one 128-byte line a step, one
// channel a lane) and walks its time blocks of T = WARPS x STEPS = 256
// steps in order, the running state in a register of warp 0. Inside a
// time block each warp takes STEPS consecutive steps and each lane one
// channel, so every warp access is one line:
//
//   1. each thread composes its STEPS steps' affine maps from the identity,
//      keeping every prefix: P_u = a_0 ... a_u and Q_u = the scan of
//      h = a h + b from 0 (a serial FMA chain, STEPS long);
//   2. the warps' whole maps (P, Q of their last step) go to shared memory,
//      and warp 0 folds them in order into the running state, writing
//      each warp's incoming state (WARPS dependent FMAs a time block);
//   3. each thread writes h_u = Q_u + P_u carry_in, STEPS independent FMAs
//      and coalesced stores.
//
// Each byte is read once and written once (12 B an element): x and log_a
// go from the load to the thread that composes them, in registers. Grid
// (ceil(C / 32), B): 128 blocks at B 1 and 512 at B 4 with C 4096, so B 1
// fills 128 of the 132 SMs without splitting S across blocks (a decoupled
// look-back would reach the last 4 SMs at the price of flags, a ticket
// counter and a scratch to clear each call).
//
// What bounds it. With one block an SM the SM's own instruction stream,
// not the memory, sets the pace: about 40 instructions an element (the
// exps, the sqrt, two loads, a store and their addresses) on 16 warps. The
// refinements, each a constant below and each measured on and off
// (PERF.md, Findings; scripts/torch_kernel_ab.py --kernel rglru --ablate):
//   - PREFETCH: the next time block's loads are issued before this block's
//     exps, so 64 KB a block is in flight while it composes, combines and
//     stores (without it every time block waits for its loads);
//   - FAST_EXP: a = ex2.approx(log_a log2 e), fewer instructions than expf;
//   - FAST_SQRT: the weight's sqrt as sqrt.approx, without sqrtf's
//     correction and special-case branch.
// A shared-memory ring filled by cp.async (4-byte copies, any alignment;
// 3 stages of 64 KB) was slower at both shapes: it adds a copy and a
// shared-memory read an element to a kernel bound by its instructions.
//
// Occupancy (ptxas -v, nvcc 12.8, sm_90a): 105 registers a thread, no
// spills; 6,144 bytes of static shared memory a block (the warps' maps and
// carries), so no attribute is raised; one block of 512 threads an SM.
//
// Order of summation and rounding. Against the serial chain
// h_t = a_t h_{t-1} + b_t: inside a warp's steps the chain is the same but
// starts from 0, and the carried state enters as one product P_u carry
// (P_u rounded once a step, u < STEPS); across warps the composed maps
// (P, Q) are applied to the state in time order. a carries the rounding
// of log_a log2 e and ex2.approx's (2 ulp), the weight sqrt.approx's (1
// ulp). h stays well inside the float64 yardstick: 0.11-0.12 of the 1e-4
// tolerance at the path's shape, where expf gave 0.28 (H100 80GB HBM3,
// 700 W; tests/test_torch_rglru_kernel.py models this order on the CPU).
//
// Ragged edges. Steps past S load log_a = 0 and x = 0, whose map is the
// identity (a = 1, b = 0), and are not stored; lanes past C load zeros
// and store nothing. Any S >= 1 and C >= 1 is taken.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;           // channels a block: one a lane
constexpr int WARPS = 16;           // warps a block, each STEPS steps of a time block
constexpr int STEPS = 16;           // steps a thread composes
constexpr int T = WARPS * STEPS;    // time block
constexpr bool PREFETCH = true;     // next time block's loads in flight during this one's work
constexpr bool FAST_EXP = true;     // a = ex2.approx(log_a * log2 e) instead of expf
constexpr bool FAST_SQRT = true;    // the weight's sqrt as sqrt.approx instead of sqrtf

__device__ __forceinline__ float decay(float log_a) {
  if constexpr (FAST_EXP) {
    float a;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(a) : "f"(log_a * 1.4426950408889634f));
    return a;
  } else {
    return expf(log_a);
  }
}

__device__ __forceinline__ float root(float v) {
  if constexpr (FAST_SQRT) {
    float r;
    asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
    return r;
  } else {
    return sqrtf(v);
  }
}

__global__ void __launch_bounds__(WARPS * 32)
    rglru_scan_kernel(const float* __restrict__ x, const float* __restrict__ log_a,
                      const float* __restrict__ h0, float* __restrict__ h,
                      float* __restrict__ h_last, int S, int C, int64_t x_sb, int64_t x_ss,
                      int64_t a_sb, int64_t a_ss, int64_t h_sb, int64_t h_ss, int64_t h0_sb,
                      int64_t hl_sb) {
  __shared__ float s_prod[WARPS][LANES];   // each warp's composed map: the product of its a
  __shared__ float s_sum[WARPS][LANES];    // ... and its scan from 0
  __shared__ float s_carry[WARPS][LANES];  // the state entering each warp's steps

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = blockIdx.x * LANES + lane;
  const int b = blockIdx.y;
  const bool live = c < C;
  const float* xb = x + b * x_sb + c;
  const float* ab = log_a + b * a_sb + c;
  float* hb = h + b * h_sb + c;
  float state = 0.f;  // the running state, kept by warp 0
  if (warp == 0 && live && h0 != nullptr) state = h0[b * h0_sb + c];

  float xv[STEPS], lv[STEPS];  // this thread's steps of the next time block
  auto load = [&](int t0) {
    const int t = t0 + warp * STEPS;
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const bool in = live && t + u < S;
      xv[u] = in ? xb[int64_t(t + u) * x_ss] : 0.f;
      lv[u] = in ? ab[int64_t(t + u) * a_ss] : 0.f;  // log a = 0, x = 0: the identity map
    }
  };

  if (PREFETCH) load(0);
  for (int t0 = 0; t0 < S; t0 += T) {
    if (!PREFETCH) load(t0);
    float p[STEPS], q[STEPS];
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      p[u] = lv[u];
      q[u] = xv[u];
    }
    if (PREFETCH && t0 + T < S) load(t0 + T);

    // 1. compose this thread's steps, keeping every prefix
    float prod = 1.f, sum = 0.f;
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const float la = p[u];
      const float a = decay(la);
      const float bt = root(fmaxf(-expm1f(2.f * la), 0.f)) * q[u];
      sum = fmaf(a, sum, bt);
      prod *= a;
      p[u] = prod;
      q[u] = sum;
    }
    s_prod[warp][lane] = prod;
    s_sum[warp][lane] = sum;
    __syncthreads();
    // 2. fold the warps' maps into the running state, in time order
    if (warp == 0) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        s_carry[w][lane] = state;
        state = fmaf(s_prod[w][lane], state, s_sum[w][lane]);
      }
    }
    __syncthreads();
    // 3. h = Q + P carry_in
    const float carry = s_carry[warp][lane];
    const int t = t0 + warp * STEPS;
#pragma unroll
    for (int u = 0; u < STEPS; ++u)
      if (live && t + u < S) hb[int64_t(t + u) * h_ss] = fmaf(p[u], carry, q[u]);
  }
  if (warp == 0 && live) h_last[b * hl_sb + c] = state;
}

}  // namespace

extern "C" {

// h0 may be null (a zero initial state). Returns cudaGetLastError() after
// the launch (0 on success).
int repro_rglru_scan_fwd(const void* x, const void* log_a, const void* h0, void* h, void* h_last,
                         int B, int S, int C, int64_t x_sb, int64_t x_ss, int64_t a_sb,
                         int64_t a_ss, int64_t h_sb, int64_t h_ss, int64_t h0_sb, int64_t hl_sb,
                         void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || B > 65535) return int(cudaErrorInvalidValue);
  const dim3 grid((C + LANES - 1) / LANES, B);
  rglru_scan_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(log_a),
      static_cast<const float*>(h0), static_cast<float*>(h), static_cast<float*>(h_last), S, C,
      x_sb, x_ss, a_sb, a_ss, h_sb, h_ss, h0_sb, hl_sb);
  return int(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
