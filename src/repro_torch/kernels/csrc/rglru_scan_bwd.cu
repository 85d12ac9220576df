// RG-LRU scan's backward for Hopper (sm_90a), written by hand.
//
// What it replaces: no TPU kernel. The JAX package defines no custom VJP
// for its Pallas rglru_scan_kernel (src/repro/kernels/rglru_scan.py); it
// takes the gradient by differentiating the plain associative scan
// repro.models.rglru.rglru_scan (src/repro/models/rglru.py:93). The port's
// forward runs K3 (rglru_scan.cu), so its gradient needs a kernel of its
// own: this one. Channel by channel, in f32, from the forward's saved h and
// the gradients dh of every h_t and dh_last of h_last = h_{S-1}:
//
//   g_t = dh_t + a_{t+1} g_{t+1}   (g_{S-1} = dh_{S-1} + dh_last),
//   dx_t = w_t g_t,  dlog_a_t = g_t (a_t h_{t-1} - a_t^2 x_t / w_t),  dh0 = a_0 g_0,
//
// with a_t = exp(log_a_t), w_t = sqrt(max(1 - exp(2 log_a_t), 0)) and
// h_{-1} = h0 (or 0): the plain version is repro_torch.kernels.ref.rglru_bwd.
// w is evaluated as K3 evaluates it, -expm1(2 log_a) under the root, so
// a^2 x / w does not cancel near a = 1 (the model's decays reach a =
// 0.9995, where w is about 0.032). At a = 1 exactly w is +0 (never -0):
// dx is 0 and dlog_a an infinity of the sign of -g x (NaN where g x is 0),
// as JAX's derivative of the square root at 0 gives; the model never gets
// there (log a = -8 softplus(Lambda) r with r > 0).
//
// The carry. What step t hands to step t - 1 is c_t = a_t g_t (g_{t-1} =
// dh_{t-1} + c_t), so the decay a_{t+1} that g_t's equation shifts by one
// step is the one the thread of step t + 1 already holds: it multiplies
// what that thread hands on, inside a warp's steps, across warps and
// across time blocks alike, and no thread reads a decay of another step.
// The chain starts from c_S = dh_last, and the carry left after step 0 is
// dh0.
//
// Layout. x, log_a, h, dh, dx and dlog_a are (B, S, C) with unit channel
// stride; the caller passes element strides for batch and sequence. h0,
// dh_last and dh0 are (B, C) with unit channel stride. Loads and stores are
// 4 bytes a thread: no alignment and no shape is refused.
//
// Bound. It reads dh, x, log_a and h (as h_{t-1}; h0 for t = 0) and writes
// dx and dlog_a, all f32, each once: 24 bytes an element against about 20
// operations, far below the card's ridge, so bytes. At recurrentgemma-9b's
// training call (4, 1024, 4096) that is 402.7 MB, 0.120 ms at 3.35 TB/s.
//
// Design: K3's, run backward in time. A block owns one batch row and a
// tile of LANES = 32 channels (one channel a lane, every warp access one
// 128-byte line) and walks its time blocks of T = WARPS x STEPS steps from
// the last to the first, the running carry in a register of warp 0:
//   1. each thread composes its STEPS steps' maps, last step first, into
//      one affine map of the carry: c_out = P c_in + Q, P = the product of
//      its a, Q = the chain c = a (dh + c) from 0 (a serial FMA chain);
//   2. the warps' maps go to shared memory, and warp 0 folds them into
//      the running carry, last warp first, writing each warp's incoming
//      carry (WARPS dependent FMAs a time block);
//   3. each thread runs its steps again from its incoming carry, last step
//      first: g = dh + c, dx = w g, dlog_a = g (a h_{t-1} - a^2 x / w),
//      c = a g, with coalesced stores.
// The next (earlier) time block's four loads are in flight meanwhile
// (PREFETCH). STEPS is 8, where the forward takes 16: a backward step
// reads four inputs, not two, and holding the next block's loads beside
// this block's at 16 steps would take 128 registers a thread for the
// loads alone, past the 128 that 512 threads leave each. Grid (ceil(C /
// 32), B): 512 blocks at B 4, C 4096.
//
// Occupancy (ptxas -v, nvcc 12.8, sm_90a): 119 registers a thread, no
// spills, 6,144 bytes of static shared memory; one block of 512 threads an
// SM. At the training call: 0.1548 ms, 77.6% of its 0.1202 ms bound
// (chip_smoke.py; H100 80GB HBM3, 700 W; the refinements' worth:
// scripts/torch_kernel_ab.py --kernel rglru_bwd --ablate).
//
// Order of summation and rounding. Against the serial chain from the last
// step: inside a warp's steps in phase 3 it is the same chain, from the
// carry the fold hands in; across warps the composed maps (P, Q, each
// rounded once a step) are applied to the carry in time order. a carries
// the rounding of log_a log2 e and ex2.approx's (2 ulp), the weight
// sqrt.approx's (1 ulp), as in K3 (tests/test_torch_rglru_bwd_kernel.py
// models this order on the CPU).
//
// Ragged edges. Steps past S load log_a = 0 and dh = 0: their map is the
// identity (a = 1), so dh_last reaches step S - 1 unchanged, and nothing
// past S is stored; lanes past C load zeros and store nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;         // channels a block: one a lane
constexpr int WARPS = 16;         // warps a block, each STEPS steps of a time block
constexpr int STEPS = 8;          // steps a thread composes
constexpr int T = WARPS * STEPS;  // time block
constexpr bool PREFETCH = true;   // the earlier time block's loads in flight during this one's work
constexpr bool FAST_EXP = true;   // a = ex2.approx(log_a * log2 e) instead of expf
constexpr bool FAST_SQRT = true;  // the weight's sqrt as sqrt.approx instead of sqrtf

__device__ __forceinline__ float decay(float log_a) {
  if constexpr (FAST_EXP) {
    float a;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(a) : "f"(log_a * 1.4426950408889634f));
    return a;
  } else {
    return expf(log_a);
  }
}

// w = sqrt(max(1 - exp(2 log_a), 0)), +0 (never -0) at log_a = 0
__device__ __forceinline__ float weight(float log_a) {
  float v = -expm1f(2.f * log_a);
  v = v > 0.f ? v : 0.f;
  if constexpr (FAST_SQRT) {
    float r;
    asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
    return r;
  } else {
    return sqrtf(v);
  }
}

struct Rows {  // element strides of a (B, S, C) tensor: batch, sequence
  int64_t b, s;
};

__global__ void __launch_bounds__(WARPS * 32)
    rglru_scan_bwd_kernel(const float* __restrict__ x, const float* __restrict__ log_a,
                          const float* __restrict__ h0, const float* __restrict__ h,
                          const float* __restrict__ dh, const float* __restrict__ dh_last,
                          float* __restrict__ dx, float* __restrict__ dla, float* __restrict__ dh0,
                          int S, int C, Rows sx, Rows sa, Rows sh, Rows sdh, Rows sdx, Rows sdla,
                          int64_t h0_sb, int64_t hl_sb, int64_t dh0_sb) {
  __shared__ float s_prod[WARPS][LANES];   // each warp's composed map: the product of its a
  __shared__ float s_sum[WARPS][LANES];    // ... and its chain from 0
  __shared__ float s_carry[WARPS][LANES];  // the carry entering each warp's steps (from later)

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = blockIdx.x * LANES + lane;
  const int b = blockIdx.y;
  const bool live = c < C;
  const float* xb = x + b * sx.b + c;
  const float* ab = log_a + b * sa.b + c;
  const float* hb = h + b * sh.b + c;
  const float* gb = dh + b * sdh.b + c;
  const float h_init = live && h0 != nullptr ? h0[b * h0_sb + c] : 0.f;
  float carry = 0.f;  // the running carry a_t g_t, kept by warp 0
  if (warp == 0 && live && dh_last != nullptr) carry = dh_last[b * hl_sb + c];

  float xv[STEPS], lv[STEPS], gv[STEPS], hv[STEPS];  // this thread's steps of the next time block
  auto load = [&](int t0) {
    const int t = t0 + warp * STEPS;
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const bool in = live && t + u < S;
      xv[u] = in ? xb[int64_t(t + u) * sx.s] : 0.f;
      lv[u] = in ? ab[int64_t(t + u) * sa.s] : 0.f;  // log a = 0, dh = 0: the identity map
      gv[u] = in ? gb[int64_t(t + u) * sdh.s] : 0.f;
      hv[u] = !in ? 0.f : t + u > 0 ? hb[int64_t(t + u - 1) * sh.s] : h_init;  // h_{t-1}
    }
  };

  const int n_blocks = (S + T - 1) / T;
  if (PREFETCH) load((n_blocks - 1) * T);
  for (int blk = n_blocks - 1; blk >= 0; --blk) {
    const int t0 = blk * T;
    if (!PREFETCH) load(t0);
    float la[STEPS], xx[STEPS], dd[STEPS], hp[STEPS];
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      la[u] = lv[u];
      xx[u] = xv[u];
      dd[u] = gv[u];
      hp[u] = hv[u];
    }
    if (PREFETCH && blk > 0) load(t0 - T);

    // 1. compose this thread's steps, last first: c_out = prod c_in + sum
    float prod = 1.f, sum = 0.f;
#pragma unroll
    for (int u = STEPS - 1; u >= 0; --u) {
      const float a = decay(la[u]);
      sum = a * (dd[u] + sum);
      prod *= a;
    }
    s_prod[warp][lane] = prod;
    s_sum[warp][lane] = sum;
    __syncthreads();
    // 2. fold the warps' maps into the running carry, the last warp first
    if (warp == 0) {
#pragma unroll
      for (int w = WARPS - 1; w >= 0; --w) {
        s_carry[w][lane] = carry;
        carry = fmaf(s_prod[w][lane], carry, s_sum[w][lane]);
      }
    }
    __syncthreads();
    // 3. this thread's steps from its incoming carry, last first
    float cin = s_carry[warp][lane];
    const int t = t0 + warp * STEPS;
#pragma unroll
    for (int u = STEPS - 1; u >= 0; --u) {
      const float a = decay(la[u]);
      const float w = weight(la[u]);
      const float g = dd[u] + cin;
      cin = a * g;
      if (live && t + u < S) {
        dx[b * sdx.b + int64_t(t + u) * sdx.s + c] = w * g;
        dla[b * sdla.b + int64_t(t + u) * sdla.s + c] = g * (a * hp[u] - a * a * xx[u] / w);
      }
    }
  }
  if (warp == 0 && live && dh0 != nullptr) dh0[b * dh0_sb + c] = carry;
}

}  // namespace

extern "C" {

// h0, dh_last and dh0 may be null (no initial state; a zero gradient of
// h_last; no initial state's gradient wanted). strides: 12 element strides,
// (batch, sequence) of x, log_a, h, dh, dx and dlog_a in that order.
// Returns cudaGetLastError() after the launch (0 on success).
int repro_rglru_scan_bwd(const void* x, const void* log_a, const void* h0, const void* h, const void* dh,
                         const void* dh_last, void* dx, void* dlog_a, void* dh0, int B, int S, int C,
                         const int64_t* strides, int64_t h0_sb, int64_t hl_sb, int64_t dh0_sb, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || B > 65535) return int(cudaErrorInvalidValue);
  const int64_t* s = strides;
  const dim3 grid((C + LANES - 1) / LANES, B);
  rglru_scan_bwd_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(log_a), static_cast<const float*>(h0),
      static_cast<const float*>(h), static_cast<const float*>(dh), static_cast<const float*>(dh_last),
      static_cast<float*>(dx), static_cast<float*>(dlog_a), static_cast<float*>(dh0), S, C, Rows{s[0], s[1]},
      Rows{s[2], s[3]}, Rows{s[4], s[5]}, Rows{s[6], s[7]}, Rows{s[8], s[9]}, Rows{s[10], s[11]}, h0_sb,
      hl_sb, dh0_sb);
  return int(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
