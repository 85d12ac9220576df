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
// (B, C) with unit channel stride.
//
// Bound. A few flops per element against 12 bytes moved (x and log_a read,
// h written, all f32): bound by bytes, far below the card's ridge.
//
// Design. Channels are independent, so one thread owns one (batch,
// channel) and walks the sequence with the state in a register: the TPU
// grid's sequential axis becomes the thread's loop, and no block waits on
// another. Neighbouring threads own neighbouring channels, so each load
// and store of a warp is one contiguous 128-byte line. A dependent chain
// of FMAs alone would keep one load in flight per thread, far too few to
// cover the memory latency with only B * C threads (16,384 at the serving
// shape, about one warp group per SM). So each thread loads U timesteps of
// x and log_a ahead, computes their a_t and b_t (independent of the chain),
// and only then runs U FMAs of the chain. S need not divide U: steps past
// S are masked.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;  // one warp a block: B = 1 still spreads over 128 SMs
constexpr int U = 32;        // timesteps loaded ahead of the chain

__global__ void __launch_bounds__(THREADS)
    rglru_scan_kernel(const float* __restrict__ x, const float* __restrict__ log_a,
                      const float* __restrict__ h0, float* __restrict__ h,
                      float* __restrict__ h_last, int S, int C, int64_t x_sb, int64_t x_ss,
                      int64_t a_sb, int64_t a_ss, int64_t h_sb, int64_t h_ss, int64_t h0_sb,
                      int64_t hl_sb) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= C) return;
  const float* xb = x + b * x_sb + c;
  const float* ab = log_a + b * a_sb + c;
  float* hb = h + b * h_sb + c;
  float state = h0 != nullptr ? h0[b * h0_sb + c] : 0.f;

  for (int t0 = 0; t0 < S; t0 += U) {
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // all loads first: U in flight per thread
      const int t = t0 + u;
      av[u] = t < S ? ab[t * a_ss] : 0.f;
      bv[u] = t < S ? xb[t * x_ss] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {  // off the chain
      const float la = av[u];
      av[u] = expf(la);
      bv[u] *= sqrtf(fmaxf(-expm1f(2.f * la), 0.f));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < S) {
        state = av[u] * state + bv[u];
        hb[t * h_ss] = state;
      }
    }
  }
  h_last[b * hl_sb + c] = state;
}

}  // namespace

extern "C" {

// h0 may be null (a zero initial state). Returns cudaGetLastError() after
// the launch (0 on success).
int repro_rglru_scan_fwd(const void* x, const void* log_a, const void* h0, void* h, void* h_last,
                         int B, int S, int C, int64_t x_sb, int64_t x_ss, int64_t a_sb,
                         int64_t a_ss, int64_t h_sb, int64_t h_ss, int64_t h0_sb, int64_t hl_sb,
                         void* stream) {
  if (B <= 0 || S <= 0 || C <= 0) return int(cudaErrorInvalidValue);
  const dim3 grid((C + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(log_a),
      static_cast<const float*>(h0), static_cast<float*>(h), static_cast<float*>(h_last), S, C,
      x_sb, x_ss, a_sb, a_ss, h_sb, h_ss, h0_sb, hl_sb);
  return int(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
