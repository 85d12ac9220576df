// The global gradient norm of a tree of leaves and the clip scale from it,
// for Hopper (sm_90a), written by hand: the first half of the port's
// adamw8bit update, whose kernel (adamw8bit.cu) applies the scale as it
// reads g.
//
// No TPU kernel stands behind it: the JAX package's clip_by_global_norm is
// XLA ops (src/repro/train/optimizer.py:48-52). This computes
//
//   g2 = sum over leaves of sum g.float()^2,  norm = sqrt(g2),
//   scale = min(1, (norm + 1e-9)^-1 * max_norm)
//
// The scale takes PyTorch's form of max_norm / (norm + 1e-9), the
// reciprocal rounded and then the product (Tensor.__rtruediv__), as the
// plain version (repro_torch.kernels.ref.global_norm) writes it; min
// passes a NaN on, as torch.clamp does.
//
// Two kernels. One launch a leaf (sumsq_kernel) writes f32 partial sums of
// its squares, one a thread block, into its own slice of a scratch buffer
// the wrapper allocates; a final one-block launch (finish_kernel) adds all
// the partials in a fixed order and writes (norm, scale) to the device.
// The grid depends on the leaf's size alone and every sum runs in a fixed
// order, with no atomics: a call gives the same bits every time. The f32
// sums differ from the plain version's in their order only (a thread adds
// at most a few thousand squares, in four running sums).
//
// Bound. Bytes: each gradient read once (2 bytes an element in bf16),
// 12.1 GB, 3.6 ms at 3.35 TB/s for yi-6b's tree; two operations an
// element. Design: 16-byte loads, four in flight a thread, 8 warps a
// block, up to 1024 blocks a leaf; nothing is read back to the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PARTS = 1024;              // partial sums a leaf at most
constexpr int64_t PART_ELEMS = 64 * 1024;    // elements a partial covers at least
constexpr int UNROLL = 4;                    // 16-byte loads in flight a thread
constexpr int FINISH_THREADS = 1024;

// the sum of the squares of a 16-byte chunk's elements
__device__ __forceinline__ float sq_sum16(const uint4& raw, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float a = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    a = __fmaf_rn(f.x, f.x, a);
    a = __fmaf_rn(f.y, f.y, a);
  }
  return a;
}
__device__ __forceinline__ float sq_sum16(const uint4& raw, float) {
  const float* f = reinterpret_cast<const float*>(&raw);
  float a = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) a = __fmaf_rn(f[k], f[k], a);
  return a;
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// the block's sum of ``x``, in a fixed order; valid in thread 0
template <int N>
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warps[N / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = x;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < N / 32; ++w) total = __fadd_rn(total, warps[w]);
  }
  return total;
}

// one partial a block: the sum of the squares of the elements it strides
// over. VEC: the base is 16-byte aligned (16-byte loads, the tail by
// element); else element by element.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS) sumsq_kernel(const T* __restrict__ g, int64_t numel,
                                                        float* __restrict__ partials) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * THREADS;
  float acc[UNROLL] = {};
  int64_t done = 0;
  if (VEC) {
    constexpr int PER = 16 / sizeof(T);  // elements a 16-byte load
    const uint4* src = reinterpret_cast<const uint4*>(g);
    const int64_t nvec = numel / PER;
    int64_t i = tid;
    for (; i + (UNROLL - 1) * nthreads < nvec; i += UNROLL * nthreads) {
      uint4 raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) raw[u] = __ldg(src + i + u * nthreads);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) acc[u] = __fadd_rn(acc[u], sq_sum16(raw[u], T()));
    }
    for (; i < nvec; i += nthreads) acc[0] = __fadd_rn(acc[0], sq_sum16(__ldg(src + i), T()));
    done = nvec * PER;
  }
  for (int64_t i = done + tid; i < numel; i += nthreads) {
    const float x = to_f32(g[i]);
    acc[0] = __fmaf_rn(x, x, acc[0]);
  }
  float a = 0.f;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) a = __fadd_rn(a, acc[u]);
  a = block_sum<THREADS>(a);
  if (threadIdx.x == 0) partials[blockIdx.x] = a;
}

__global__ void __launch_bounds__(FINISH_THREADS) finish_kernel(const float* __restrict__ partials, int64_t n_parts,
                                                                float max_norm, float* __restrict__ out) {
  float a = 0.f;
  for (int64_t i = threadIdx.x; i < n_parts; i += FINISH_THREADS) a = __fadd_rn(a, partials[i]);
  a = block_sum<FINISH_THREADS>(a);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn(a);
    const float s = __fmul_rn(__frcp_rn(__fadd_rn(norm, 1e-9f)), max_norm);
    out[0] = norm;
    out[1] = s > 1.f ? 1.f : s;  // NaN stays NaN
  }
}

int64_t parts_for(int64_t numel) {
  const int64_t parts = (numel + PART_ELEMS - 1) / PART_ELEMS;
  return parts < MAX_PARTS ? parts : MAX_PARTS;
}

template <typename T>
int sumsq(const void* g, int64_t numel, int vec, float* partials, cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>(parts_for(numel));
  if (vec)
    sumsq_kernel<T, true><<<grid, THREADS, 0, st>>>(static_cast<const T*>(g), numel, partials);
  else
    sumsq_kernel<T, false><<<grid, THREADS, 0, st>>>(static_cast<const T*>(g), numel, partials);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// The number of partial sums repro_grad_sumsq writes for a leaf of numel
// elements (0 for an empty one).
int64_t repro_grad_sumsq_parts(int64_t numel) { return numel > 0 ? parts_for(numel) : 0; }

// The sums of squares of one contiguous leaf (f32: bf16 = 0; bf16: 1),
// one a thread block, into partials[0 .. repro_grad_sumsq_parts(numel)).
// vec = 1 only where g is 16-byte aligned. Returns cudaGetLastError()
// after the launch (0 on success).
int repro_grad_sumsq(const void* g, int64_t numel, int bf16, int vec, void* partials, void* stream) {
  if (numel <= 0) return int(cudaErrorInvalidValue);
  float* out = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? sumsq<__nv_bfloat16>(g, numel, vec, out, st) : sumsq<float>(g, numel, vec, out, st);
}

// out[0] = the norm of all n_parts partials' sum, out[1] = the clip scale.
int repro_grad_norm_finish(const void* partials, int64_t n_parts, float max_norm, void* out, void* stream) {
  if (n_parts < 0) return int(cudaErrorInvalidValue);
  finish_kernel<<<1, FINISH_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), n_parts, max_norm, static_cast<float*>(out));
  return int(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
