// Mamba-2 SSD chunk scan for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// (_ssd_kernel, l.33; ssd_scan, l.98) and computes what it and
// repro.kernels.ref.ssd compute: for each (batch, head), over chunks of Q
// positions in order, with an (N, P) f32 state carried across chunks,
//
//     ca      = cumsum(dt * A)                         (within the chunk)
//     y_i     = sum_{j <= i} (C_i . B_j) e^{ca_i - ca_j} xdt_j
//               + e^{ca_i} C_i . state
//     state'  = e^{ca_last} state + sum_j B_j^T (xdt_j e^{ca_last - ca_j})
//
// where xdt = x * dt is rounded to x's dtype (ssd_scan.py:117) and
// dA = dt * A is f32. All arithmetic is f32; y is stored in x's dtype and
// the final state in f32.
//
// Layout. x and y are (B, S, H, P), dt is (B, S, H), B and C are
// (B, S, G, N) in memory (the model's layout); the caller passes element
// strides for every axis but the last, whose stride must be 1. Head h
// reads group h / (H / G) (jnp.repeat's order): the groups are never
// copied per head. The states are (B, H, N, P) with (N, P) contiguous.
//
// Design. The TPU carries the state in VMEM across a sequential chunk
// axis of its grid. Here one block owns one (batch, head) and walks its
// chunks itself, the state in shared memory. The TPU kernel holds a
// (Q, Q) f32 score tile (256 KB at Q = 256), more than a block's 227 KB,
// so the intra-chunk product is tiled: 64-row tiles of the chunk against
// the 64-column tiles at or below the diagonal (tiles above it are never
// visited), each score masked before its exp (above the diagonal
// ca_i - ca_j > 0 could overflow, and inf * 0 is NaN). S need not divide
// Q: the last chunk is shorter, positions past S are neither read nor
// stored, and the final state is the state after exactly S tokens (the
// model's padding with dt = 0 gives the same: decay 1, contribution 0).
//
// Bound. At the serving shape (B 4, H 80, S 2000, P 64, N 128, Q 256,
// bf16) the function moves ~0.19 GB and does ~52 GFLOP: on the tensor
// cores' bf16 rate it is bound by bytes (~0.057 ms). This first version
// runs every product as f32 FMAs on the CUDA cores (256 threads, each
// holding a 4 x 4 block of scores, a 4 x P/16 block of y and N/16 x P/16
// state entries), so it is bound by the CUDA cores' f32 rate instead,
// 67 TFLOP/s, and keeps the TPU kernel's f32 (C B^T o L) xdt operand.
// One block per (batch, head): 320 blocks at the serving shape, 80 for a
// single sequence (fewer than the 132 SMs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 16 row groups x 16 column groups
constexpr int TR = 64;        // positions per tile
constexpr int MAX_Q = 256;    // longest chunk
constexpr int MAX_N = 128;    // largest state dim
constexpr int TP = TR + 1;    // padded row stride of the score tile

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// v rounded to T and back: x * dt in x's dtype
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Strides3 {
  int64_t b, s, h;  // batch, sequence, head (or group); the last axis has stride 1
};

struct Layout {
  int B, H, G, S, N, Q;
  Strides3 x, dt, bm, cm, y;
  int64_t st0_b, st0_h, sto_b, sto_h;  // states: (N, P) contiguous
};

size_t smem_bytes(int N, int P) {
  return sizeof(float) * (size_t(N) * P + 2 * size_t(TR) * (N + 1) + size_t(TR) * P +
                          size_t(TR) * TP + 2 * size_t(MAX_Q));
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ bm,
                    const T* __restrict__ cm, const float* __restrict__ st0, T* __restrict__ y,
                    float* __restrict__ st_out, Layout L) {
  constexpr int PC = P / 16;  // y / state columns per thread
  const int N = L.N;
  const int NP = N + 1;  // padded row stride of the B and C tiles
  const int NK = N / 16;  // state rows per thread
  extern __shared__ float smem[];
  float* state = smem;           // N x P
  float* cs = state + N * P;     // TR x NP: C rows of the row tile
  float* bs = cs + TR * NP;      // TR x NP: B rows of the column tile
  float* xs = bs + TR * NP;      // TR x P: xdt rows of the column tile
  float* ss = xs + TR * P;       // TR x TP: masked, decayed scores
  float* ca = ss + TR * TP;      // MAX_Q: cumulative dA of the chunk
  float* dts = ca + MAX_Q;       // MAX_Q: dt of the chunk

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows ty + 16a, columns tx + 16c
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (L.H / L.G);
  const T* xb = x + b * L.x.b + h * L.x.h;
  const float* dtb = dt + b * L.dt.b + h * L.dt.h;
  const T* bb = bm + b * L.bm.b + g * L.bm.h;
  const T* cb = cm + b * L.cm.b + g * L.cm.h;
  T* yb = y + b * L.y.b + h * L.y.h;
  const float a_h = A[h];

  for (int idx = tid; idx < N * P; idx += THREADS)
    state[idx] = st0 != nullptr ? st0[b * L.st0_b + h * L.st0_h + idx] : 0.f;

  // rows [r0, r0 + TR) of a (S, N) matrix (rows relative to the chunk at c0)
  // into a padded f32 tile; rows at or past len are zero
  auto load_rows = [&](float* tile, const T* src, int64_t row_stride, int c0, int r0, int len) {
    for (int idx = tid; idx < TR * N; idx += THREADS) {
      const int r = idx / N, n = idx % N;
      const int i = r0 + r;
      tile[r * NP + n] = i < len ? to_f32(src[(c0 + i) * row_stride + n]) : 0.f;
    }
  };
  // xdt rows [r0, r0 + TR) of the chunk, each times weight(i)
  auto load_xdt = [&](int c0, int r0, int len, float ca_last, bool decay_to_end) {
    for (int idx = tid; idx < TR * P; idx += THREADS) {
      const int r = idx / P, p = idx % P;
      const int i = r0 + r;
      float v = 0.f;
      if (i < len) {
        v = round_to(to_f32(xb[(c0 + i) * L.x.s + p]) * dts[i], xb);
        if (decay_to_end) v *= expf(ca_last - ca[i]);
      }
      xs[r * P + p] = v;
    }
  };

  for (int c0 = 0; c0 < L.S; c0 += L.Q) {
    const int len = min(L.Q, L.S - c0);
    __syncthreads();  // the previous chunk's state update is written
    if (tid < 32) {  // inclusive cumsum of dA: 8 positions a lane, then across lanes
      float v[MAX_Q / 32], run = 0.f;
#pragma unroll
      for (int k = 0; k < MAX_Q / 32; ++k) {
        const int i = tid * (MAX_Q / 32) + k;
        const float d = i < len ? dtb[(c0 + i) * L.dt.s] : 0.f;
        dts[i] = d;
        run += d * a_h;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += t;
      }
      const float before = incl - run;
#pragma unroll
      for (int k = 0; k < MAX_Q / 32; ++k) ca[tid * (MAX_Q / 32) + k] = before + v[k];
    }
    __syncthreads();
    const float ca_last = ca[len - 1];

    // ---- y, one 64-row tile of the chunk at a time
    for (int i0 = 0; i0 < len; i0 += TR) {
      __syncthreads();  // the previous tile's C rows are no longer read
      load_rows(cs, cb, L.cm.s, c0, i0, len);
      __syncthreads();

      float acc[4][PC];
      // the carried state's share: e^{ca_i} C_i . state
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[a][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[PC];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = cs[(ty + 16 * a) * NP + n];
#pragma unroll
        for (int c = 0; c < PC; ++c) sv[c] = state[n * P + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < PC; ++c) acc[a][c] = fmaf(cv[a], sv[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        const float e = i < len ? expf(ca[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[a][c] *= e;
      }

      // within the chunk: column tiles at or below the diagonal only
      for (int j0 = 0; j0 <= i0; j0 += TR) {
        __syncthreads();  // the previous column tile is no longer read
        load_rows(bs, bb, L.bm.s, c0, j0, len);
        load_xdt(c0, j0, len, ca_last, false);
        __syncthreads();

        float sc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) sc[a][k] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = cs[(ty + 16 * a) * NP + n];
#pragma unroll
          for (int k = 0; k < 4; ++k) bv[k] = bs[(tx + 16 * k) * NP + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int k = 0; k < 4; ++k) sc[a][k] = fmaf(cv[a], bv[k], sc[a][k]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = j0 + tx + 16 * k;
            // mask before exp: above the diagonal the exponent is positive
            const float w = (j <= i && i < len) ? sc[a][k] * expf(ca[i] - ca[j]) : 0.f;
            ss[(ty + 16 * a) * TP + tx + 16 * k] = w;
          }
        }
        __syncthreads();

#pragma unroll 4
        for (int jj = 0; jj < TR; ++jj) {
          float wv[4], xv[PC];
#pragma unroll
          for (int a = 0; a < 4; ++a) wv[a] = ss[(ty + 16 * a) * TP + jj];
#pragma unroll
          for (int c = 0; c < PC; ++c) xv[c] = xs[jj * P + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < PC; ++c) acc[a][c] = fmaf(wv[a], xv[c], acc[a][c]);
        }
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        if (i >= len) continue;
#pragma unroll
        for (int c = 0; c < PC; ++c) store(yb + (c0 + i) * L.y.s + tx + 16 * c, acc[a][c]);
      }
    }

    // ---- state' = e^{ca_last} state + sum_j B_j^T (xdt_j e^{ca_last - ca_j});
    // this thread owns rows ty + 16k, columns tx + 16c of the state
    __syncthreads();  // every row tile has read the state
    const float total = expf(ca_last);
    float su[MAX_N / 16][PC];
#pragma unroll
    for (int k = 0; k < MAX_N / 16; ++k)
#pragma unroll
      for (int c = 0; c < PC; ++c)
        su[k][c] = k < NK ? total * state[(ty + 16 * k) * P + tx + 16 * c] : 0.f;
    for (int j0 = 0; j0 < len; j0 += TR) {
      __syncthreads();  // the previous tile is no longer read
      load_rows(bs, bb, L.bm.s, c0, j0, len);
      load_xdt(c0, j0, len, ca_last, true);
      __syncthreads();
#pragma unroll 2
      for (int jj = 0; jj < TR; ++jj) {
        float xv[PC];
#pragma unroll
        for (int c = 0; c < PC; ++c) xv[c] = xs[jj * P + tx + 16 * c];
#pragma unroll
        for (int k = 0; k < MAX_N / 16; ++k) {
          if (k < NK) {
            const float bv = bs[jj * NP + ty + 16 * k];
#pragma unroll
            for (int c = 0; c < PC; ++c) su[k][c] = fmaf(bv, xv[c], su[k][c]);
          }
        }
      }
    }
    // own entries only: every read of the old state happened before the barrier above
#pragma unroll
    for (int k = 0; k < MAX_N / 16; ++k)
      if (k < NK)
#pragma unroll
        for (int c = 0; c < PC; ++c) state[(ty + 16 * k) * P + tx + 16 * c] = su[k][c];
  }

  __syncthreads();
  float* so = st_out + b * L.sto_b + h * L.sto_h;
  for (int idx = tid; idx < N * P; idx += THREADS) so[idx] = state[idx];
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* bm, const void* cm,
                   const void* st0, void* y, void* st_out, const Layout& L,
                   cudaStream_t stream) {
  auto kern = ssd_scan_kernel<T, P>;
  const size_t smem = smem_bytes(L.N, P);
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(L.H, L.B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(bm), static_cast<const T*>(cm), static_cast<const float*>(st0),
      static_cast<T*>(y), static_cast<float*>(st_out), L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int P, const void* x, const void* dt, const void* A, const void* bm,
                     const void* cm, const void* st0, void* y, void* st_out, const Layout& L,
                     cudaStream_t stream) {
  switch (P) {
    case 16: return launch<T, 16>(x, dt, A, bm, cm, st0, y, st_out, L, stream);
    case 32: return launch<T, 32>(x, dt, A, bm, cm, st0, y, st_out, L, stream);
    case 64: return launch<T, 64>(x, dt, A, bm, cm, st0, y, st_out, L, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt, A and the states
// are f32. st0 may be null (a zero initial state). P in {16, 32, 64},
// N a multiple of 16 up to 128, 1 <= Q <= 256. Returns cudaGetLastError()
// after the launch (0 on success).
int repro_ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* bm,
                       const void* cm, const void* st0, void* y, void* st_out, int dtype, int B,
                       int H, int G, int S, int P, int N, int Q, int64_t x_sb, int64_t x_ss,
                       int64_t x_sh, int64_t dt_sb, int64_t dt_ss, int64_t dt_sh, int64_t b_sb,
                       int64_t b_ss, int64_t b_sg, int64_t c_sb, int64_t c_ss, int64_t c_sg,
                       int64_t y_sb, int64_t y_ss, int64_t y_sh, int64_t st0_sb, int64_t st0_sh,
                       int64_t sto_sb, int64_t sto_sh, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || S <= 0 || H % G != 0 || N <= 0 || N % 16 != 0 ||
      N > MAX_N || Q <= 0 || Q > MAX_Q)
    return int(cudaErrorInvalidValue);
  const Layout L{B, H, G, S, N, Q,
                 {x_sb, x_ss, x_sh}, {dt_sb, dt_ss, dt_sh}, {b_sb, b_ss, b_sg},
                 {c_sb, c_ss, c_sg}, {y_sb, y_ss, y_sh},
                 st0_sb, st0_sh, sto_sb, sto_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(dispatch<float>(P, x, dt, A, bm, cm, st0, y, st_out, L, st));
  if (dtype == 1) return int(dispatch<bf16>(P, x, dt, A, bm, cm, st0, y, st_out, L, st));
  return int(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
