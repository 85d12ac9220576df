// The backward of the Mamba-2 SSD chunk scan (K2) for Hopper (sm_90a),
// written by hand.
//
// No TPU kernel stands behind it: the JAX package differentiates its plain
// chunked SSD (src/repro/models/ssm.py:123, ssd_chunked) with jax.grad.
// This is the adjoint of what csrc/ssd_scan.cu and repro.kernels.ref.ssd
// compute. Per (batch b, head h), a chunk of L positions, i >= j in it:
//
//     a_t   = dt_t A_h,  ca_i = sum_{t <= i} a_t (in the chunk),  tot = ca_{L-1}
//     u_j   = x_j dt_j, rounded to x's dtype (as the forward rounds it)
//     y_i   = sum_{j <= i} (C_i . B_j) e^{ca_i - ca_j} u_j + e^{ca_i} C_i S_prev
//     S_out = e^{tot} S_prev + sum_j e^{tot - ca_j} B_j u_j^T       (N x P, f32)
//
// Given dy and dS (the gradient of the chunk's S_out: d(final state), or
// zero, for the last chunk), right to left over the chunks:
//
//     dS_prev = e^{tot} dS + sum_i e^{ca_i} C_i dy_i^T   (d(initial state) at the first chunk)
//     du_j    = sum_{i >= j} score_ij dy_i + e^{tot - ca_j} dS^T B_j,  score_ij = (C_i . B_j) e^{ca_i - ca_j}
//     dC_i    = sum_{j <= i} e^{ca_i - ca_j} (dy_i . u_j) B_j + e^{ca_i} S_prev dy_i
//     dB_j    = sum_{i >= j} e^{ca_i - ca_j} (dy_i . u_j) C_i + e^{tot - ca_j} dS u_j
//     dca_i   = sum_{j < i} (dy_i . u_j) score_ij - sum_{i' > i} (dy_i' . u_i) score_i'i
//               + e^{ca_i} (C_i S_prev) . dy_i - e^{tot - ca_i} u_i . (dS^T B_i)
//     dtot    = sum_j e^{tot - ca_j} u_j . (dS^T B_j) + e^{tot} <S_prev, dS>   (added to dca_{L-1})
//     da_t    = sum_{i >= t} dca_i
//
// and to the inputs: dx_j = du_j dt_j and ddt_j = du_j . x_j + da_j A_h (u's
// rounding passes its gradient straight through, as JAX's astype does),
// dA_h = sum_{b, t} da_t dt_t; dB and dC of group g are the sums over the
// H / G heads that read it. Every pair above the diagonal is masked before
// its exp (ca_i - ca_j > 0 there and overflows).
//
// Layout: as the forward's. x, dy, dx are (B, S, H, P) in memory, dt and
// ddt (B, S, H) f32, B, C, dB, dC (B, S, G, N); the caller passes element
// strides for every axis but the last, whose stride must be 1. The states
// (initial, d(final), d(initial)) are (B, H, N, P) with (N, P) contiguous.
//
// Design: a simple kernel that is right first, every product as f32 FMAs
// on the CUDA cores (the inputs' bf16 is widened as it is read). The
// chunks' own work is independent; only an (N, P) recurrence runs across
// them. So one call runs five kernels, none with atomics, every sum in a
// fixed order (the same bits on every call):
//  1. chunk terms, grid (chunk, head, batch): the chunk's cumsum of dA, its
//     own state contribution D = sum_j e^{tot - ca_j} B_j u_j^T and its
//     backward one E = sum_i e^{ca_i} C_i dy_i^T, both f32 (N, P), and tot.
//  2. state passing, grid (N P / 256, head, batch), an (n, p) entry a
//     thread: left to right, S_prev = e^{tot} S_prev + D from the initial
//     state (the forward's recurrence: the f32 incoming states are
//     recomputed here rather than kept by the forward, which would hold
//     B H n_chunks N P f32 a layer, 2.7 GB over mamba2's 64 layers, through
//     the whole backward pass); then right to left, dS_prev = e^{tot} dS + E
//     from d(final state). Each chunk's incoming state overwrites its D and
//     the gradient of its outgoing state its E; the last dS_prev is
//     d(initial state).
//  3. gradients, grid (chunk, head, batch), 256 threads as 16 x 16 groups
//     over 64 x 64 tiles at or below the diagonal: a row pass (row tiles i,
//     column tiles j <= i) for dC and the row terms of dca, then a column
//     pass (column tiles j, row tiles i >= j) for du, dB and the column
//     terms (the score tiles are recomputed rather than kept); then dtot,
//     da by a reverse cumsum, dx, ddt, and the chunk's share of dA. dB and
//     dC go to f32 partials, one (S, N) slab a head.
//  4. the group sums, grid-stride over (B, S, G, N): each entry adds its
//     H / G heads' partials in head order and stores in the input's dtype.
//  5. dA: a thread a head adds its (batch, chunk) shares in order.
// Bound. At mamba2's training shape (B 4, S 1024, H 80, P 64, N 128, Q 256,
// bf16) the function moves ~0.13 GB and does ~70 GFLOP (per causal pair
// 6N + 4P, per chunk 10 L N P): on the tensor cores' bf16 rate it is bound
// by operations (~0.07 ms). This kernel runs them as f32 FMAs on the CUDA
// cores, one block an SM in kernel 3 (172 KB of shared memory at N 128,
// P 64), and each of its two passes recomputes the score tiles: ~136x
// its bound (PERF.md, section 6, has the time of each kernel). Its
// scratch: 2 B H n_chunks (N P + 1) + 2 B H S N f32 (the states, the
// decays and shares of dA, the per-head dB and dC), ~0.42 GB at the
// training shape.
// ptxas (sm_90a, CUDA 12.8), registers at P 64 / 32 / 16: gradients
// kernel 192 / 160 / 204 in bf16 (190 / 165 / 204 in f32), chunk terms
// 106 / 64 / 48; no spills but 16 bytes in the chunk terms at P 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;  // every kernel; the tiled ones as 16 x 16 thread groups
constexpr int TR = 64;        // positions a tile
constexpr int TP = TR + 1;    // padded row stride of a score tile
constexpr int MAX_Q = 256;    // longest chunk
constexpr int MAX_N = 128;    // largest state dim
constexpr int MAX_NK = MAX_N / 16;

using bf16 = __nv_bfloat16;

struct Strides3 {
  int64_t b, s, h;  // batch, sequence, head (or group); the last axis has stride 1
};

struct Layout {
  int B, H, G, S, N, Q, NC;
  Strides3 x, dt, bm, cm, dy, dx, ddt, dbm, dcm;
  int64_t st0_b, st0_h, dsf_b, dsf_h;  // states: (N, P) contiguous
};

// the f32 scratch, carved by the wrapper's allocation in this order
struct Scratch {
  float* fwd;  // B H NC N P: each chunk's D (kernel 1), then its incoming state (kernel 2)
  float* bwd;  // B H NC N P: each chunk's E (kernel 1), then d(its outgoing state) (kernel 2)
  float* tot;  // B H NC: each chunk's ca_{L-1}
  float* dap;  // B H NC: each chunk's share of dA
  float* dbp;  // B H S N: each head's dB
  float* dcp;  // B H S N: each head's dC
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16(v); }
// x * dt rounded to x's dtype, as the forward rounds it
__device__ __forceinline__ float rnd(float v, const float*) { return v; }
__device__ __forceinline__ float rnd(float v, const bf16*) { return __bfloat162float(__float2bfloat16(v)); }

// the sum over the 16 lanes of a thread group's row (tx = 0..15 of one ty),
// the same bits on every lane; every lane of the warp must call it
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

// the sum of every thread's v in a fixed tree; every thread gets it
__device__ float block_sum(float* red, float v) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();  // red is free again
  return total;
}

// warp 0: the inclusive cumsum of the f32 products dt * a_h over the
// chunk's len positions into ca, in f64 (8 positions a lane, then across
// lanes), and dt into dts; positions past len get dt 0. The caller
// synchronises. f64 because every decay is an exp of a difference of two
// cumsums: with mamba2's decays |ca| reaches thousands within a chunk,
// where an f32 ulp (2.4e-4 at 2900) is already the whole f32 tolerance of
// e^{ca_i - ca_j} for near pairs; each difference is rounded to f32 once.
__device__ void chunk_cumsum(const float* dtb, int64_t dt_s, int c0, int len, float a_h, double* ca,
                             float* dts) {
  const int tid = threadIdx.x;
  if (tid >= 32) return;
  double v[MAX_Q / 32], run = 0.0;
#pragma unroll
  for (int k = 0; k < MAX_Q / 32; ++k) {
    const int i = tid * (MAX_Q / 32) + k;
    const float d = i < len ? dtb[(c0 + i) * dt_s] : 0.f;
    dts[i] = d;
    run += double(d * a_h);
    v[k] = run;
  }
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double t = __shfl_up_sync(0xffffffffu, incl, o);
    if (tid >= o) incl += t;
  }
  const double before = incl - run;
#pragma unroll
  for (int k = 0; k < MAX_Q / 32; ++k) ca[tid * (MAX_Q / 32) + k] = before + v[k];
}

// rows [c0 + r0, c0 + r0 + TR) of an (S, N) matrix into a tile of row
// stride N + 1, in f32; rows at or past len are zero
template <typename T>
__device__ void load_rows(float* tile, const T* src, int64_t row_stride, int N, int c0, int r0, int len) {
  const int NP = N + 1;
  for (int idx = threadIdx.x; idx < TR * N; idx += THREADS) {
    const int r = idx / N, n = idx % N;
    const int i = r0 + r;
    tile[r * NP + n] = i < len ? ld(src + (c0 + i) * row_stride + n) : 0.f;
  }
}

// ------------------------------------------------------------ 1. chunk terms
size_t chunk_smem_bytes(int N, int P) {
  return sizeof(double) * MAX_Q + sizeof(float) * (2 * size_t(TR) * (N + 1) + 2 * size_t(TR) * P + MAX_Q);
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ A, const T* __restrict__ bm,
                         const T* __restrict__ cm, const T* __restrict__ dy, Scratch W, Layout L) {
  constexpr int PC = P / 16;
  const int N = L.N, NP = N + 1, NK = N / 16;
  extern __shared__ double smem_d[];
  double* ca = smem_d;                                  // MAX_Q
  float* bs = reinterpret_cast<float*>(ca + MAX_Q);     // TR x NP: B rows
  float* cs = bs + TR * NP;    // TR x NP: C rows
  float* us = cs + TR * NP;    // TR x P: u_j e^{tot - ca_j}
  float* ys = us + TR * P;     // TR x P: dy_i e^{ca_i}
  float* dts = ys + TR * P;    // MAX_Q

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (L.H / L.G);
  const int c0 = c * L.Q, len = min(L.Q, L.S - c0);
  const T* xb = x + b * L.x.b + h * L.x.h;
  const float* dtb = dt + b * L.dt.b + h * L.dt.h;
  const T* bb = bm + b * L.bm.b + g * L.bm.h;
  const T* cb = cm + b * L.cm.b + g * L.cm.h;
  const T* dyb = dy + b * L.dy.b + h * L.dy.h;

  chunk_cumsum(dtb, L.dt.s, c0, len, A[h], ca, dts);
  __syncthreads();
  const double tot = ca[len - 1];

  // this thread owns rows ty + 16k, columns tx + 16cc of D and E
  float D[MAX_NK][PC], E[MAX_NK][PC];
#pragma unroll
  for (int k = 0; k < MAX_NK; ++k)
#pragma unroll
    for (int cc = 0; cc < PC; ++cc) D[k][cc] = E[k][cc] = 0.f;
  for (int r0 = 0; r0 < len; r0 += TR) {
    __syncthreads();  // the previous tile is no longer read
    load_rows(bs, bb, L.bm.s, N, c0, r0, len);
    load_rows(cs, cb, L.cm.s, N, c0, r0, len);
    for (int idx = tid; idx < TR * P; idx += THREADS) {
      const int r = idx / P, p = idx % P;
      const int i = r0 + r;
      float u = 0.f, w = 0.f;
      if (i < len) {
        u = rnd(ld(xb + (c0 + i) * L.x.s + p) * dts[i], xb) * expf(float(tot - ca[i]));
        w = ld(dyb + (c0 + i) * L.dy.s + p) * expf(float(ca[i]));
      }
      us[r * P + p] = u;
      ys[r * P + p] = w;
    }
    __syncthreads();
#pragma unroll 2
    for (int jj = 0; jj < TR; ++jj) {
      float uv[PC], yv[PC];
#pragma unroll
      for (int cc = 0; cc < PC; ++cc) {
        uv[cc] = us[jj * P + tx + 16 * cc];
        yv[cc] = ys[jj * P + tx + 16 * cc];
      }
#pragma unroll
      for (int k = 0; k < MAX_NK; ++k) {
        if (k < NK) {
          const float bv = bs[jj * NP + ty + 16 * k], cv = cs[jj * NP + ty + 16 * k];
#pragma unroll
          for (int cc = 0; cc < PC; ++cc) {
            D[k][cc] = fmaf(bv, uv[cc], D[k][cc]);
            E[k][cc] = fmaf(cv, yv[cc], E[k][cc]);
          }
        }
      }
    }
  }
  const int64_t bh = int64_t(b) * L.H + h;
  const int64_t slot = (bh * L.NC + c) * N * P;
#pragma unroll
  for (int k = 0; k < MAX_NK; ++k)
    if (k < NK)
#pragma unroll
      for (int cc = 0; cc < PC; ++cc) {
        const int64_t at = slot + (ty + 16 * k) * P + tx + 16 * cc;
        W.fwd[at] = D[k][cc];
        W.bwd[at] = E[k][cc];
      }
  if (tid == 0) W.tot[bh * L.NC + c] = float(tot);
}

// ------------------------------------------------------------ 2. state passing
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_states_kernel(const float* __restrict__ st0, const float* __restrict__ dsf,
                          float* __restrict__ dst0, Scratch W, Layout L, int NPP) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (idx >= NPP) return;
  const int64_t bh = int64_t(b) * L.H + h;
  float* fw = W.fwd + bh * L.NC * NPP + idx;
  float* bw = W.bwd + bh * L.NC * NPP + idx;
  const float* tot = W.tot + bh * L.NC;
  float s = st0 != nullptr ? st0[b * L.st0_b + h * L.st0_h + idx] : 0.f;
  for (int c = 0; c < L.NC; ++c) {  // the forward's recurrence: D_c becomes S_prev,c
    const float d = fw[int64_t(c) * NPP];
    fw[int64_t(c) * NPP] = s;
    s = fmaf(expf(tot[c]), s, d);
  }
  float ds = dsf != nullptr ? dsf[b * L.dsf_b + h * L.dsf_h + idx] : 0.f;
  for (int c = L.NC - 1; c >= 0; --c) {  // its adjoint: E_c becomes dS_c
    const float e = bw[int64_t(c) * NPP];
    bw[int64_t(c) * NPP] = ds;
    ds = fmaf(expf(tot[c]), ds, e);
  }
  if (dst0 != nullptr) dst0[bh * NPP + idx] = ds;
}

// ------------------------------------------------------------ 3. gradients
size_t grads_smem_bytes(int N, int P) {
  return sizeof(double) * MAX_Q + sizeof(float) * (size_t(N) * (P + 1) + 2 * size_t(TR) * (N + 1) +
                                                   2 * size_t(TR) * (P + 1) + 2 * size_t(TR) * TP +
                                                   4 * size_t(MAX_Q) + THREADS);
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_grads_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ A, const T* __restrict__ bm,
                         const T* __restrict__ cm, const T* __restrict__ dy, T* __restrict__ dx,
                         float* __restrict__ ddt, Scratch W, Layout L) {
  constexpr int PC = P / 16;
  constexpr int PU = P + 1;  // padded row stride of the (N, P) state and the (TR, P) tiles
  const int N = L.N, NP = N + 1, NK = N / 16;
  extern __shared__ double smem_d[];
  double* ca = smem_d;          // MAX_Q
  float* ms = reinterpret_cast<float*>(ca + MAX_Q);  // N x PU: S_prev (row pass), then dS (column pass)
  float* cs = ms + N * PU;      // TR x NP: C rows
  float* bs = cs + TR * NP;     // TR x NP: B rows
  float* ys = bs + TR * NP;     // TR x PU: dy rows
  float* us = ys + TR * PU;     // TR x PU: u rows
  float* ss = us + TR * PU;     // TR x TP: scores
  float* gs = ss + TR * TP;     // TR x TP: e^{ca_i - ca_j} (dy_i . u_j)
  float* dts = gs + TR * TP;    // MAX_Q
  float* dca = dts + MAX_Q;     // MAX_Q: d ca
  float* dux = dca + MAX_Q;     // MAX_Q: du_j . x_j
  float* wst = dux + MAX_Q;     // MAX_Q: e^{tot - ca_j} u_j . (dS^T B_j)
  float* red = wst + MAX_Q;     // THREADS

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (L.H / L.G);
  const int c0 = c * L.Q, len = min(L.Q, L.S - c0);
  const T* xb = x + b * L.x.b + h * L.x.h;
  const float* dtb = dt + b * L.dt.b + h * L.dt.h;
  const T* bb = bm + b * L.bm.b + g * L.bm.h;
  const T* cb = cm + b * L.cm.b + g * L.cm.h;
  const T* dyb = dy + b * L.dy.b + h * L.dy.h;
  T* dxb = dx + b * L.dx.b + h * L.dx.h;
  float* ddtb = ddt + b * L.ddt.b + h * L.ddt.h;
  const int64_t bh = int64_t(b) * L.H + h;
  const int64_t slot = (bh * L.NC + c) * N * P;
  float* dbp = W.dbp + bh * L.S * N;
  float* dcp = W.dcp + bh * L.S * N;
  const float a_h = A[h];

  chunk_cumsum(dtb, L.dt.s, c0, len, a_h, ca, dts);
  for (int i = tid; i < MAX_Q; i += THREADS) dca[i] = dux[i] = wst[i] = 0.f;
  // the incoming state, and <S_prev, dS> (a fixed order: the block's tree)
  float part = 0.f;
  for (int idx = tid; idx < N * P; idx += THREADS) {
    const float sv = W.fwd[slot + idx];
    ms[(idx / P) * PU + idx % P] = sv;
    part = fmaf(sv, W.bwd[slot + idx], part);
  }
  const float sdot = block_sum(red, part);  // its barriers publish ca, dts and ms too
  const double tot = ca[len - 1];

  // ---- row pass: dC_i and the row terms of dca_i; thread rows ty + 16a
  for (int i0 = 0; i0 < len; i0 += TR) {
    __syncthreads();  // the previous row tile is no longer read
    load_rows(cs, cb, L.cm.s, N, c0, i0, len);
    for (int idx = tid; idx < TR * P; idx += THREADS) {
      const int r = idx / P, p = idx % P;
      const int i = i0 + r;
      ys[r * PU + p] = i < len ? ld(dyb + (c0 + i) * L.dy.s + p) : 0.f;
    }
    float acc[4][MAX_NK], rowd[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      rowd[a] = 0.f;
#pragma unroll
      for (int m = 0; m < MAX_NK; ++m) acc[a][m] = 0.f;
    }
    for (int j0 = 0; j0 <= i0; j0 += TR) {
      __syncthreads();  // the previous column tile is no longer read
      load_rows(bs, bb, L.bm.s, N, c0, j0, len);
      for (int idx = tid; idx < TR * P; idx += THREADS) {
        const int r = idx / P, p = idx % P;
        const int j = j0 + r;
        us[r * PU + p] = j < len ? rnd(ld(xb + (c0 + j) * L.x.s + p) * dts[j], xb) : 0.f;
      }
      __syncthreads();
      float sc[4][4], dsc[4][4];  // rows ty + 16a, columns tx + 16k
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) sc[a][k] = dsc[a][k] = 0.f;
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
#pragma unroll 4
      for (int p = 0; p < P; ++p) {
        float yv[4], uv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) yv[a] = ys[(ty + 16 * a) * PU + p];
#pragma unroll
        for (int k = 0; k < 4; ++k) uv[k] = us[(tx + 16 * k) * PU + p];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) dsc[a][k] = fmaf(yv[a], uv[k], dsc[a][k]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = j0 + tx + 16 * k;
          // mask before exp: above the diagonal the exponent is positive
          const float e = (j <= i && i < len) ? expf(float(ca[i] - ca[j])) : 0.f;
          const float gd = dsc[a][k] * e;
          if (j < i) rowd[a] = fmaf(gd, sc[a][k], rowd[a]);  // a diagonal pair's two terms cancel
          gs[(ty + 16 * a) * TP + tx + 16 * k] = gd;
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int jj = 0; jj < TR; ++jj) {
        float gv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) gv[a] = gs[(ty + 16 * a) * TP + jj];
#pragma unroll
        for (int m = 0; m < MAX_NK; ++m) {
          if (m < NK) {
            const float bv = bs[jj * NP + tx + 16 * m];
#pragma unroll
            for (int a = 0; a < 4; ++a) acc[a][m] = fmaf(gv[a], bv, acc[a][m]);
          }
        }
      }
    }
    // the carried state's share: dC_i += e^{ca_i} S_prev dy_i, and
    // e^{ca_i} (C_i S_prev) . dy_i = C_i . that into dca_i
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
      const float ei = i < len ? expf(float(ca[i])) : 0.f;
#pragma unroll
      for (int m = 0; m < MAX_NK; ++m) {
        if (m < NK) {
          const int n = tx + 16 * m;
          float v = 0.f;
#pragma unroll 8
          for (int p = 0; p < P; ++p) v = fmaf(ys[(ty + 16 * a) * PU + p], ms[n * PU + p], v);
          v *= ei;
          rowd[a] = fmaf(cs[(ty + 16 * a) * NP + n], v, rowd[a]);
          acc[a][m] += v;
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
      const float r = row_sum(rowd[a]);
      if (i < len) {
        if (tx == 0) dca[i] += r;
#pragma unroll
        for (int m = 0; m < MAX_NK; ++m)
          if (m < NK) dcp[(c0 + i) * int64_t(N) + tx + 16 * m] = acc[a][m];
      }
    }
  }

  // ---- column pass: du_j, dB_j and the column terms of dca_j; thread rows
  // are the columns j = j0 + ty + 16a
  __syncthreads();  // every row tile has read S_prev
  for (int idx = tid; idx < N * P; idx += THREADS) ms[(idx / P) * PU + idx % P] = W.bwd[slot + idx];
  for (int j0 = 0; j0 < len; j0 += TR) {
    __syncthreads();  // the previous tiles are no longer read; ms is written
    load_rows(bs, bb, L.bm.s, N, c0, j0, len);
    for (int idx = tid; idx < TR * P; idx += THREADS) {
      const int r = idx / P, p = idx % P;
      const int j = j0 + r;
      us[r * PU + p] = j < len ? rnd(ld(xb + (c0 + j) * L.x.s + p) * dts[j], xb) : 0.f;
    }
    __syncthreads();
    float du[4][PC], db[4][MAX_NK], cold[4];
    // dS's share: du_j = e^{tot - ca_j} dS^T B_j, dB_j = e^{tot - ca_j} dS u_j,
    // and -u_j . du_j into dca_j (its sum goes to dtot)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = j0 + ty + 16 * a;
      const float w = j < len ? expf(float(tot - ca[j])) : 0.f;
#pragma unroll
      for (int cc = 0; cc < PC; ++cc) {
        float v = 0.f;
        for (int n = 0; n < N; ++n) v = fmaf(bs[(ty + 16 * a) * NP + n], ms[n * PU + tx + 16 * cc], v);
        du[a][cc] = v * w;
      }
#pragma unroll
      for (int m = 0; m < MAX_NK; ++m) {
        float v = 0.f;
        if (m < NK) {
#pragma unroll 8
          for (int p = 0; p < P; ++p) v = fmaf(us[(ty + 16 * a) * PU + p], ms[(tx + 16 * m) * PU + p], v);
        }
        db[a][m] = v * w;
      }
      float sd = 0.f;
#pragma unroll
      for (int cc = 0; cc < PC; ++cc) sd = fmaf(us[(ty + 16 * a) * PU + tx + 16 * cc], du[a][cc], sd);
      sd = row_sum(sd);
      cold[a] = tx == 0 ? -sd : 0.f;  // the whole term on one lane: cold is summed over the lanes below
      if (tx == 0 && j < len) wst[j] = sd;
    }
    for (int i0 = j0; i0 < len; i0 += TR) {
      __syncthreads();  // the previous row tile and score tiles are no longer read
      load_rows(cs, cb, L.cm.s, N, c0, i0, len);
      for (int idx = tid; idx < TR * P; idx += THREADS) {
        const int r = idx / P, p = idx % P;
        const int i = i0 + r;
        ys[r * PU + p] = i < len ? ld(dyb + (c0 + i) * L.dy.s + p) : 0.f;
      }
      __syncthreads();
      float sc[4][4], dsc[4][4];  // rows j: ty + 16a, columns i: tx + 16k
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) sc[a][k] = dsc[a][k] = 0.f;
      for (int n = 0; n < N; ++n) {
        float bv[4], cv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) bv[a] = bs[(ty + 16 * a) * NP + n];
#pragma unroll
        for (int k = 0; k < 4; ++k) cv[k] = cs[(tx + 16 * k) * NP + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) sc[a][k] = fmaf(bv[a], cv[k], sc[a][k]);
      }
#pragma unroll 4
      for (int p = 0; p < P; ++p) {
        float uv[4], yv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) uv[a] = us[(ty + 16 * a) * PU + p];
#pragma unroll
        for (int k = 0; k < 4; ++k) yv[k] = ys[(tx + 16 * k) * PU + p];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) dsc[a][k] = fmaf(uv[a], yv[k], dsc[a][k]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = j0 + ty + 16 * a;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = i0 + tx + 16 * k;
          const float e = (j <= i && i < len) ? expf(float(ca[i] - ca[j])) : 0.f;
          const float gd = dsc[a][k] * e;
          if (j < i) cold[a] = fmaf(-gd, sc[a][k], cold[a]);
          ss[(ty + 16 * a) * TP + tx + 16 * k] = sc[a][k] * e;
          gs[(ty + 16 * a) * TP + tx + 16 * k] = gd;
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int ii = 0; ii < TR; ++ii) {
        float sv[4], gv[4], yv[PC];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          sv[a] = ss[(ty + 16 * a) * TP + ii];
          gv[a] = gs[(ty + 16 * a) * TP + ii];
        }
#pragma unroll
        for (int cc = 0; cc < PC; ++cc) yv[cc] = ys[ii * PU + tx + 16 * cc];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int cc = 0; cc < PC; ++cc) du[a][cc] = fmaf(sv[a], yv[cc], du[a][cc]);
#pragma unroll
        for (int m = 0; m < MAX_NK; ++m) {
          if (m < NK) {
            const float cv = cs[ii * NP + tx + 16 * m];
#pragma unroll
            for (int a = 0; a < 4; ++a) db[a][m] = fmaf(gv[a], cv, db[a][m]);
          }
        }
      }
    }
    // dx_j = du_j dt_j, du_j . x_j (ddt's x route), dB_j's partial, dca_j
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = j0 + ty + 16 * a;
      float xd = 0.f;
      if (j < len) {
#pragma unroll
        for (int cc = 0; cc < PC; ++cc) {
          const int p = tx + 16 * cc;
          xd = fmaf(du[a][cc], ld(xb + (c0 + j) * L.x.s + p), xd);
          st(dxb + (c0 + j) * L.dx.s + p, du[a][cc] * dts[j]);
        }
      }
      xd = row_sum(xd);
      const float cd = row_sum(cold[a]);
      if (j < len) {
        if (tx == 0) {
          dux[j] = xd;
          dca[j] += cd;
        }
#pragma unroll
        for (int m = 0; m < MAX_NK; ++m)
          if (m < NK) dbp[(c0 + j) * int64_t(N) + tx + 16 * m] = db[a][m];
      }
    }
  }
  __syncthreads();

  // dtot: the state update's terms in position order, then the carried state's
  if (tid < 32) {
    float v = 0.f;
    for (int i = tid; i < len; i += 32) v += wst[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (tid == 0) dca[len - 1] += v + expf(float(tot)) * sdot;
  }
  __syncthreads();
  // da_t = sum_{i >= t} dca_i; ddt; this chunk's share of dA
  float pa = 0.f;
  for (int t = tid; t < len; t += THREADS) {
    float da = 0.f;
    for (int i = len - 1; i >= t; --i) da += dca[i];
    ddtb[(c0 + t) * L.ddt.s] = fmaf(da, a_h, dux[t]);
    pa = fmaf(da, dts[t], pa);
  }
  const float dA_c = block_sum(red, pa);
  if (tid == 0) W.dap[bh * L.NC + c] = dA_c;
}

// ------------------------------------------------------------ 4, 5. the sums
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_group_sum_kernel(Scratch W, T* __restrict__ dbm, T* __restrict__ dcm, Layout L) {
  const float* part = blockIdx.y == 0 ? W.dbp : W.dcp;
  T* out = blockIdx.y == 0 ? dbm : dcm;
  const Strides3 os = blockIdx.y == 0 ? L.dbm : L.dcm;
  const int rep = L.H / L.G;
  const int64_t total = int64_t(L.B) * L.S * L.G * L.N;
  for (int64_t e = blockIdx.x * int64_t(THREADS) + threadIdx.x; e < total; e += int64_t(gridDim.x) * THREADS) {
    const int n = int(e % L.N);
    int64_t r = e / L.N;
    const int g = int(r % L.G);
    r /= L.G;
    const int s = int(r % L.S);
    const int b = int(r / L.S);
    float v = 0.f;
    for (int k = 0; k < rep; ++k) v += part[((int64_t(b) * L.H + g * rep + k) * L.S + s) * L.N + n];
    st(out + b * os.b + s * os.s + g * os.h + n, v);
  }
}

__global__ void __launch_bounds__(THREADS) ssd_bwd_da_kernel(Scratch W, float* __restrict__ dA, Layout L) {
  const int h = blockIdx.x * THREADS + threadIdx.x;
  if (h >= L.H) return;
  float v = 0.f;
  for (int b = 0; b < L.B; ++b)
    for (int c = 0; c < L.NC; ++c) v += W.dap[(int64_t(b) * L.H + h) * L.NC + c];
  dA[h] = v;
}

// The dynamic shared-memory limit is an attribute of the current card's
// context: raise it once for each card a kernel is launched on (the call
// costs host time at every launch otherwise, and a CUDA graph's capture
// takes no such call).
cudaError_t size_smem_once(const void* kern, int bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;  // past 64 cards: set at every call
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* bm, const void* cm,
                   const void* st0, const void* dy, const void* dsf, void* dx, void* ddt, void* dA,
                   void* dbm, void* dcm, void* dst0, const Scratch& W, const Layout& L,
                   cudaStream_t stream) {
  auto chunk = ssd_bwd_chunk_kernel<T, P>;
  auto grads = ssd_bwd_grads_kernel<T, P>;
  const size_t chunk_smem = chunk_smem_bytes(L.N, P), grads_smem = grads_smem_bytes(L.N, P);
  // cards whose shared-memory limit is raised (to the largest N's), per kernel
  static std::atomic<uint64_t> sized_chunk{0}, sized_grads{0};
  cudaError_t err = size_smem_once(reinterpret_cast<const void*>(chunk), int(chunk_smem_bytes(MAX_N, P)),
                                   sized_chunk);
  if (err != cudaSuccess) return err;
  err = size_smem_once(reinterpret_cast<const void*>(grads), int(grads_smem_bytes(MAX_N, P)), sized_grads);
  if (err != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bm);
  const T* ct = static_cast<const T*>(cm);
  const T* dyt = static_cast<const T*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const dim3 per_chunk(L.NC, L.H, L.B);
  chunk<<<per_chunk, THREADS, chunk_smem, stream>>>(xt, dtf, Af, bt, ct, dyt, W, L);
  const int npp = L.N * P;
  ssd_bwd_states_kernel<<<dim3((npp + THREADS - 1) / THREADS, L.H, L.B), THREADS, 0, stream>>>(
      static_cast<const float*>(st0), static_cast<const float*>(dsf), static_cast<float*>(dst0), W, L, npp);
  grads<<<per_chunk, THREADS, grads_smem, stream>>>(xt, dtf, Af, bt, ct, dyt, static_cast<T*>(dx),
                                                    static_cast<float*>(ddt), W, L);
  const int64_t total = int64_t(L.B) * L.S * L.G * L.N;
  const int64_t want = (total + THREADS - 1) / THREADS;
  const int blocks = int(want < 132 * 8 ? want : 132 * 8);  // grid-stride beyond 8 blocks an SM
  ssd_bwd_group_sum_kernel<T><<<dim3(blocks, 2), THREADS, 0, stream>>>(W, static_cast<T*>(dbm),
                                                                       static_cast<T*>(dcm), L);
  ssd_bwd_da_kernel<<<(L.H + THREADS - 1) / THREADS, THREADS, 0, stream>>>(W, static_cast<float*>(dA), L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_p(int P, const void* x, const void* dt, const void* A, const void* bm, const void* cm,
                     const void* st0, const void* dy, const void* dsf, void* dx, void* ddt, void* dA,
                     void* dbm, void* dcm, void* dst0, const Scratch& W, const Layout& L,
                     cudaStream_t stream) {
  switch (P) {
    case 16: return launch<T, 16>(x, dt, A, bm, cm, st0, dy, dsf, dx, ddt, dA, dbm, dcm, dst0, W, L, stream);
    case 32: return launch<T, 32>(x, dt, A, bm, cm, st0, dy, dsf, dx, ddt, dA, dbm, dcm, dst0, W, L, stream);
    default: return launch<T, 64>(x, dt, A, bm, cm, st0, dy, dsf, dx, ddt, dA, dbm, dcm, dst0, W, L, stream);
  }
}

}  // namespace

extern "C" {

// f32 elements of the scratch a call needs (Scratch's fields in order)
int64_t repro_ssd_scan_bwd_scratch(int B, int H, int S, int P, int N, int Q) {
  const int64_t nc = (S + Q - 1) / Q;
  return 2 * int64_t(B) * H * nc * (int64_t(N) * P + 1) + 2 * int64_t(B) * H * S * N;
}

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy and dx, dB, dC); dt, ddt,
// A, dA and the states are f32. st0 (the initial state), dsf (d(final
// state)) and dst0 (d(initial state)) may be null. P in {16, 32, 64}, N a
// multiple of 16 up to 128, 1 <= Q <= 256. `strides` holds 31 int64: the
// (batch, sequence, head or group) element strides of x, dt, B, C, dy, dx,
// ddt, dB, dC, then the (batch, head) strides of st0 and of dsf. `work`
// holds repro_ssd_scan_bwd_scratch(...) f32. Returns cudaGetLastError()
// after the launches (0 on success).
int repro_ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* bm, const void* cm,
                       const void* st0, const void* dy, const void* dsf, void* dx, void* ddt, void* dA,
                       void* dbm, void* dcm, void* dst0, int dtype, int B, int H, int G, int S, int P,
                       int N, int Q, const int64_t* strides, void* work, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || S <= 0 || H % G != 0 || N <= 0 || N % 16 != 0 || N > MAX_N ||
      Q <= 0 || Q > MAX_Q || (P != 16 && P != 32 && P != 64) || work == nullptr || strides == nullptr ||
      (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  const int nc = (S + Q - 1) / Q;
  const int64_t* s = strides;
  const Layout L{B, H, G, S, N, Q, nc,
                 {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]}, {s[9], s[10], s[11]},
                 {s[12], s[13], s[14]}, {s[15], s[16], s[17]}, {s[18], s[19], s[20]},
                 {s[21], s[22], s[23]}, {s[24], s[25], s[26]},
                 s[27], s[28], s[29], s[30]};
  float* w = static_cast<float*>(work);
  const int64_t states = int64_t(B) * H * nc * N * P, chunks = int64_t(B) * H * nc, parts = int64_t(B) * H * S * N;
  const Scratch W{w, w + states, w + 2 * states, w + 2 * states + chunks, w + 2 * states + 2 * chunks,
                  w + 2 * states + 2 * chunks + parts};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return int(launch_p<bf16>(P, x, dt, A, bm, cm, st0, dy, dsf, dx, ddt, dA, dbm, dcm, dst0, W, L, st));
  return int(launch_p<float>(P, x, dt, A, bm, cm, st0, dy, dsf, dx, ddt, dA, dbm, dcm, dst0, W, L, st));
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
