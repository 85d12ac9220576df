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
// Bound. At mamba2's training shape (B 4, S 1024, H 80, P 64, N 128, Q 256,
// bf16) the function moves ~0.13 GB and does ~70 GFLOP (per causal pair
// 6N + 4P, per chunk 10 L N P): on the tensor cores' bf16 rate it is bound
// by operations (~0.07 ms). Every path below adds no atomics and sums in a
// fixed order: the same bits on every call.
//
// bf16 (the training path): redesigned for Hopper, every product on wgmma
// m64n64k16 with f32 accumulation (operand tiles in 128-byte-swizzled
// atoms, P padded to 64 and N to 128 in shared memory so that every k-loop
// is fixed at compile time, as in csrc/ssd_scan.cu). It replaces a first
// kernel of f32 FMAs on the CUDA cores (9.68 ms at the training shape,
// 0.73% of the bound; PERF.md, section 6, has both times). One call runs
// five kernels:
//  1. chunk terms, grid (chunk, head, batch), two warpgroups, the forward's
//     phase 1 twice: D = B^T (u o e^{tot - ca}) and E = C^T (dy o e^{ca}),
//     warpgroup m rows [64m, 64m + 64) of N, the chunk in 64-position
//     stages, both operands MN-major; the f64 cumsum, tot.
//  2. state passing, grid (N P / 1024, head, batch), four (n, p) entries a
//     thread, AHEAD chunks loaded together: left to right S_prev = e^{tot}
//     S_prev + D from the initial state, right to left dS_prev = e^{tot} dS
//     + E from d(final state), both f32 and never rounded (the incoming
//     states are recomputed rather than kept by the forward, which would
//     hold 2.7 GB over mamba2's 64 layers through the backward pass); each
//     chunk's S_prev and dS handed on in bf16, its <S_prev, dS> in partials
//     of a block; the last dS_prev is d(initial state).
//  3. gradients, grid (chunk x 64-position tile t, block of HEADS_PER_BLOCK
//     (40) heads of one group, batch), two warpgroups, each walking every other
//     head of the block. Row pass of tile t (rows i, column tiles j <= t):
//     Z = dy_i S_prev^T, then for each pair the score tile C_i B_j^T and dy_i
//     u_j^T (K-major from shared memory), masked and decayed in registers,
//     G = (dy u^T) o L as a bf16 register A operand of dC_i += G B_j (B_j
//     MN-major), the row terms of d ca from G o scores in f32. Column pass
//     (rows j of tile t, row tiles i >= t): du_j = e^{tot - ca_j} B_j dS, dB_j
//     += e^{tot - ca_j} u_j dS^T, then per pair B_j C_i^T and u_j dy_i^T,
//     du_j += ((C B^T) o L)^T dy_i and dB_j += G^T C_i (register A operands),
//     the column terms; dx, du . x. Row tile t has t + 1 pairs and column
//     tile t 4 - t: every block does 5 a head. dC and dB of the tile's rows
//     add over the block's heads in each warpgroup's f32 accumulators, then
//     warpgroup 1's into warpgroup 0's: one f32 partial a block of heads,
//     not one a head. The B and C tiles load once for the block's heads; a
//     head's tiles (and x, made u in shared memory) are all in flight at
//     once, warpgroup 1 a load behind warpgroup 0 (STAGGER).
//  4. finish, a block a head, a warp a (batch, chunk) in turn: d ca = the
//     row and column terms, d tot at the chunk's last position, da by a
//     reverse cumsum, ddt = du . x + da A, dA = sum da dt (the warps' shares
//     added in order).
//  5. the partials' sums: dB and dC of each (batch, position, group), the
//     group's blocks of heads added in order, stored in bf16.
// Roundings the bf16 path adds to the f32 adjoint (C . B^T and dy . u^T
// on bf16 inputs with f32 accumulation add none; u = x dt is rounded as
// the forward rounds it):
//  - D's decayed u and E's decayed dy, as bf16 hi + lo (lo the rounding
//    error of hi, SPLIT_DE): D and E feed the carried states;
//  - each chunk's S_prev and dS, to bf16, as operands of the state products
//    (Z into dC and d ca, B dS into du, u dS^T into dB); the f32 states and
//    <S_prev, dS> are not rounded;
//  - the decayed scores (C B^T) o L and G = (dy u^T) o L, to bf16, as the A
//    operands of du, dC and dB; the row and column terms of d ca multiply
//    G and the scores in f32 (where ddt's precision lives); with FAST_DECAY
//    each decay is ex2.approx of the f64 difference rounded once to f32;
//  - dx, dB and dC stored in bf16 (dB and dC summed in f32 first).
// What bounds it: the gradients kernel, one block an SM (its shared memory)
// with two warpgroups, each a chain of wgmma, wait, the decays and masks in
// registers, wgmma, wait: the decays (an f64 difference, its conversion
// and an ex2 for each of 4096 pairs of a tile, in both passes) and the
// per-head loads sit between the products. Each pair's score tile is
// computed again in every head and both passes: sharing it across a
// group's heads needs either all their dy and u resident (64 KB a head)
// or a du accumulator for each of them (32 registers a head), and neither
// fits beside the B and C tiles (80 KB) and the dB and dC accumulators.
// Its scratch at the training shape: 139.5 MB (D and E 83.9 MB, the bf16
// states 41.9, the partials of dB and dC 8.4, the per-position terms 5.2),
// where the first kernel's was 0.42 GB (per-head dB and dC, 336 MB of it).
// ptxas (sm_90a, CUDA 12.8; P pads to 64, so every P builds the same
// code): chunk terms 128 registers (the TERMS_BLOCKS cap), 20 bytes of
// spill stores, 69,632 bytes of dynamic shared memory; state passing 106
// registers, no spills; gradients 255 registers, 16 bytes of spill stores,
// 203,776 bytes; finish 40, partial sums 32, no spills.
//
// f32 (the checks at 1e-3 and mamba2's f32-activation twin): the first
// kernel, unchanged, every product as f32 FMAs on the CUDA cores: 1. chunk
// terms (D and E), grid (chunk, head, batch); 2. state passing, an (n, p)
// entry a thread, each chunk's incoming state over its D and d(its
// outgoing state) over its E; 3. gradients, grid (chunk, head, batch), 256
// threads as 16 x 16 groups over 64 x 64 tiles at or below the diagonal, a
// row pass (dC, the row terms) and a column pass (du, dB, the column
// terms) each recomputing the score tiles, then d tot, da, dx, ddt and the
// chunk's share of dA, dB and dC to f32 partials of a head; 4. the group
// sums in head order; 5. dA. Its scratch: 2 B H n_chunks (N P + 1) + 2 B H
// S N f32. ptxas, registers at P 64 / 32 / 16: gradients 190 / 165 / 204,
// chunk terms 106 / 64 / 48, no spills.

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
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
// x * dt rounded to x's dtype, as the forward rounds it (f32: unrounded)
__device__ __forceinline__ float rnd(float v, const float*) { return v; }

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

// one warp (lane tid): the inclusive cumsum of the f32 products dt * a_h
// over the chunk's len positions into ca, in f64 (8 positions a lane, then
// across lanes), and dt into dts; positions past len get dt 0. The caller
// synchronises. f64 because every decay is an exp of a difference of two
// cumsums: with mamba2's decays |ca| reaches thousands within a chunk,
// where an f32 ulp (2.4e-4 at 2900) is already the whole f32 tolerance of
// e^{ca_i - ca_j} for near pairs; each difference is rounded to f32 once.
__device__ void chunk_cumsum(const float* dtb, int64_t dt_s, int c0, int len, float a_h, double* ca,
                             float* dts, int tid) {
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

  if (tid < 32) chunk_cumsum(dtb, L.dt.s, c0, len, A[h], ca, dts, tid);
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

  if (tid < 32) chunk_cumsum(dtb, L.dt.s, c0, len, a_h, ca, dts, tid);
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

// ================================================= bf16: the Hopper path
#include "ssd_wgmma.cuh"

// Refinements over the plain decomposition, each a named constant;
// scripts/torch_kernel_ab.py --kernel ssd_bwd --ablate builds the kernel
// with each set to its plain value (in brackets) and reports its time.
constexpr bool SPLIT_DE = true;      // precision: D's decayed u and E's decayed dy as bf16 hi + lo
                                     // (false: hi alone)
constexpr bool FAST_DECAY = true;    // gradients: ex2.approx for the pair decays (false: expf)
constexpr int HEADS_PER_BLOCK = 40;  // gradients: heads of one group a block walks, their dB and
                                     // dC summed in its accumulators (1: a block a head)
constexpr int AHEAD = 8;             // state passing: chunks whose D (E) are loaded together (1)
constexpr int TERMS_BLOCKS = 2;      // chunk terms: blocks an SM, which caps its registers (1: no cap)
constexpr bool STAGGER = true;       // gradients: warpgroup 1 starts a pass once warpgroup 0 has loaded
                                     // its first head, so that one loads while the other computes

constexpr float LOG2E = 1.4426950408889634f;
constexpr int TILES = MAX_Q / TR;  // 64-position tiles of the longest chunk
constexpr int KN = MAX_N / 16;     // k-steps over N (zero-padded to MAX_N)
constexpr int KT = TR / 16;        // k-steps over P (zero-padded to 64) or over a tile's positions
constexpr uint32_t TILE_N = 2 * TR * 128;     // 64 positions x N: two 128-byte atom columns
constexpr uint32_t TILE_P = TR * 128;         // 64 positions x P: one
constexpr uint32_t STATE_TILE = MAX_N * 128;  // (N, P) in bf16: one atom column of MAX_N rows
// a warpgroup's head in the gradients kernel: a state and five P tiles
constexpr uint32_t WG_BYTES = STATE_TILE + (TILES + 1) * TILE_P;
constexpr uint32_t VEC_BYTES = MAX_Q * (sizeof(double) + sizeof(float));  // ca and dt of a chunk
// +1024: the dynamic shared memory is aligned up to the atoms' 1024 bytes
constexpr size_t TERMS_SMEM = 1024 + 2 * TILE_N + 4 * TILE_P + VEC_BYTES;
constexpr size_t GRADS_SMEM = 1024 + (TILES + 1) * TILE_N + 2 * (WG_BYTES + VEC_BYTES);

// The scratch of a bf16 call, carved from the wrapper's allocation in this
// order (the bf16 states two to an f32 slot)
struct BScratch {
  float* D;     // B H NC N P: each chunk's D (chunk terms), then its incoming state (state passing)
  float* E;     // B H NC N P: each chunk's E
  bf16* st16;   // B H NC N P: each chunk's incoming state in bf16
  bf16* ds16;   // B H NC N P: the gradient of its outgoing state in bf16
  float* dbp;   // B (G nhb) S N: dB, summed over a block's heads
  float* dcp;   // B (G nhb) S N: dC, the same
  float* dcr;   // B H S: the row terms of d ca and the incoming state's
  float* dcc;   // B H S: the column terms of d ca and d(outgoing state)'s
  float* wst;   // B H S: e^{tot - ca_j} u_j . (dS^T B_j), for d tot
  float* dux;   // B H S: du_j . x_j
  float* tot;   // B H NC: each chunk's ca_{L-1}
  float* sdp;   // B H NC nsb: <S_prev, dS>, a partial for each state-passing block
  int nhb;      // blocks of heads a group
  int nsb;      // state-passing blocks a head
};

__device__ __forceinline__ uint64_t kdesc(const uint8_t* tile, int rows, int kk) {
  // K-major operand of 64 rows, k-step kk (16 columns), in atom columns of `rows` rows
  return sw128_desc(tile + (kk / 4) * rows * 128 + (kk % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mdesc(const uint8_t* tile, int rows, int kk, int a) {
  // MN-major operand: K along the rows (k-step kk: rows 16 kk on), M or N the 64 columns of atom column a
  return sw128_desc(tile + a * rows * 128 + kk * 2048, rows * 128, 1024);
}
__device__ __forceinline__ float2 ld_pair(const uint8_t* p) {  // two bf16 from shared memory
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float decay(float z) {  // e^z; -inf (a masked pair) gives 0
  return FAST_DECAY ? ex2(z * LOG2E) : expf(z);
}
__device__ __forceinline__ float quad_sum(float v) {  // over the 4 lanes of a row of an accumulator
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ void wg_sync(int wg) {  // the 128 threads of warpgroup wg
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}
// STAGGER: warpgroup 0 arrives once its first head is loaded, warpgroup 1 waits for it
__device__ __forceinline__ void stagger_arrive() { asm volatile("bar.arrive 3, 256;\n" ::: "memory"); }
__device__ __forceinline__ void stagger_wait() { asm volatile("bar.sync 3, 256;\n" ::: "memory"); }

// 64 positions from r0 of a bf16 (S, w) matrix (the chunk's rows at src)
// into a tile of swizzled atoms of 64 rows, VECS 16-byte vectors a row, by
// NT threads from thread lt; rows at or past len and columns past w zero
template <int VECS, int NT>
__device__ __forceinline__ void load_tile(uint8_t* tile, const bf16* src, int64_t row_stride, int r0, int len,
                                          int w, int lt) {
  for (int idx = lt; idx < TR * VECS; idx += NT) {
    const int r = idx / VECS, k = idx % VECS;
    const bool full = r0 + r < len && 8 * k < w;
    cp_async16(tile + sw_off(r, k, TR), full ? src + int64_t(r0 + r) * row_stride + 8 * k : src, full);
  }
}

// the x tile at `tile` (64 positions from r0, as load_tile copied it) made
// u = x * dt in place, rounded to bf16 as the forward rounds it, by the 128
// threads of a warpgroup; dts holds the chunk's dt (0 past its length)
__device__ __forceinline__ void make_u(uint8_t* tile, const float* dts, int r0, int lt) {
#pragma unroll
  for (int u = 0; u < TR * 8 / 128; ++u) {
    const int idx = lt + 128 * u, r = idx / 8, k = idx % 8;
    uint4* at = reinterpret_cast<uint4*>(tile + sw_off(r, k, TR));
    const uint4 v = *at;
    const float d = dts[r0 + r];
    const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&v);
    uint4 o;
    uint32_t* ov = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(xv[e]);
      ov[e] = pack_bf16(f.x * d, f.y * d);
    }
    *at = o;
  }
}

// an (N, P) bf16 state into a STATE_TILE, by the 128 threads of a warpgroup;
// rows past N and columns past P zero
__device__ __forceinline__ void load_state(uint8_t* tile, const bf16* st, int N, int P, int lt) {
  for (int idx = lt; idx < MAX_N * 8; idx += 128) {
    const int n = idx / 8, k = idx % 8;
    const bool full = n < N && 8 * k < P;
    cp_async16(tile + sw_off(n, k, MAX_N), full ? st + n * P + 8 * k : st, full);
  }
}

// ------------------------------------------------- bf16 1. chunk terms
// D = B^T (u o e^{tot - ca}) and E = C^T (dy o e^{ca}) of chunk blockIdx.x
// of head blockIdx.y, batch blockIdx.z, on wgmma as the forward's phase 1:
// warpgroup m takes rows [64m, 64m + 64) of both, the chunk walked in
// 64-position stages; the decayed operands as bf16 hi + lo (SPLIT_DE)
__global__ void __launch_bounds__(THREADS, TERMS_BLOCKS)
    ssd_bwd_terms_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                              const float* __restrict__ A, const bf16* __restrict__ bm,
                              const bf16* __restrict__ cm, const bf16* __restrict__ dy, BScratch W, Layout L,
                              int P) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* bs = align_1024(smem_raw);  // (positions, N): D's A operand, MN-major
  uint8_t* cs = bs + TILE_N;           // E's
  uint8_t* uh = cs + TILE_N;           // u e^{tot - ca}, hi and lo: D's B operand, MN-major
  uint8_t* ul = uh + TILE_P;
  uint8_t* yh = ul + TILE_P;           // dy e^{ca}, hi and lo: E's
  uint8_t* yl = yh + TILE_P;
  double* ca = reinterpret_cast<double*>(yl + TILE_P);
  float* dts = reinterpret_cast<float*>(ca + MAX_Q);

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * L.Q, len = min(L.Q, L.S - c0);
  const int g = h / (L.H / L.G);
  const int tid = threadIdx.x, m = tid / 128;
  const bf16* bb = bm + b * L.bm.b + g * L.bm.h + int64_t(c0) * L.bm.s;
  const bf16* cb = cm + b * L.cm.b + g * L.cm.h + int64_t(c0) * L.cm.s;
  const bf16* xb = x + b * L.x.b + h * L.x.h + int64_t(c0) * L.x.s;
  const bf16* dyb = dy + b * L.dy.b + h * L.dy.h + int64_t(c0) * L.dy.s;
  if (tid < 32) chunk_cumsum(dt + b * L.dt.b + h * L.dt.h + int64_t(c0) * L.dt.s, L.dt.s, 0, len, A[h], ca, dts, tid);
  __syncthreads();
  const double tot = ca[len - 1];
  const int64_t bh = int64_t(b) * L.H + h;
  if (tid == 0) W.tot[bh * L.NC + c] = float(tot);

  float dacc[32], eacc[32];  // the first k-step overwrites them
  for (int r0 = 0; r0 < len; r0 += TR) {
    if (r0 > 0) __syncthreads();  // the last stage's products are done
    load_tile<16, THREADS>(bs, bb, L.bm.s, r0, len, L.N, tid);
    load_tile<16, THREADS>(cs, cb, L.cm.s, r0, len, L.N, tid);
    constexpr int NV = TR * 8 / THREADS;
    uint4 xv[NV], yv[NV];
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int idx = tid + u * THREADS, r = idx / 8, k = idx % 8;
      xv[u] = yv[u] = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < len && 8 * k < P) {
        xv[u] = *reinterpret_cast<const uint4*>(xb + int64_t(r0 + r) * L.x.s + 8 * k);
        yv[u] = *reinterpret_cast<const uint4*>(dyb + int64_t(r0 + r) * L.dy.s + 8 * k);
      }
    }
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int idx = tid + u * THREADS, r = idx / 8, k = idx % 8, i = r0 + r;
      uint4 o[4] = {};  // u hi, u lo, dy hi, dy lo
      if (i < len && 8 * k < P) {
        const float d = dts[i], wu = expf(float(tot - ca[i])), wy = expf(float(ca[i]));
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv[u]);
        const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&yv[u]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fx = __bfloat1622float2(xp[e]), fy = __bfloat1622float2(yp[e]);
          const float u0 = __bfloat162float(__float2bfloat16_rn(fx.x * d)) * wu;
          const float u1 = __bfloat162float(__float2bfloat16_rn(fx.y * d)) * wu;
          const float y0 = fy.x * wy, y1 = fy.y * wy;
          const __nv_bfloat162 uhi = __floats2bfloat162_rn(u0, u1), yhi = __floats2bfloat162_rn(y0, y1);
          reinterpret_cast<uint32_t*>(&o[0])[e] = *reinterpret_cast<const uint32_t*>(&uhi);
          reinterpret_cast<uint32_t*>(&o[2])[e] = *reinterpret_cast<const uint32_t*>(&yhi);
          if (SPLIT_DE) {
            const float2 uf = __bfloat1622float2(uhi), yf = __bfloat1622float2(yhi);
            reinterpret_cast<uint32_t*>(&o[1])[e] = pack_bf16(u0 - uf.x, u1 - uf.y);
            reinterpret_cast<uint32_t*>(&o[3])[e] = pack_bf16(y0 - yf.x, y1 - yf.y);
          }
        }
      }
      const uint32_t off = sw_off(r, k, TR);
      *reinterpret_cast<uint4*>(uh + off) = o[0];
      *reinterpret_cast<uint4*>(ul + off) = o[1];
      *reinterpret_cast<uint4*>(yh + off) = o[2];
      *reinterpret_cast<uint4*>(yl + off) = o[3];
    }
    cp_async_wait_all();
    fence_to_async();
    __syncthreads();

    if (64 * m < L.N) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {  // positions past len are zero
        const uint64_t ab = mdesc(bs, TR, kk, m), ac = mdesc(cs, TR, kk, m);
        wgmma_ss<1, 1>(dacc, ab, mdesc(uh, TR, kk, 0), r0 > 0 || kk > 0);
        if (SPLIT_DE) wgmma_ss<1, 1>(dacc, ab, mdesc(ul, TR, kk, 0), 1);
        wgmma_ss<1, 1>(eacc, ac, mdesc(yh, TR, kk, 0), r0 > 0 || kk > 0);
        if (SPLIT_DE) wgmma_ss<1, 1>(eacc, ac, mdesc(yl, TR, kk, 0), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(dacc);
      pin(eacc);
    }
  }
  if (64 * m >= L.N) return;
  const int w = (tid % 128) / 32, gq = (tid % 32) / 4, tq = tid % 4;
  const int64_t at = (bh * L.NC + c) * L.N * P;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = 64 * m + 16 * w + gq + 8 * r;
    if (n >= L.N) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (8 * j < P) {
        const int64_t e = at + n * P + 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(W.D + e) = make_float2(dacc[4 * j + 2 * r], dacc[4 * j + 2 * r + 1]);
        *reinterpret_cast<float2*>(W.E + e) = make_float2(eacc[4 * j + 2 * r], eacc[4 * j + 2 * r + 1]);
      }
  }
}

// ------------------------------------------------- bf16 2. state passing
// four (n, p) entries a thread of head blockIdx.y, batch blockIdx.z, the D
// (E) of AHEAD chunks loaded together: left to right S_prev = e^{tot} S_prev
// + D from the initial state (each chunk's incoming state in bf16, and in
// f32 over its D, or in registers when the call has at most AHEAD chunks);
// right to left dS_prev = e^{tot} dS + E from d(final state) (each chunk's
// dS in bf16), with this block's share of <S_prev, dS> a chunk; the last
// dS_prev is d(initial state). The f32 recurrences are never rounded.
__global__ void __launch_bounds__(THREADS, 2)
    ssd_bwd_states_bf16_kernel(const float* __restrict__ st0, const float* __restrict__ dsf,
                               float* __restrict__ dst0, BScratch W, Layout L, int P) {
  __shared__ float red[THREADS / 32];
  const int np = L.N * P, e = 4 * (blockIdx.x * THREADS + threadIdx.x), nc = L.NC;
  const bool on = e < np, held = nc <= AHEAD;  // held: every incoming state stays in registers
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = int64_t(b) * L.H + h;
  const float* tot = W.tot + bh * nc;
  float* fw = W.D + bh * nc * np + e;
  const float* bw = W.E + bh * nc * np + e;
  bf16* s16 = W.st16 + bh * nc * np + e;
  bf16* d16 = W.ds16 + bh * nc * np + e;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto fma4 = [](float d, float4 s, float4 v) {
    return make_float4(fmaf(d, s.x, v.x), fmaf(d, s.y, v.y), fmaf(d, s.z, v.z), fmaf(d, s.w, v.w));
  };
  float4 kept[AHEAD];
  float4 s = on && st0 != nullptr ? *reinterpret_cast<const float4*>(st0 + b * L.st0_b + h * L.st0_h + e) : zero;
  for (int c0 = 0; c0 < nc; c0 += AHEAD) {
    float4 v[AHEAD];
    float d[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k)
      if (on && c0 + k < nc) {
        v[k] = *reinterpret_cast<const float4*>(fw + int64_t(c0 + k) * np);
        d[k] = expf(tot[c0 + k]);
      }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k)
      if (on && c0 + k < nc) {
        kept[k] = s;
        if (!held) *reinterpret_cast<float4*>(fw + int64_t(c0 + k) * np) = s;
        *reinterpret_cast<uint2*>(s16 + int64_t(c0 + k) * np) = make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
        s = fma4(d[k], s, v[k]);
      }
  }
  // chunk c's dS and its share of <S_prev, dS> (sp its incoming state);
  // every thread of the block takes the same chunks
  float4 ds = on && dsf != nullptr ? *reinterpret_cast<const float4*>(dsf + b * L.dsf_b + h * L.dsf_h + e) : zero;
  auto step = [&](int c, float4 sp, float4 ev, float dc) {
    if (on)
      *reinterpret_cast<uint2*>(d16 + int64_t(c) * np) = make_uint2(pack_bf16(ds.x, ds.y), pack_bf16(ds.z, ds.w));
    float part = sp.x * ds.x;
    part = fmaf(sp.y, ds.y, part);
    part = fmaf(sp.z, ds.z, part);
    part = fmaf(sp.w, ds.w, part);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sd = 0.f;
      for (int q = 0; q < THREADS / 32; ++q) sd += red[q];
      W.sdp[(bh * nc + c) * W.nsb + blockIdx.x] = sd;
    }
    __syncthreads();  // red is free again
    ds = fma4(dc, ds, ev);
  };
  if (held) {  // one pass, every index known at compile time: chunk k's incoming state is kept[k]
    float4 v[AHEAD];
    float d[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k)
      if (k < nc) {
        v[k] = on ? *reinterpret_cast<const float4*>(bw + int64_t(k) * np) : zero;
        d[k] = expf(tot[k]);
      }
#pragma unroll
    for (int k = AHEAD - 1; k >= 0; --k)
      if (k < nc) step(k, on ? kept[k] : zero, v[k], d[k]);
  } else {
    for (int c1 = nc - 1; c1 >= 0; c1 -= AHEAD) {
      float4 v[AHEAD], sp[AHEAD];
      float d[AHEAD];
#pragma unroll
      for (int k = 0; k < AHEAD; ++k) {
        v[k] = sp[k] = zero;
        d[k] = 0.f;
        if (on && c1 - k >= 0) {
          v[k] = *reinterpret_cast<const float4*>(bw + int64_t(c1 - k) * np);
          sp[k] = *reinterpret_cast<const float4*>(fw + int64_t(c1 - k) * np);
          d[k] = expf(tot[c1 - k]);
        }
      }
#pragma unroll
      for (int k = 0; k < AHEAD; ++k)
        if (c1 - k >= 0) step(c1 - k, sp[k], v[k], d[k]);
    }
  }
  if (on && dst0 != nullptr) *reinterpret_cast<float4*>(dst0 + bh * np + e) = ds;
}

// ------------------------------------------------- bf16 3. gradients
// One block for each (chunk, 64-position tile t, block of HEADS_PER_BLOCK
// heads of one group, batch): two warpgroups, each walking every other
// head of the block in head order. For each head a warpgroup first takes
// the row pass of tile t (rows i of the tile, column tiles j <= t: dC_i and
// the row terms of d ca), then, after all the block's heads, the column
// pass (columns j of the tile, row tiles i >= t: du_j, dB_j, the column
// terms). Row tile t has t + 1 tile pairs and column tile t 4 - t: every
// block does 5 a head. dC and dB of the tile's rows are summed over the
// heads in the warpgroups' f32 accumulators, then warpgroup 1's added to
// warpgroup 0's, and the block writes one f32 partial of each; the
// B and C tiles are loaded once for the block's heads.
__global__ void __launch_bounds__(THREADS, 1)
    ssd_bwd_grads_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                              const float* __restrict__ A, const bf16* __restrict__ bm,
                              const bf16* __restrict__ cm, const bf16* __restrict__ dy, bf16* __restrict__ dx,
                              BScratch W, Layout L, int P) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* bt = align_1024(smem_raw);  // B tiles 0..t, then C tiles t..3: (64, N) K-major or MN-major
  const int c = blockIdx.x / TILES, t = blockIdx.x % TILES;
  const int c0 = c * L.Q, len = min(L.Q, L.S - c0);
  if (TR * t >= len) return;
  const int tiles = (len + TR - 1) / TR;
  const int rep = L.H / L.G, g = blockIdx.y / W.nhb, hb = blockIdx.y % W.nhb, b = blockIdx.z;
  const int h0 = g * rep + hb * HEADS_PER_BLOCK, nh = min(HEADS_PER_BLOCK, rep - hb * HEADS_PER_BLOCK);
  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;
  const int w = lt / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int rl = 16 * w + gq;  // this thread's rows of a 64-row accumulator: rl and rl + 8
  uint8_t* ct = bt + (t + 1) * TILE_N;  // C tile i at ct + (i - t) TILE_N
  uint8_t* regions = bt + (TILES + 1) * TILE_N;
  uint8_t* st = regions + wg * WG_BYTES;  // this warpgroup's head: its state (S_prev or dS)
  uint8_t* slot = st + STATE_TILE;        // and five P tiles: slot s at slot + s TILE_P
  double* ca = reinterpret_cast<double*>(regions + 2 * WG_BYTES) + wg * MAX_Q;
  float* dts = reinterpret_cast<float*>(regions + 2 * WG_BYTES + 2 * MAX_Q * sizeof(double)) + wg * MAX_Q;
  float* buf = reinterpret_cast<float*>(regions + WG_BYTES);  // warpgroup 1's region: its sums for warpgroup 0

  const bf16* bb = bm + b * L.bm.b + g * L.bm.h + int64_t(c0) * L.bm.s;
  const bf16* cb = cm + b * L.cm.b + g * L.cm.h + int64_t(c0) * L.cm.s;
  for (int j = 0; j <= t; ++j) load_tile<16, THREADS>(bt + j * TILE_N, bb, L.bm.s, TR * j, len, L.N, tid);
  for (int i = t; i < tiles; ++i) load_tile<16, THREADS>(ct + (i - t) * TILE_N, cb, L.cm.s, TR * i, len, L.N, tid);
  const int64_t S = L.S, part = (int64_t(b) * gridDim.y + blockIdx.y) * S * L.N;  // this block's partials

  // one head's tiles and cumsum, by this warpgroup; `rows` true for the row
  // pass (slot 0: dy_t, slots 1..t + 1: u_0..u_t, S_prev), false for the
  // column pass (slot 0: u_t, slots 1..: dy_t..dy_3, dS)
  auto load_head = [&](int h, bool rows) {
    const int64_t bh = int64_t(b) * L.H + h;
    const bf16* xb = x + b * L.x.b + h * L.x.h + int64_t(c0) * L.x.s;
    const float* dtb = dt + b * L.dt.b + h * L.dt.h + int64_t(c0) * L.dt.s;
    const bf16* dyb = dy + b * L.dy.b + h * L.dy.h + int64_t(c0) * L.dy.s;
    const int64_t entry = (bh * L.NC + c) * L.N * P;
    wg_sync(wg);  // the previous head's tiles and cumsum are no longer read
    // every copy in flight at once; x lands raw in the u slots
    load_state(st, (rows ? W.st16 : W.ds16) + entry, L.N, P, lt);
    if (rows) {
      load_tile<8, 128>(slot, dyb, L.dy.s, TR * t, len, P, lt);
      for (int j = 0; j <= t; ++j) load_tile<8, 128>(slot + (1 + j) * TILE_P, xb, L.x.s, TR * j, len, P, lt);
    } else {
      for (int i = t; i < tiles; ++i) load_tile<8, 128>(slot + (1 + i - t) * TILE_P, dyb, L.dy.s, TR * i, len, P, lt);
      load_tile<8, 128>(slot, xb, L.x.s, TR * t, len, P, lt);
    }
    if (w == 0) chunk_cumsum(dtb, L.dt.s, 0, len, A[h], ca, dts, lane);
    cp_async_wait_all();
    wg_sync(wg);  // x and dt are in
    if (rows)
      for (int j = 0; j <= t; ++j) make_u(slot + (1 + j) * TILE_P, dts, TR * j, lt);
    else
      make_u(slot, dts, TR * t, lt);
    fence_to_async();
    wg_sync(wg);
  };
  // warpgroup 1's sums (acc) added to warpgroup 0's, stored to the partial at dst
  auto merge_store = [&](float (&acc)[2][32], float* dst) {
    __syncthreads();  // both warpgroups are done with their heads
    if (wg == 1)
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(buf + (rl + 8 * r) * MAX_N + 64 * a + 8 * q + 2 * tq) =
                make_float2(acc[a][4 * q + 2 * r], acc[a][4 * q + 2 * r + 1]);
    __syncthreads();
    if (wg == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = TR * t + rl + 8 * r;
        if (i >= len) continue;
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int n = 64 * a + 8 * q + 2 * tq;
            if (n >= L.N) continue;
            const float2 o = *reinterpret_cast<const float2*>(buf + (rl + 8 * r) * MAX_N + n);
            *reinterpret_cast<float2*>(dst + (c0 + i) * int64_t(L.N) + n) =
                make_float2(acc[a][4 * q + 2 * r] + o.x, acc[a][4 * q + 2 * r + 1] + o.y);
          }
      }
    __syncthreads();  // buf is free again
  };

  // ---- row pass: dC_i and the row terms of d ca_i, rows i of tile t
  float dc[2][32];  // (64, N) in two 64-column halves, over this warpgroup's heads
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int q = 0; q < 32; ++q) dc[a][q] = 0.f;
  cp_async_wait_all();  // the B and C tiles, loaded by both warpgroups
  fence_to_async();
  __syncthreads();
  for (int k = wg; k < nh; k += 2) {
    const int h = h0 + k;
    if (STAGGER && k == 1) stagger_wait();
    load_head(h, true);
    if (STAGGER && k == 0 && nh > 1) stagger_arrive();
    const double ca_i[2] = {ca[TR * t + rl], ca[TR * t + rl + 8]};
    float rowt[2] = {0.f, 0.f};
    {  // the incoming state's share: Z = e^{ca_i} dy_i S_prev^T into dC_i, and C_i . Z_i into d ca_i
      float z[2][32];
      wgmma_fence();
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
          wgmma_ss<0, 0>(z[a], kdesc(slot, TR, kk), kdesc(st + a * 64 * 128, MAX_N, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      pin(z[0]);
      pin(z[1]);
      const float ei[2] = {expf(float(ca_i[0])), expf(float(ca_i[1]))};
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 cv = ld_pair(ct + sw_off(rl + 8 * r, 8 * a + q, TR) + 4 * tq);
            const float z0 = z[a][4 * q + 2 * r] * ei[r], z1 = z[a][4 * q + 2 * r + 1] * ei[r];
            rowt[r] = fmaf(cv.x, z0, rowt[r]);
            rowt[r] = fmaf(cv.y, z1, rowt[r]);
            dc[a][4 * q + 2 * r] += z0;
            dc[a][4 * q + 2 * r + 1] += z1;
          }
    }
    for (int j = 0; j <= t; ++j) {
      float s[32], d[32];  // scores C_i . B_j^T and dy_i . u_j^T
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) wgmma_ss<0, 0>(s, kdesc(ct, TR, kk), kdesc(bt + j * TILE_N, TR, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        wgmma_ss<0, 0>(d, kdesc(slot, TR, kk), kdesc(slot + (1 + j) * TILE_P, TR, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      pin(s);
      pin(d);
      // G = dsc o L (masked before the exp: above the diagonal the
      // exponent is positive), rounded to bf16 as the A operand of G B_j;
      // the row terms sum G o scores in f32 (a diagonal pair's two terms
      // cancel: left out)
      uint32_t ga[4][4];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2, col = TR * j + 8 * q + 2 * tq + (e % 2), row = TR * t + rl + 8 * r;
          const float gv = d[4 * q + e] * decay(j < t || col <= row ? float(ca_i[r] - ca[col]) : -INFINITY);
          if (j < t || col < row) rowt[r] = fmaf(gv, s[4 * q + e], rowt[r]);
          v[e] = gv;
        }
        ga[q / 2][(q % 2) * 2] = pack_bf16(v[0], v[1]);
        ga[q / 2][(q % 2) * 2 + 1] = pack_bf16(v[2], v[3]);
      }
      pin(ga);
      pin(dc[0]);
      pin(dc[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
#pragma unroll
        for (int a = 0; a < 2; ++a) wgmma_rs(dc[a], ga[kk], mdesc(bt + j * TILE_N, TR, kk, a));
      wgmma_commit();
      wgmma_wait_all();
      pin(dc[0]);
      pin(dc[1]);
      pin(ga);
    }
    const int64_t bh = int64_t(b) * L.H + h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float v = quad_sum(rowt[r]);
      const int i = TR * t + rl + 8 * r;
      if (tq == 0 && i < len) W.dcr[bh * S + c0 + i] = v;
    }
  }
  merge_store(dc, W.dcp + part);

  // ---- column pass: du_j, dB_j and the column terms of d ca_j, rows j of tile t
  float db[2][32];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int q = 0; q < 32; ++q) db[a][q] = 0.f;
  for (int k = wg; k < nh; k += 2) {
    const int h = h0 + k;
    if (STAGGER && k == 1) stagger_wait();
    load_head(h, false);
    if (STAGGER && k == 0 && nh > 1) stagger_arrive();
    const double tot = ca[len - 1];
    const double ca_j[2] = {ca[TR * t + rl], ca[TR * t + rl + 8]};
    float wj[2];  // e^{tot - ca_j}
#pragma unroll
    for (int r = 0; r < 2; ++r) wj[r] = TR * t + rl + 8 * r < len ? expf(float(tot - ca_j[r])) : 0.f;
    // d(outgoing state)'s share: du_j = e^{tot - ca_j} B_j dS, dB_j +=
    // e^{tot - ca_j} u_j dS^T, and u_j . du_j (d tot's, and -d ca_j's)
    float du[32], wsd[2] = {0.f, 0.f};
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) wgmma_ss<0, 1>(du, kdesc(bt + t * TILE_N, TR, kk), mdesc(st, MAX_N, kk, 0), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    pin(du);
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        du[4 * q + 2 * r] *= wj[r];
        du[4 * q + 2 * r + 1] *= wj[r];
        const float2 uv = ld_pair(slot + sw_off(rl + 8 * r, q, TR) + 4 * tq);
        wsd[r] = fmaf(uv.x, du[4 * q + 2 * r], wsd[r]);
        wsd[r] = fmaf(uv.y, du[4 * q + 2 * r + 1], wsd[r]);
      }
    {
      float y[2][32];
      wgmma_fence();
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
          wgmma_ss<0, 0>(y[a], kdesc(slot, TR, kk), kdesc(st + a * 64 * 128, MAX_N, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      pin(y[0]);
      pin(y[1]);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int q = 0; q < 32; ++q) db[a][q] = fmaf(wj[(q / 2) % 2], y[a][q], db[a][q]);
    }
    float colt[2] = {0.f, 0.f};
    for (int i = t; i < tiles; ++i) {
      const uint8_t* dyi = slot + (1 + i - t) * TILE_P;
      const uint8_t* ci = ct + (i - t) * TILE_N;
      float s[32], d[32];  // B_j . C_i^T and u_j . dy_i^T: rows j, columns i
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) wgmma_ss<0, 0>(s, kdesc(bt + t * TILE_N, TR, kk), kdesc(ci, TR, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) wgmma_ss<0, 0>(d, kdesc(slot, TR, kk), kdesc(dyi, TR, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      pin(s);
      pin(d);
      // (scores o L)^T and (dsc o L)^T rounded to bf16 as the A operands of
      // du_j += . dy_i and dB_j += . C_i; the column terms in f32
      uint32_t pa[4][4], ga[4][4];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float pv[4], gv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2, col = TR * i + 8 * q + 2 * tq + (e % 2), row = TR * t + rl + 8 * r;
          const float ev = decay(i > t || col >= row ? float(ca[col] - ca_j[r]) : -INFINITY);
          pv[e] = s[4 * q + e] * ev;
          gv[e] = d[4 * q + e] * ev;
          if (i > t || col > row) colt[r] = fmaf(gv[e], s[4 * q + e], colt[r]);
        }
        pa[q / 2][(q % 2) * 2] = pack_bf16(pv[0], pv[1]);
        pa[q / 2][(q % 2) * 2 + 1] = pack_bf16(pv[2], pv[3]);
        ga[q / 2][(q % 2) * 2] = pack_bf16(gv[0], gv[1]);
        ga[q / 2][(q % 2) * 2 + 1] = pack_bf16(gv[2], gv[3]);
      }
      pin(pa);
      pin(ga);
      pin(du);
      pin(db[0]);
      pin(db[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        wgmma_rs(du, pa[kk], mdesc(dyi, TR, kk, 0));
#pragma unroll
        for (int a = 0; a < 2; ++a) wgmma_rs(db[a], ga[kk], mdesc(ci, TR, kk, a));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(du);
      pin(db[0]);
      pin(db[1]);
      pin(pa);
      pin(ga);
    }
    // dx_j = du_j dt_j; du_j . x_j (ddt's x route); d ca_j's column and state terms
    const int64_t bh = int64_t(b) * L.H + h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = TR * t + rl + 8 * r;
      float xd = 0.f;
      if (j < len) {
        const float dj = dts[j];
        bf16* dst = dx + b * L.dx.b + h * L.dx.h + int64_t(c0 + j) * L.dx.s + 2 * tq;
        const bf16* xr = x + b * L.x.b + h * L.x.h + int64_t(c0 + j) * L.x.s + 2 * tq;
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (8 * q < P) {
            const float d0 = du[4 * q + 2 * r], d1 = du[4 * q + 2 * r + 1];
            *reinterpret_cast<uint32_t*>(dst + 8 * q) = pack_bf16(d0 * dj, d1 * dj);
            const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + 8 * q));
            xd = fmaf(d0, xv.x, xd);
            xd = fmaf(d1, xv.y, xd);
          }
      }
      xd = quad_sum(xd);
      const float cd = quad_sum(colt[r]), sd = quad_sum(wsd[r]);
      if (tq == 0 && j < len) {
        W.dux[bh * S + c0 + j] = xd;
        W.dcc[bh * S + c0 + j] = -cd - sd;
        W.wst[bh * S + c0 + j] = sd;
      }
    }
  }
  merge_store(db, W.dbp + part);
}

// ------------------------------------------------- bf16 4. finish
// A block a head, a warp a (batch, chunk) in turn: d ca = the row and the
// column terms, d tot (the state update's terms and e^{tot} <S_prev, dS>)
// added at the chunk's last position, da by a reverse cumsum (8 positions
// a lane, then across lanes), ddt = du . x + da A_h, and dA_h = sum da dt:
// each warp's (batch, chunk) shares in turn, then the warps in order.
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_finish_bf16_kernel(const float* __restrict__ dt, const float* __restrict__ A, BScratch W,
                               float* __restrict__ ddt, float* __restrict__ dA, Layout L) {
  __shared__ float red[THREADS / 32];
  const int h = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int PER = MAX_Q / 32;
  const float a_h = A[h];
  float share = 0.f;
  for (int bc = warp; bc < L.B * L.NC; bc += THREADS / 32) {
    const int b = bc / L.NC, c = bc % L.NC;
    const int c0 = c * L.Q, len = min(L.Q, L.S - c0);
    const int64_t bh = int64_t(b) * L.H + h, at = bh * L.S + c0;
    float v[PER], ws = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = lane * PER + k;
      v[k] = i < len ? W.dcr[at + i] + W.dcc[at + i] : 0.f;
      ws += i < len ? W.wst[at + i] : 0.f;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ws += __shfl_xor_sync(0xffffffffu, ws, o);
    float sd = 0.f;
    for (int q = 0; q < W.nsb; ++q) sd += W.sdp[(bh * L.NC + c) * W.nsb + q];
    const int last = len - 1 - lane * PER;
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (k == last) v[k] += ws + expf(W.tot[bh * L.NC + c]) * sd;
    float run = 0.f;  // the lane's suffix sums, then the lanes after it
#pragma unroll
    for (int k = PER - 1; k >= 0; --k) {
      run += v[k];
      v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += up;
    }
    const float after = incl - run;
    float pa = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = lane * PER + k;
      if (i < len) {
        const float da = v[k] + after;
        const int64_t s = c0 + i;
        ddt[b * L.ddt.b + h * L.ddt.h + s * L.ddt.s] = fmaf(da, a_h, W.dux[at + i]);
        pa = fmaf(da, dt[b * L.dt.b + h * L.dt.h + s * L.dt.s], pa);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) pa += __shfl_xor_sync(0xffffffffu, pa, o);
    share += pa;
  }
  if (lane == 0) red[warp] = share;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = 0.f;
    for (int q = 0; q < THREADS / 32; ++q) v += red[q];
    dA[h] = v;
  }
}

// ------------------------------------------------- bf16 5. the partials' sums
// dB and dC of each (batch, position, group): the group's nhb partials
// added in order, stored in bf16
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_part_sum_kernel(BScratch W, bf16* __restrict__ dbm, bf16* __restrict__ dcm, Layout L) {
  const float* part = blockIdx.y == 0 ? W.dbp : W.dcp;
  bf16* out = blockIdx.y == 0 ? dbm : dcm;
  const Strides3 os = blockIdx.y == 0 ? L.dbm : L.dcm;
  const int64_t total = int64_t(L.B) * L.S * L.G * L.N;
  for (int64_t e = blockIdx.x * int64_t(THREADS) + threadIdx.x; e < total; e += int64_t(gridDim.x) * THREADS) {
    const int n = int(e % L.N);
    int64_t r = e / L.N;
    const int g = int(r % L.G);
    r /= L.G;
    const int s = int(r % L.S);
    const int b = int(r / L.S);
    float v = 0.f;
    for (int k = 0; k < W.nhb; ++k) v += part[((int64_t(b) * L.G + g) * W.nhb + k) * L.S * L.N + int64_t(s) * L.N + n];
    out[b * os.b + s * os.s + g * os.h + n] = __float2bfloat16(v);
  }
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

// the bf16 path's five kernels on one stream; `work` holds the BScratch
cudaError_t launch_bf16(const void* x, const void* dt, const void* A, const void* bm, const void* cm,
                        const void* st0, const void* dy, const void* dsf, void* dx, void* ddt, void* dA,
                        void* dbm, void* dcm, void* dst0, float* work, const Layout& L, int P,
                        cudaStream_t stream) {
  static std::atomic<uint64_t> sized_terms{0}, sized_grads{0};  // cards whose limit is raised
  cudaError_t err = size_smem_once(reinterpret_cast<const void*>(ssd_bwd_terms_bf16_kernel), int(TERMS_SMEM),
                                   sized_terms);
  if (err != cudaSuccess) return err;
  err = size_smem_once(reinterpret_cast<const void*>(ssd_bwd_grads_bf16_kernel), int(GRADS_SMEM), sized_grads);
  if (err != cudaSuccess) return err;
  const int64_t states = int64_t(L.B) * L.H * L.NC * L.N * P, chunks = int64_t(L.B) * L.H * L.NC;
  const int nhb = (L.H / L.G + HEADS_PER_BLOCK - 1) / HEADS_PER_BLOCK, nsb = (L.N * P + 4 * THREADS - 1) / (4 * THREADS);
  const int64_t parts = int64_t(L.B) * L.G * nhb * L.S * L.N, pos = int64_t(L.B) * L.H * L.S;
  float* w = work;
  BScratch W;
  W.D = w;
  W.E = w + states;
  W.st16 = reinterpret_cast<bf16*>(w + 2 * states);
  W.ds16 = W.st16 + states;
  W.dbp = w + 3 * states;
  W.dcp = W.dbp + parts;
  W.dcr = W.dcp + parts;
  W.dcc = W.dcr + pos;
  W.wst = W.dcc + pos;
  W.dux = W.wst + pos;
  W.tot = W.dux + pos;
  W.sdp = W.tot + chunks;
  W.nhb = nhb;
  W.nsb = nsb;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(bm);
  const bf16* cb = static_cast<const bf16*>(cm);
  const bf16* dyb = static_cast<const bf16*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  ssd_bwd_terms_bf16_kernel<<<dim3(L.NC, L.H, L.B), THREADS, TERMS_SMEM, stream>>>(xb, dtf, Af, bb, cb, dyb, W, L, P);
  ssd_bwd_states_bf16_kernel<<<dim3(nsb, L.H, L.B), THREADS, 0, stream>>>(
      static_cast<const float*>(st0), static_cast<const float*>(dsf), static_cast<float*>(dst0), W, L, P);
  ssd_bwd_grads_bf16_kernel<<<dim3(L.NC * TILES, L.G * nhb, L.B), THREADS, GRADS_SMEM, stream>>>(
      xb, dtf, Af, bb, cb, dyb, static_cast<bf16*>(dx), W, L, P);
  ssd_bwd_finish_bf16_kernel<<<L.H, THREADS, 0, stream>>>(dtf, Af, W, static_cast<float*>(ddt),
                                                          static_cast<float*>(dA), L);
  const int64_t total = int64_t(L.B) * L.S * L.G * L.N;
  const int64_t want = (total + THREADS - 1) / THREADS;
  const int blocks = int(want < 132 * 8 ? want : 132 * 8);  // grid-stride beyond 8 blocks an SM
  ssd_bwd_part_sum_kernel<<<dim3(blocks, 2), THREADS, 0, stream>>>(W, static_cast<bf16*>(dbm),
                                                                   static_cast<bf16*>(dcm), L);
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

// f32 elements of the scratch a call needs: in f32 (dtype 0) Scratch's
// fields in order, in bf16 (dtype 1) BScratch's
int64_t repro_ssd_scan_bwd_scratch(int B, int H, int G, int S, int P, int N, int Q, int dtype) {
  const int64_t nc = (S + Q - 1) / Q;
  if (dtype == 0) return 2 * int64_t(B) * H * nc * (int64_t(N) * P + 1) + 2 * int64_t(B) * H * S * N;
  const int64_t nhb = (H / G + HEADS_PER_BLOCK - 1) / HEADS_PER_BLOCK, nsb = (N * P + 4 * THREADS - 1) / (4 * THREADS);
  return 3 * int64_t(B) * H * nc * N * P + 2 * int64_t(B) * G * nhb * S * N + 4 * int64_t(B) * H * S +
         int64_t(B) * H * nc * (1 + nsb);
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
    return int(launch_bf16(x, dt, A, bm, cm, st0, dy, dsf, dx, ddt, dA, dbm, dcm, dst0, w, L, P, st));
  return int(launch_p<float>(P, x, dt, A, bm, cm, st0, dy, dsf, dx, ddt, dA, dbm, dcm, dst0, W, L, st));
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
