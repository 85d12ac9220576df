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
// dA = dt * A is f32. y is stored in x's dtype and the final state in f32.
//
// Layout. x and y are (B, S, H, P), dt is (B, S, H), B and C are
// (B, S, G, N) in memory (the model's layout); the caller passes element
// strides for every axis but the last, whose stride must be 1. Head h
// reads group h / (H / G) (jnp.repeat's order): the groups are never
// copied per head. The states are (B, H, N, P) with (N, P) contiguous.
// Every path masks before an exp (above the diagonal ca_i - ca_j > 0
// could overflow, and inf * 0 is NaN); S need not divide Q: the last chunk
// is shorter, positions past S are neither read into a product nor
// stored, and the final state is the state after exactly S tokens.
//
// Bound. At the serving shape (B 4, H 80, S 2000, P 64, N 128, Q 256,
// bf16) the function moves ~0.19 GB and does ~52 GFLOP: on the tensor
// cores' bf16 rate it is bound by bytes (~0.057 ms).
//
// bf16 (the serving path): chunk-parallel, on wgmma. It replaces a kernel
// that gave each (batch, head) one block walking its chunks in order and
// ran all four products as f32 FMAs on the CUDA cores (320 blocks at the
// serving shape, 80 for one sequence, on 132 SMs; 6.1 ms, ~107x its
// bound). The chunks' own work does not depend on one another; only an
// (N, P) recurrence runs across them. So one call runs three kernels:
//  1. Chunk states, grid (chunk, head, batch), two warpgroups. The block
//     takes its chunk's cumsum of dA in f32, in order, and its own
//     contribution D_c = B^T (xdt o e^{ca_last - ca}) (N x P, over the
//     chunk's positions, in stages of P1_ROWS) as wgmma m64n64k16 with
//     f32 accumulation, one 64-row tile of N a warpgroup, both operands
//     MN-major from shared memory. It writes D_c and e^{ca_last} to an
//     f32 scratch (B, H, n_chunks, N, P) and (B, H, n_chunks).
//  2. State passing, f32 on the CUDA cores, grid (N P / 1024, head,
//     batch), four entries a thread, the D_c of 8 chunks loaded together:
//     state_{c+1} = e^{ca_last,c} state_c + D_c from st0 (or zero); each
//     chunk's incoming state goes to the scratch, the last to st_out.
//  3. Outputs, grid (chunk, head pair, batch), three warpgroups taking
//     the 64-row tiles {3}, {2, 0} and {1} (equal causal work). A tile
//     first takes y = diag(e^{ca}) (C . state_c) (wgmma, the state in
//     bf16 as the MN-major B operand), then, for each 64-column tile at
//     or below the diagonal, the scores C_i . B_j^T (wgmma, both
//     K-major), masked and decayed in registers, rounded to bf16 as
//     wgmma's register A operand, times the xdt tile (MN-major B):
//     y += ((C B^T) o L) xdt, stored in bf16. Two heads of one group
//     share the block's B and C tiles and each score tile.
// Loads. Every operand tile goes through the threads in 16-byte vectors
// into 128-byte-swizzled atoms (8 rows x 128 B, as TMA would write them;
// the tiles' padding is zero-filled there), B, C and the bf16 state by
// cp.async and x through registers, every vector of a stage in flight at
// once; then fence.proxy.async makes them visible to wgmma. x needs the
// threads anyway (x * dt rounded, the decay, the hi/lo split), and B, C
// of one group are shared by all its heads and come from L2. P pads to 64
// and N to 128 in shared memory: the products are all m64n64k16 with
// k-loops fixed at compile time (a loop bound known only at run time made
// ptxas serialize the wgmmas), and only the rows and columns of the real
// P and N are stored. 16-byte vectors need a 16-byte aligned base and
// strides in multiples of 8 elements (ssd_scan.check_layout).
// Refinements, each a named constant below, each measured on and off by
// scripts/torch_kernel_ab.py --kernel ssd --ablate (PERF.md, section 6):
// SPLIT_XD (precision), FAST_DECAY, STATE_BF16, P1_ROWS, P1_BLOCKS,
// OUT_WARPGROUPS, HEADS_PER_BLOCK.
// Roundings the bf16 path adds to the TPU kernel's all-f32 products
// (C . B^T on bf16 inputs with f32 accumulation adds none):
//  - the decayed scores (C B^T) o L, to bf16, as the A operand of the
//    product with xdt (as K1 rounds P; repro/models/layers.py:366); with
//    FAST_DECAY their decay is ex2.approx of (ca_i - ca_j) log2(e);
//  - the incoming state, to bf16, as the operand of C . state (the f32
//    state itself is never rounded); both feed y only, stored in bf16;
//  - xdt o e^{ca_last - ca}, which feeds the carried state: split into
//    bf16 hi + lo (lo = the rounding error of hi), two wgmmas into one
//    accumulator, so D_c keeps ~16 bits of the operand (SPLIT_XD).
// What bounds it: the scratch is the design's cost over the function's
// bytes: f32 D_c written by phase 1 and read by phase 2, the bf16 states
// written by phase 2 and read by phase 3 (126 MB at the serving shape,
// 84 + 42; ~0.075 ms at the HBM rate on top of the function's 0.057).
// Phase 3 holds the whole chunk's B and C (64 KB each) and one block an
// SM; its loads do not overlap its products. Measured times: PERF.md,
// section 6.
// ptxas (sm_90a, CUDA 12.8; the bf16 kernels pad P to 64, so every P
// builds the same code): phase 1 64 registers (the P1_BLOCKS cap), 40
// bytes of spill stores, 35,840 bytes of dynamic shared memory; phase 2
// 54 registers, no spills, none; phase 3 at two heads a block 168
// registers (384 threads' most), 4 bytes of spill stores, 232,448 bytes
// (the card's most), at one head 135 registers, no spills, 182,272 bytes.
// f32 (unchanged): 128 / 117 / 103 registers at P 64 / 32 / 16, no spills.
//
// f32 (the checks at 1e-3 and mamba2's f32-activation twin): the first
// kernel, unchanged: one block per (batch, head) walks its chunks with
// the state in shared memory, every product as f32 FMAs on the CUDA cores
// (256 threads, each holding a 4 x 4 block of scores, a 4 x P/16 block of
// y and N/16 x P/16 state entries); the (Q, Q) score matrix is tiled into
// 64 x 64 tiles at or below the diagonal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;  // every kernel: 16 x 16 thread groups (f32) or two warpgroups (bf16)
constexpr int TR = 64;        // positions per tile
constexpr int MAX_Q = 256;    // longest chunk
constexpr int MAX_N = 128;    // largest state dim
constexpr int TP = TR + 1;    // padded row stride of the f32 score tile

using bf16 = __nv_bfloat16;

struct Strides3 {
  int64_t b, s, h;  // batch, sequence, head (or group); the last axis has stride 1
};

struct Layout {
  int B, H, G, S, N, Q;
  Strides3 x, dt, bm, cm, y;
  int64_t st0_b, st0_h, sto_b, sto_h;  // states: (N, P) contiguous
};

// ------------------------------------------------------------ f32, CUDA cores
size_t f32_smem_bytes(int N, int P) {
  return sizeof(float) * (size_t(N) * P + 2 * size_t(TR) * (N + 1) + size_t(TR) * P +
                          size_t(TR) * TP + 2 * size_t(MAX_Q));
}

template <int P>
__global__ void __launch_bounds__(THREADS)
    ssd_scan_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const float* __restrict__ bm,
                        const float* __restrict__ cm, const float* __restrict__ st0,
                        float* __restrict__ y, float* __restrict__ st_out, Layout L) {
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
  const float* xb = x + b * L.x.b + h * L.x.h;
  const float* dtb = dt + b * L.dt.b + h * L.dt.h;
  const float* bb = bm + b * L.bm.b + g * L.bm.h;
  const float* cb = cm + b * L.cm.b + g * L.cm.h;
  float* yb = y + b * L.y.b + h * L.y.h;
  const float a_h = A[h];

  for (int idx = tid; idx < N * P; idx += THREADS)
    state[idx] = st0 != nullptr ? st0[b * L.st0_b + h * L.st0_h + idx] : 0.f;

  // rows [r0, r0 + TR) of a (S, N) matrix (rows relative to the chunk at c0)
  // into a padded tile; rows at or past len are zero
  auto load_rows = [&](float* tile, const float* src, int64_t row_stride, int c0, int r0, int len) {
    for (int idx = tid; idx < TR * N; idx += THREADS) {
      const int r = idx / N, n = idx % N;
      const int i = r0 + r;
      tile[r * NP + n] = i < len ? src[(c0 + i) * row_stride + n] : 0.f;
    }
  };
  // xdt rows [r0, r0 + TR) of the chunk, each times weight(i)
  auto load_xdt = [&](int c0, int r0, int len, float ca_last, bool decay_to_end) {
    for (int idx = tid; idx < TR * P; idx += THREADS) {
      const int r = idx / P, p = idx % P;
      const int i = r0 + r;
      float v = 0.f;
      if (i < len) {
        v = xb[(c0 + i) * L.x.s + p] * dts[i];
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
        for (int c = 0; c < PC; ++c) yb[(c0 + i) * L.y.s + tx + 16 * c] = acc[a][c];
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

// ------------------------------------------------- bf16: Hopper primitives
#include "ssd_wgmma.cuh"

// ------------------------------------------------------ bf16: the kernels
// Refinements over the plain decomposition, each a named constant;
// scripts/torch_kernel_ab.py --kernel ssd --ablate builds the kernel with
// each set to its plain value (in brackets) and reports its time and
// final-state error (PERF.md).
constexpr bool SPLIT_XD = true;    // precision: D_c's decayed xdt as bf16 hi + lo (false: hi alone)
constexpr bool FAST_DECAY = true;  // phase 3: ex2.approx for the score decays, the causal mask
                                   // only on diagonal tiles (false: expf, the mask on every tile)
constexpr bool STATE_BF16 = true;  // phase 2 hands phase 3 each incoming state in bf16 (the
                                   // operand's rounding): half the bytes both ways (false: f32)
constexpr int P1_ROWS = 64;        // phase 1 walks its chunk in stages of this many positions
                                   // (MAX_Q: the whole chunk at once)
constexpr int P1_BLOCKS = 4;       // phase 1's blocks an SM, which caps its registers (1: no cap)
constexpr int OUT_WARPGROUPS = 3;  // phase 3's warpgroups (2: two 64-row tiles each)
constexpr int HEADS_PER_BLOCK = 2; // phase 3: two heads of one group share a block's B and C
                                   // tiles and its score tiles (1: a block a head)

constexpr float LOG2E = 1.4426950408889634f;
constexpr int NK = MAX_N / 16;  // k-steps over N (N is zero-padded to MAX_N)
constexpr int OUT_THREADS = 128 * OUT_WARPGROUPS;
// the 64-row tile of phase 3's warpgroup wg in its pass 0 or 1 (-1: none),
// for equal causal work (tile t takes t + 1 score tiles): {0, 3} and
// {1, 2} for two warpgroups; {3}, {2, 0} and {1} for three
__device__ __forceinline__ int out_tile(int wg, int pass) {
  if (OUT_WARPGROUPS == 2) return pass == 0 ? wg : 3 - wg;
  if (wg == 1) return pass == 0 ? 2 : 0;
  return pass == 0 ? 3 - wg : -1;
}
// rows x N of B or C in atom columns of `rows` rows; rows x P padded to 64
__host__ __device__ constexpr uint32_t bc_tile(int rows) { return (MAX_N / 64) * rows * 128; }
__host__ __device__ constexpr uint32_t x_tile(int rows) { return rows * 128; }
constexpr uint32_t STATE_TILE = MAX_N * 128;              // the state in bf16, (N, P padded to 64)
constexpr uint32_t VEC_BYTES = 2 * MAX_Q * sizeof(float);  // ca and dt of the chunk
// +1024: the dynamic shared memory is aligned up to the atoms' 1024 bytes
constexpr size_t STATES_SMEM = 1024 + bc_tile(P1_ROWS) + 2 * x_tile(P1_ROWS) + VEC_BYTES;
// phase 3 with HB heads a block (at HB 2 the card's whole 232,448 bytes)
constexpr size_t out_smem(int HB) {
  return 1024 + 2 * bc_tile(MAX_Q) + HB * (x_tile(MAX_Q) + STATE_TILE + MAX_Q * sizeof(float));
}

// ROWS rows of a bf16 (S, N) matrix from row r0 into a (ROWS, MAX_N) tile
// of swizzled atoms, by NT threads; rows at or past len and columns past
// N zero. Every copy is issued before any lands (cp.async;
// cp_async_wait_all).
template <int ROWS, int NT>
__device__ __forceinline__ void load_bc(uint8_t* tile, const bf16* src, int64_t row_stride, int r0,
                                        int len, int N) {
  constexpr int VECS = MAX_N / 8;
  for (int idx = threadIdx.x; idx < ROWS * VECS; idx += NT) {
    const int r = idx / VECS, k = idx % VECS;
    const bool full = r0 + r < len && 8 * k < N;
    cp_async16(tile + sw_off(r, k, ROWS), full ? src + int64_t(r0 + r) * row_stride + 8 * k : src, full);
  }
}

// the 16-byte x vectors (8 of P) of ROWS rows from r0, loaded together by
// NT threads: vector u of this thread is row (tid + u NT) / 8, columns
// 8 ((tid + u NT) % 8) on; zero at or past len and P
template <int ROWS, int NT>
struct XVecs {
  static constexpr int N = (ROWS * 8 + NT - 1) / NT;
  uint4 v[N];

  __device__ __forceinline__ void load(const bf16* xb, int64_t row_stride, int r0, int len, int P) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int idx = threadIdx.x + u * NT, r = idx / 8, k = idx % 8;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < ROWS * 8 && r0 + r < len && 8 * k < P)
        v[u] = *reinterpret_cast<const uint4*>(xb + int64_t(r0 + r) * row_stride + 8 * k);
    }
  }
};

// The scratch, n_chunks entries for each (batch, head): D_c from phase 1;
// each chunk's incoming state from phase 2, in place in f32 or, with
// STATE_BF16, in bf16 beside it; each chunk's e^{ca_last}.
struct Scratch {
  float* states;   // (B, H, n_chunks, N, P) f32
  bf16* states16;  // (B, H, n_chunks, N, P) bf16
  float* decays;   // (B, H, n_chunks)
};

// inclusive cumsum of dA over the chunk at c0 (positions past len add 0),
// run by one warp: 8 positions a lane, then across lanes; the bf16 kernels
// of phases 1 and 3 both call it, so they see the same ca (the f32 kernel
// keeps its own copy inline). With STORE_DT dt goes to dts too.
template <bool STORE_DT = true>
__device__ __forceinline__ void chunk_cumsum(const float* dtb, int64_t dt_s, int c0, int len,
                                             float a_h, float* dts, float* ca) {
  const int lane = threadIdx.x % 32;
  float v[MAX_Q / 32], run = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_Q / 32; ++k) {
    const int i = lane * (MAX_Q / 32) + k;
    const float d = i < len ? dtb[(c0 + i) * dt_s] : 0.f;
    if (STORE_DT) dts[i] = d;
    run += d * a_h;
    v[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  const float before = incl - run;
#pragma unroll
  for (int k = 0; k < MAX_Q / 32; ++k) ca[lane * (MAX_Q / 32) + k] = before + v[k];
}

// Phase 1: D_c = B^T (xdt o e^{ca_last - ca}) and e^{ca_last} of chunk
// blockIdx.x of head blockIdx.y, batch blockIdx.z, over the chunk's
// positions in stages of P1_ROWS
__global__ void __launch_bounds__(THREADS, P1_BLOCKS)
    ssd_chunk_states_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                            const float* __restrict__ A, const bf16* __restrict__ bm, Scratch sc,
                            Layout L, int P) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* bs = align_1024(smem_raw);     // (positions, N): D_c's A operand, MN-major
  uint8_t* xh = bs + bc_tile(P1_ROWS);    // (positions, P): the decayed xdt, hi
  uint8_t* xl = xh + x_tile(P1_ROWS);     // and lo
  float* ca = reinterpret_cast<float*>(xl + x_tile(P1_ROWS));
  float* dts = ca + MAX_Q;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int c0 = c * L.Q, len = min(L.Q, L.S - c0);
  const int g = h / (L.H / L.G);
  const int tid = threadIdx.x, m = tid / 128;  // warpgroup m: rows [64m, 64m + 64) of D_c
  const bf16* bb = bm + b * L.bm.b + g * L.bm.h + int64_t(c0) * L.bm.s;
  const bf16* xb = x + b * L.x.b + h * L.x.h + int64_t(c0) * L.x.s;
  if (tid < 32) chunk_cumsum(dt + b * L.dt.b + h * L.dt.h, L.dt.s, c0, len, A[h], dts, ca);
  __syncthreads();
  const float ca_last = ca[len - 1];
  const int64_t bh = int64_t(b) * L.H + h;
  if (tid == 0) sc.decays[bh * nc + c] = expf(ca_last);

  float acc[32];  // the first k-step overwrites it
  for (int r0 = 0; r0 < len; r0 += P1_ROWS) {
    if (r0 > 0) __syncthreads();  // every warpgroup's products of the last stage are done
    load_bc<P1_ROWS, THREADS>(bs, bb, L.bm.s, r0, len, L.N);
    XVecs<P1_ROWS, THREADS> raw;
    raw.load(xb, L.x.s, r0, len, P);
    // xdt_i e^{ca_last - ca_i}, xdt = x * dt rounded to bf16 (ssd_scan.py:117)
#pragma unroll
    for (int u = 0; u < raw.N; ++u) {
      const int idx = tid + u * THREADS, r = idx / 8, k = idx % 8, i = r0 + r;
      uint4 hi = make_uint4(0u, 0u, 0u, 0u), lo = hi;
      if (i < len && 8 * k < P) {
        const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw.v[u]);
        const float d = dts[i], w = expf(ca_last - ca[i]);
        uint32_t* hv = reinterpret_cast<uint32_t*>(&hi);
        uint32_t* lv = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(xv[e]);
          const float v0 = __bfloat162float(__float2bfloat16_rn(f.x * d)) * w;
          const float v1 = __bfloat162float(__float2bfloat16_rn(f.y * d)) * w;
          const __nv_bfloat162 hb = __floats2bfloat162_rn(v0, v1);
          hv[e] = *reinterpret_cast<const uint32_t*>(&hb);
          if (SPLIT_XD) {
            const float2 hf = __bfloat1622float2(hb);
            lv[e] = pack_bf16(v0 - hf.x, v1 - hf.y);
          }
        }
      }
      *reinterpret_cast<uint4*>(xh + sw_off(r, k, P1_ROWS)) = hi;
      if (SPLIT_XD) *reinterpret_cast<uint4*>(xl + sw_off(r, k, P1_ROWS)) = lo;
    }
    cp_async_wait_all();
    fence_to_async();
    __syncthreads();

    if (64 * m < L.N) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P1_ROWS / 16; ++kk) {  // rows past len are zero
        const uint64_t a = sw128_desc(bs + m * P1_ROWS * 128 + kk * 2048, P1_ROWS * 128, 1024);
        wgmma_ss<1, 1>(acc, a, sw128_desc(xh + kk * 2048, P1_ROWS * 128, 1024), r0 > 0 || kk > 0);
        if (SPLIT_XD) wgmma_ss<1, 1>(acc, a, sw128_desc(xl + kk * 2048, P1_ROWS * 128, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
    }
  }
  if (64 * m >= L.N) return;

  const int w = (tid % 128) / 32, lane = tid % 32, gq = lane / 4, t = lane % 4;
  float* dst = sc.states + (bh * nc + c) * L.N * P;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = 64 * m + 16 * w + gq + 8 * r;
    if (n >= L.N) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (8 * j < P)
        *reinterpret_cast<float2*>(dst + n * P + 8 * j + 2 * t) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// Phase 2: state_{c+1} = e^{ca_last,c} state_c + D_c: four entries of
// (N, P) a thread for head blockIdx.y, batch blockIdx.z; chunk c's entry
// of the scratch becomes its incoming state
__global__ void __launch_bounds__(THREADS)
    ssd_state_pass_kernel(Scratch sc, const float* __restrict__ st0, float* __restrict__ st_out,
                          Layout L, int P, int nc) {
  const int e = 4 * (blockIdx.x * THREADS + threadIdx.x);
  const int np = L.N * P;
  if (e >= np) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = int64_t(b) * L.H + h;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (st0 != nullptr) s = *reinterpret_cast<const float4*>(st0 + b * L.st0_b + h * L.st0_h + e);
  float* base = sc.states + bh * nc * np + e;
  bf16* base16 = sc.states16 + bh * nc * np + e;
  constexpr int AHEAD = 8;  // chunks whose D_c are loaded together
  for (int c0 = 0; c0 < nc; c0 += AHEAD) {
    float4 v[AHEAD];
    float d[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k)
      if (c0 + k < nc) {
        v[k] = *reinterpret_cast<const float4*>(base + int64_t(c0 + k) * np);
        d[k] = sc.decays[bh * nc + c0 + k];
      }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k)
      if (c0 + k < nc) {
        if (STATE_BF16)
          *reinterpret_cast<uint2*>(base16 + int64_t(c0 + k) * np) =
              make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
        else
          *reinterpret_cast<float4*>(base + int64_t(c0 + k) * np) = s;
        s = make_float4(fmaf(d[k], s.x, v[k].x), fmaf(d[k], s.y, v[k].y), fmaf(d[k], s.z, v[k].z),
                        fmaf(d[k], s.w, v[k].w));
      }
  }
  *reinterpret_cast<float4*>(st_out + b * L.sto_b + h * L.sto_h + e) = s;
}

// Phase 3: y of chunk blockIdx.x of heads HB blockIdx.y .. + HB - 1 (one
// group), batch blockIdx.z, from their incoming states (the scratch after
// phase 2); HB 2 shares the B and C tiles and each score tile C_i . B_j^T
// between two heads
template <int HB>
__global__ void __launch_bounds__(OUT_THREADS, 1)
    ssd_chunk_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ A, const bf16* __restrict__ bm,
                         const bf16* __restrict__ cm, Scratch sc, bf16* __restrict__ y, Layout L,
                         int P) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* cs = align_1024(smem_raw);  // (positions, N): A of both products, K-major
  uint8_t* bs = cs + bc_tile(MAX_Q);   // (positions, N): B of the scores, K-major
  uint8_t* xs = bs + bc_tile(MAX_Q);   // HB x (positions, P): xdt, MN-major B
  uint8_t* ss = xs + HB * x_tile(MAX_Q);  // HB x (N, P): the incoming states in bf16, MN-major B
  float* ca = reinterpret_cast<float*>(ss + HB * STATE_TILE);  // HB x MAX_Q

  const int c = blockIdx.x, h0 = HB * blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int c0 = c * L.Q, len = min(L.Q, L.S - c0);
  const int g = h0 / (L.H / L.G);
  const int tid = threadIdx.x;
  const int64_t bh0 = int64_t(b) * L.H + h0;
  const float* dtb = dt + b * L.dt.b + h0 * L.dt.h + int64_t(c0) * L.dt.s;
  load_bc<MAX_Q, OUT_THREADS>(cs, cm + b * L.cm.b + g * L.cm.h + int64_t(c0) * L.cm.s, L.cm.s, 0, len, L.N);
  load_bc<MAX_Q, OUT_THREADS>(bs, bm + b * L.bm.b + g * L.bm.h + int64_t(c0) * L.bm.s, L.bm.s, 0, len, L.N);
  XVecs<MAX_Q, OUT_THREADS> raw[HB];
#pragma unroll
  for (int hh = 0; hh < HB; ++hh) {
    const int64_t entry = ((bh0 + hh) * nc + c) * L.N * P;
    uint8_t* st_tile = ss + hh * STATE_TILE;
    if (STATE_BF16) {  // the state as phase 2 rounded it
      const bf16* st = sc.states16 + entry;
      for (int idx = tid; idx < MAX_N * 8; idx += OUT_THREADS) {
        const int n = idx / 8, k = idx % 8;
        const bool full = n < L.N && 8 * k < P;
        cp_async16(st_tile + sw_off(n, k, MAX_N), full ? st + n * P + 8 * k : st, full);
      }
    }
    raw[hh].load(x + b * L.x.b + (h0 + hh) * L.x.h + int64_t(c0) * L.x.s, L.x.s, 0, len, P);
    if (!STATE_BF16) {  // the state, rounded to bf16 here; its vectors loaded together
      constexpr int SV = (MAX_N * 8 + OUT_THREADS - 1) / OUT_THREADS;
      const float* st = sc.states + entry;
      float4 f[SV][2];
#pragma unroll
      for (int u = 0; u < SV; ++u) {
        const int idx = tid + u * OUT_THREADS, n = idx / 8, k = idx % 8;
        f[u][0] = f[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n < L.N && 8 * k < P) {
          f[u][0] = *reinterpret_cast<const float4*>(st + n * P + 8 * k);
          f[u][1] = *reinterpret_cast<const float4*>(st + n * P + 8 * k + 4);
        }
      }
#pragma unroll
      for (int u = 0; u < SV; ++u) {
        const int idx = tid + u * OUT_THREADS, n = idx / 8, k = idx % 8;
        if (n < MAX_N)
          *reinterpret_cast<uint4*>(st_tile + sw_off(n, k, MAX_N)) =
              make_uint4(pack_bf16(f[u][0].x, f[u][0].y), pack_bf16(f[u][0].z, f[u][0].w),
                         pack_bf16(f[u][1].x, f[u][1].y), pack_bf16(f[u][1].z, f[u][1].w));
      }
    }
  }
  if (tid / 32 < HB) {  // warp hh: head hh's cumsum of dA
    const int hh = tid / 32;
    chunk_cumsum<false>(dtb + hh * L.dt.h, L.dt.s, 0, len, A[h0 + hh], nullptr, ca + hh * MAX_Q);
  }
  // xdt = x * dt rounded to bf16 (ssd_scan.py:117): exact as an operand
#pragma unroll
  for (int hh = 0; hh < HB; ++hh) {
#pragma unroll
    for (int u = 0; u < raw[hh].N; ++u) {
      const int idx = tid + u * OUT_THREADS, r = idx / 8, k = idx % 8;
      if (r >= MAX_Q) break;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < len && 8 * k < P) {
        const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw[hh].v[u]);
        const float d = dtb[hh * L.dt.h + r * L.dt.s];
        uint32_t* out = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(xv[e]);
          out[e] = pack_bf16(f.x * d, f.y * d);
        }
      }
      *reinterpret_cast<uint4*>(xs + hh * x_tile(MAX_Q) + sw_off(r, k, MAX_Q)) = v;
    }
  }
  cp_async_wait_all();
  fence_to_async();
  __syncthreads();

  const int wg = tid / 128, w = (tid % 128) / 32, lane = tid % 32, gq = lane / 4, t = lane % 4;
  for (int pass = 0; pass < 2; ++pass) {
    const int ti = out_tile(wg, pass);
    if (ti < 0 || 64 * ti >= len) continue;
    const uint8_t* c_rows = cs + ti * 64 * 128;
    const int i0 = 64 * ti + 16 * w + gq;  // this thread's rows: i0 and i0 + 8

    // y = diag(e^{ca}) (C . state), a head at a time
    float acc[HB][32];  // the first k-step overwrites it
    float ca_i[HB][2];  // rows past len: ca_last, C zero
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        wgmma_ss<0, 1>(acc[hh], sw128_desc(c_rows + (kk / 4) * MAX_Q * 128 + (kk % 4) * 32, 16, 1024),
                       sw128_desc(ss + hh * STATE_TILE + kk * 2048, MAX_N * 128, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      pin(acc[hh]);
      ca_i[hh][0] = ca[hh * MAX_Q + i0];
      ca_i[hh][1] = ca[hh * MAX_Q + i0 + 8];
      const float e_i[2] = {expf(ca_i[hh][0]), expf(ca_i[hh][1])};
#pragma unroll
      for (int q = 0; q < 32; ++q) acc[hh][q] *= e_i[(q / 2) % 2];
    }

    // y += ((C B^T) o L) xdt over the column tiles at or below the diagonal
    for (int tj = 0; tj <= ti; ++tj) {
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        wgmma_ss<0, 0>(s, sw128_desc(c_rows + (kk / 4) * MAX_Q * 128 + (kk % 4) * 32, 16, 1024),
                       sw128_desc(bs + tj * 64 * 128 + (kk / 4) * MAX_Q * 128 + (kk % 4) * 32, 16, 1024),
                       kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      pin(s);
      // L masked before the exp (above the diagonal the exponent is
      // positive); the decayed scores rounded to bf16 as the A fragments of
      // the product with xdt (k-step kk: columns 16kk .. 16kk + 15)
      const bool diagonal = !FAST_DECAY || tj == ti;
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) {
        uint32_t pa[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e / 2, jj = 64 * tj + 8 * j + 2 * t + (e % 2);
            const bool keep = !diagonal || jj <= i0 + 8 * r;
            const float z = keep ? ca_i[hh][r] - ca[hh * MAX_Q + jj] : -INFINITY;
            v[e] = s[4 * j + e] * (FAST_DECAY ? ex2(z * LOG2E) : expf(z));
          }
          pa[j / 2][(j % 2) * 2] = pack_bf16(v[0], v[1]);
          pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(v[2], v[3]);
        }
        pin(pa);
        pin(acc[hh]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(acc[hh], pa[kk],
                   sw128_desc(xs + hh * x_tile(MAX_Q) + (64 * tj + 16 * kk) * 128, MAX_Q * 128, 1024));
        wgmma_commit();
        wgmma_wait_all();
        pin(acc[hh]);
        pin(pa);
      }
    }

    // y in bf16; rows past S and columns past P are not stored
#pragma unroll
    for (int hh = 0; hh < HB; ++hh)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + 8 * r;
        if (i >= len) continue;
        bf16* dst = y + b * L.y.b + (h0 + hh) * L.y.h + int64_t(c0 + i) * L.y.s + 2 * t;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (8 * j < P)
            *reinterpret_cast<uint32_t*>(dst + 8 * j) =
                pack_bf16(acc[hh][4 * j + 2 * r], acc[hh][4 * j + 2 * r + 1]);
      }
  }
}

// ------------------------------------------------------------------ host
// The dynamic shared-memory limit is an attribute of the current card's
// context: raise it once for each card a kernel is launched on (the call
// costs host time at every launch otherwise).
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

template <int P>
cudaError_t launch_f32(const void* x, const void* dt, const void* A, const void* bm, const void* cm,
                       const void* st0, void* y, void* st_out, const Layout& L,
                       cudaStream_t stream) {
  auto kern = ssd_scan_f32_kernel<P>;
  const size_t smem = f32_smem_bytes(L.N, P);
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(L.H, L.B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(bm), static_cast<const float*>(cm), static_cast<const float*>(st0),
      static_cast<float*>(y), static_cast<float*>(st_out), L);
  return cudaGetLastError();
}

// the three phases on one stream; `work` holds the Scratch: f32 states, bf16 states, decays
cudaError_t launch_bf16(const void* x, const void* dt, const void* A, const void* bm,
                        const void* cm, const void* st0, void* y, void* st_out, void* work,
                        const Layout& L, int P, cudaStream_t stream) {
  // cards whose shared-memory limit is raised, per kernel
  static std::atomic<uint64_t> sized_states{0}, sized_out1{0}, sized_out2{0};
  cudaError_t err = size_smem_once(reinterpret_cast<const void*>(ssd_chunk_states_kernel),
                                   int(STATES_SMEM), sized_states);
  if (err != cudaSuccess) return err;
  const bool pairs = HEADS_PER_BLOCK == 2 && (L.H / L.G) % 2 == 0;  // two heads of one group a block
  err = pairs ? size_smem_once(reinterpret_cast<const void*>(ssd_chunk_out_kernel<2>), int(out_smem(2)), sized_out2)
              : size_smem_once(reinterpret_cast<const void*>(ssd_chunk_out_kernel<1>), int(out_smem(1)), sized_out1);
  if (err != cudaSuccess) return err;
  const int nc = (L.S + L.Q - 1) / L.Q;
  float* states = static_cast<float*>(work);
  const int64_t entries = int64_t(L.B) * L.H * nc * L.N * P;
  const Scratch sc{states, reinterpret_cast<bf16*>(states + entries), states + entries + entries / 2};
  const bf16* xb = static_cast<const bf16*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const bf16* bb = static_cast<const bf16*>(bm);
  const dim3 chunks(nc, L.H, L.B);
  ssd_chunk_states_kernel<<<chunks, THREADS, STATES_SMEM, stream>>>(xb, dtf, af, bb, sc, L, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 pass((L.N * P / 4 + THREADS - 1) / THREADS, L.H, L.B);
  ssd_state_pass_kernel<<<pass, THREADS, 0, stream>>>(sc, static_cast<const float*>(st0),
                                                      static_cast<float*>(st_out), L, P, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bf16* cb = static_cast<const bf16*>(cm);
  bf16* yb = static_cast<bf16*>(y);
  if (pairs)
    ssd_chunk_out_kernel<2><<<dim3(nc, L.H / 2, L.B), OUT_THREADS, out_smem(2), stream>>>(
        xb, dtf, af, bb, cb, sc, yb, L, P);
  else
    ssd_chunk_out_kernel<1><<<chunks, OUT_THREADS, out_smem(1), stream>>>(xb, dtf, af, bb, cb, sc, yb, L, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt, A and the states
// are f32. st0 may be null (a zero initial state). P in {16, 32, 64},
// N a multiple of 16 up to 128, 1 <= Q <= 256. bf16 reads x, B and C in
// 16-byte vectors: 16-byte aligned data, strides in multiples of 8
// elements (the wrapper checks); st0 16-byte aligned with batch and head
// strides in multiples of 4; `work` holds B H n_chunks (3 N P / 2 + 1)
// f32, n_chunks = ceil(S / Q): the scratch of the three phases (unused in
// f32). Returns cudaGetLastError() after the launches (0 on success).
int repro_ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* bm,
                       const void* cm, const void* st0, void* y, void* st_out, int dtype, int B,
                       int H, int G, int S, int P, int N, int Q, int64_t x_sb, int64_t x_ss,
                       int64_t x_sh, int64_t dt_sb, int64_t dt_ss, int64_t dt_sh, int64_t b_sb,
                       int64_t b_ss, int64_t b_sg, int64_t c_sb, int64_t c_ss, int64_t c_sg,
                       int64_t y_sb, int64_t y_ss, int64_t y_sh, int64_t st0_sb, int64_t st0_sh,
                       int64_t sto_sb, int64_t sto_sh, void* stream, void* work) {
  if (B <= 0 || H <= 0 || G <= 0 || S <= 0 || H % G != 0 || N <= 0 || N % 16 != 0 ||
      N > MAX_N || Q <= 0 || Q > MAX_Q || (P != 16 && P != 32 && P != 64))
    return int(cudaErrorInvalidValue);
  const Layout L{B, H, G, S, N, Q,
                 {x_sb, x_ss, x_sh}, {dt_sb, dt_ss, dt_sh}, {b_sb, b_ss, b_sg},
                 {c_sb, c_ss, c_sg}, {y_sb, y_ss, y_sh},
                 st0_sb, st0_sh, sto_sb, sto_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (work == nullptr) return int(cudaErrorInvalidValue);
    return int(launch_bf16(x, dt, A, bm, cm, st0, y, st_out, work, L, P, st));
  }
  if (dtype != 0) return int(cudaErrorInvalidValue);
  switch (P) {
    case 16: return int(launch_f32<16>(x, dt, A, bm, cm, st0, y, st_out, L, st));
    case 32: return int(launch_f32<32>(x, dt, A, bm, cm, st0, y, st_out, L, st));
    default: return int(launch_f32<64>(x, dt, A, bm, cm, st0, y, st_out, L, st));
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
