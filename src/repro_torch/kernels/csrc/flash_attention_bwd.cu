// Flash-attention backward for Hopper (sm_90a), written by hand.
//
// What it replaces: no TPU kernel. The JAX package defines no custom VJP
// for its Pallas flash_attention (src/repro/kernels/flash_attention.py);
// it takes its attention gradient by differentiating the plain XLA
// layers._chunked_attention (src/repro/models/layers.py:314). The port's
// forward runs K1 (flash_attention.cu), so its gradient needs a kernel of
// its own: this one. It computes dQ, dK and dV of repro_torch.kernels.
// ref.mha for a causal and/or sliding-window mask (no softcap), from the
// forward's saved output O and row log-sum-exp:
//   P  = 2^(scale log2(e) Q K^T - lse2)  (masked entries 0; lse2 is the
//        forward's base-2 log-sum-exp, see flash_attention.cu),
//   Di = rowsum(dO o O) in f32,  dV = P^T dO,  dS = P o (dO V^T - Di),
//   dQ = scale dS K,  dK = scale dS^T Q.
// One base, 2, runs through the forward and the backward.
//
// Layout. q, o, do, dq are (B, S, H, D) and k, v, dk, dv (B, S, Kv, D) in
// memory, or any batch / sequence / head strides with a unit head_dim
// stride; query head h reads kv head h / (H / Kv). Head dims 64 and 128.
//
// Bound. Five products of 2 D operations a (query, key) pair and head
// (S and dP recomputed, dV, dQ, dK) against the forward's two: 10 D H
// operations an unmasked pair. At the training shape (4, 1024, 32 / 4,
// 128), causal, that is 8.6e10 operations, 0.087 ms at 989 TFLOP/s; the
// bytes (q, k, v, o, do, lse in; dq, dk, dv out) are 0.02 ms at 3.35 TB/s.
// So the bound is the tensor cores' rate.
//
// Design: simple and deterministic first; making it fast is later work.
//  - Three kernels a call, in order on the caller's stream: Di on its own
//    (a warp a row), then dK/dV, then dQ.
//  - dK/dV: one block per (64-key tile, kv head, batch), four warps of 16
//    keys. The block walks the query tiles of EVERY query head of its GQA
//    group (8 on yi-6b) and sums dK and dV in registers, so no atomics and
//    no scratch. Query tiles the mask rules out for the whole key tile are
//    never visited.
//  - dQ: one block per (64-query tile, head, batch), four warps of 16
//    queries, walking the key tiles the mask allows, dQ in registers.
//  - bf16: every product is Ampere's mma.sync.m16n8k16 (bf16 in, f32
//    accumulate) on tiles in padded shared memory (row stride D + 8, so
//    ldmatrix reads no bank twice), loaded with 16-byte vector loads and
//    no overlap of loads and products. P and dS enter their products
//    rounded to bf16 from the f32 accumulator, whose layout is mma's
//    register-A layout. Queries a dK/dV step: 64 at D 64, 32 at D 128, so
//    the dK and dV accumulators (2 x 16 x D f32 a warp) fit in registers.
//  - f32 (the checks at f32 precision): the products run as f32 FMAs on
//    the CUDA cores, 256 threads each holding a 4 x 4 block of scores and
//    4 x (D / 16) of an accumulator, as the forward's f32 kernel does; the
//    tensor cores' TF32 would not hold f32's tolerance.
//  - The ragged S edge: rows past S load as zeros and score as masked;
//    nothing past S is stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int TILE = 64;  // keys a dK/dV block, queries a dQ block, keys a dQ step

struct Strides {
  int64_t b, s, h;  // element strides; head_dim stride is 1
};

struct Mask {
  int S, causal, window;

  __device__ __forceinline__ bool ok(int qi, int kj) const {
    if (qi >= S || kj >= S) return false;
    if (causal && kj > qi) return false;
    return !(window > 0 && kj <= qi - window);
  }
  // the first and last query that may see a key of [k0, k0 + TILE)
  __device__ __forceinline__ int2 queries(int k0) const {
    const int k_last = min(k0 + TILE, S) - 1;
    const int lo = causal ? k0 : 0;
    const int hi = window > 0 ? min(S - 1, k_last + window - 1) : S - 1;
    return make_int2(lo, hi);
  }
  // the key tiles some query of [q0, q0 + TILE) may see
  __device__ __forceinline__ int2 key_tiles(int q0) const {
    const int q_last = min(q0 + TILE, S) - 1;
    const int hi = causal ? q_last / TILE : (S - 1) / TILE;
    const int lo = window > 0 ? max(0, q0 - window + 1) / TILE : 0;
    return make_int2(lo, hi);
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// ------------------------------------------------------------------- Di
// delta[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d] in f32; a warp a row
template <typename T>
__global__ void delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                             float* __restrict__ delta, Strides so, Strides sdo, int H, int S,
                             int D, int64_t rows) {
  const int64_t row = int64_t(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int i = int(row % S), h = int((row / S) % H), b = int(row / (int64_t(S) * H));
  const T* orow = o + b * so.b + h * so.h + i * so.s;
  const T* drow = dout + b * sdo.b + h * sdo.h + i * sdo.s;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f(orow[c]), to_f(drow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ------------------------------------------------ bf16: mma.sync building blocks
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += A (16 x 16, row-major fragments) . B (16 x 8, column fragments b0, b1).
// Accumulator element e of lane 4g + t: row g + 8 (e / 2), column 2t + e % 2.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; -inf gives 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Addresses of ldmatrix.x4 for a 16 x 16 block at (r0, c0) of a row-major
// tile with row stride ld:
//  - as an A operand (rows are A's rows): a0..a3;
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int ld, int r0, int c0, int lane) {
  return tile + (r0 + lane % 8 + 8 * ((lane / 8) % 2)) * ld + c0 + 8 * (lane / 16);
}
//  - as the B operand of two 8-column n-tiles whose columns are the tile's
//    rows r0 .. r0 + 15 (B = tile^T, k along the tile's columns):
//    {b0, b1} of n-tile r0 and of n-tile r0 + 8;
__device__ __forceinline__ const bf16* bt_addr(const bf16* tile, int ld, int r0, int c0, int lane) {
  return tile + (r0 + lane % 8 + 8 * (lane / 16)) * ld + c0 + 8 * ((lane / 8) % 2);
}
//  - with .trans, as the B operand of two n-tiles at columns c0 and c0 + 8
//    of the tile (k along the tile's rows r0 .. r0 + 15).
__device__ __forceinline__ const bf16* bn_addr(const bf16* tile, int ld, int r0, int c0, int lane) {
  return tile + (r0 + lane % 8 + 8 * ((lane / 8) % 2)) * ld + c0 + 8 * (lane / 16);
}

// rows [row0, row0 + rows) of a (S, D) bf16 view with row stride `st` into a
// padded tile; rows past S read as zero. 16-byte loads: the wrapper checks
// a 16-byte aligned base and strides in multiples of 8 elements.
template <int D, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t st, int row0, int rows,
                                          int S) {
  constexpr int LD = D + 8, VEC = D / 8;
  for (int idx = threadIdx.x; idx < rows * VEC; idx += THREADS) {
    const int r = idx / VEC, c = (idx % VEC) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * st + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int D>
struct Bf16Tiles {
  static constexpr int LD = D + 8;                // padded row, bf16
  static constexpr int BQ = D == 128 ? 32 : 64;   // queries a dK/dV step
  static constexpr size_t SMEM_KV = 2 * size_t(2 * TILE * LD + 2 * BQ * LD) + 2 * 4 * BQ;
  static constexpr size_t SMEM_Q = 2 * size_t(4 * TILE * LD);
};

// ------------------------------------------------------------ bf16: dK, dV
template <int D>
__global__ void __launch_bounds__(128)
    dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq, Strides sk,
                     Strides sv, Strides sdo, Strides sdk, Strides sdv, int H, int rep, Mask mask,
                     float scale, float scale_log2) {
  using T = Bf16Tiles<D>;
  constexpr int LD = T::LD, BQ = T::BQ, NT = BQ / 8, DT = D / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + TILE * LD;
  bf16* qs = vs + TILE * LD;
  bf16* dos = qs + BQ * LD;
  float* lse_s = reinterpret_cast<float*>(dos + BQ * LD);
  float* dl_s = lse_s + BQ;

  const int S = mask.S;
  const int k0 = blockIdx.x * TILE, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int kw = 16 * warp;  // this warp's key rows in the tile
  load_tile<D, 128>(ks, k + b * sk.b + hk * sk.h, sk.s, k0, TILE, S);
  load_tile<D, 128>(vs, v + b * sv.b + hk * sv.h, sv.s, k0, TILE, S);

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  const int2 qr = mask.queries(k0);
  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    const bf16* qh = q + b * sq.b + h * sq.h;
    const bf16* doh = dout + b * sdo.b + h * sdo.h;
    const float* lse_h = lse + (int64_t(b) * H + h) * S;
    const float* dl_h = delta + (int64_t(b) * H + h) * S;
    for (int q0 = (qr.x / BQ) * BQ; q0 <= qr.y; q0 += BQ) {
      __syncthreads();  // the previous step's tiles are no longer read
      load_tile<D, 128>(qs, qh, sq.s, q0, BQ, S);
      load_tile<D, 128>(dos, doh, sdo.s, q0, BQ, S);
      for (int i = threadIdx.x; i < BQ; i += 128) {
        const int qi = q0 + i;
        lse_s[i] = qi < S ? lse_h[qi] : INFINITY;
        dl_s[i] = qi < S ? dl_h[qi] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BQ queries
      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        ldsm_x4(ak, a_addr(ks, LD, kw, 16 * kk, lane));
        ldsm_x4(av, a_addr(vs, LD, kw, 16 * kk, lane));
#pragma unroll
        for (int np = 0; np < BQ / 16; ++np) {
          uint32_t bq[4], bd[4];
          ldsm_x4(bq, bt_addr(qs, LD, 16 * np, 16 * kk, lane));
          ldsm_x4(bd, bt_addr(dos, LD, 16 * np, 16 * kk, lane));
          mma(st[2 * np], ak, bq[0], bq[1]);
          mma(st[2 * np + 1], ak, bq[2], bq[3]);
          mma(dpt[2 * np], av, bd[0], bd[1]);
          mma(dpt[2 * np + 1], av, bd[2], bd[3]);
        }
      }
      // P^T and dS^T in place
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + kw + g + 8 * (e / 2), qc = 8 * j + 2 * t + (e % 2);
          const float p = mask.ok(q0 + qc, kj) ? ex2(st[j][e] * scale_log2 - lse_s[qc]) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - dl_s[qc]);
        }
      // dV += P^T dO and dK += dS^T Q (scale applied at the end)
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t ap[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                                pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                                pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                                pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        const uint32_t as[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                                pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                                pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                                pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          uint32_t bd[4], bq[4];
          ldsm_x4_t(bd, bn_addr(dos, LD, 16 * kk, 16 * nd, lane));
          ldsm_x4_t(bq, bn_addr(qs, LD, 16 * kk, 16 * nd, lane));
          mma(dva[2 * nd], ap, bd[0], bd[1]);
          mma(dva[2 * nd + 1], ap, bd[2], bd[3]);
          mma(dka[2 * nd], as, bq[0], bq[1]);
          mma(dka[2 * nd + 1], as, bq[2], bq[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + kw + g + 8 * r;
    if (kj >= S) continue;
    bf16* dkr = dk + b * sdk.b + hk * sdk.h + kj * sdk.s + 2 * t;
    bf16* dvr = dv + b * sdv.b + hk * sdv.h + kj * sdv.s + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<uint32_t*>(dkr + 8 * j) =
          pack_bf16(dka[j][2 * r] * scale, dka[j][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvr + 8 * j) = pack_bf16(dva[j][2 * r], dva[j][2 * r + 1]);
    }
  }
}

// ----------------------------------------------------------------- bf16: dQ
template <int D>
__global__ void __launch_bounds__(128)
    dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo,
                   Strides sdq, int H, int rep, Mask mask, float scale, float scale_log2) {
  using T = Bf16Tiles<D>;
  constexpr int LD = T::LD, NT = TILE / 8, DT = D / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + TILE * LD;
  bf16* ks = dos + TILE * LD;
  bf16* vs = ks + TILE * LD;

  const int S = mask.S;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / rep;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int qw = 16 * warp;
  load_tile<D, 128>(qs, q + b * sq.b + h * sq.h, sq.s, q0, TILE, S);
  load_tile<D, 128>(dos, dout + b * sdo.b + h * sdo.h, sdo.s, q0, TILE, S);
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + qw + g + 8 * r;
    lse_r[r] = qi < S ? lse[(int64_t(b) * H + h) * S + qi] : INFINITY;
    dl_r[r] = qi < S ? delta[(int64_t(b) * H + h) * S + qi] : 0.f;
  }
  float dqa[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  const bf16* kh = k + b * sk.b + hk * sk.h;
  const bf16* vh = v + b * sv.b + hk * sv.h;
  const int2 kt = mask.key_tiles(q0);
  for (int it = kt.x; it <= kt.y; ++it) {
    const int k0 = it * TILE;
    __syncthreads();  // the previous key tile is no longer read
    load_tile<D, 128>(ks, kh, sk.s, k0, TILE, S);
    load_tile<D, 128>(vs, vh, sv.s, k0, TILE, S);
    __syncthreads();

    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ad[4];
      ldsm_x4(aq, a_addr(qs, LD, qw, 16 * kk, lane));
      ldsm_x4(ad, a_addr(dos, LD, qw, 16 * kk, lane));
#pragma unroll
      for (int np = 0; np < TILE / 16; ++np) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, bt_addr(ks, LD, 16 * np, 16 * kk, lane));
        ldsm_x4(bv, bt_addr(vs, LD, 16 * np, 16 * kk, lane));
        mma(sc[2 * np], aq, bk[0], bk[1]);
        mma(sc[2 * np + 1], aq, bk[2], bk[3]);
        mma(dp[2 * np], ad, bv[0], bv[1]);
        mma(dp[2 * np + 1], ad, bv[2], bv[3]);
      }
    }
    // dS in place of the scores
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + qw + g + 8 * (e / 2), kj = k0 + 8 * j + 2 * t + (e % 2);
        const float p = mask.ok(qi, kj) ? ex2(sc[j][e] * scale_log2 - lse_r[e / 2]) : 0.f;
        sc[j][e] = p * (dp[j][e] - dl_r[e / 2]);
      }
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      const uint32_t as[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bk[4];
        ldsm_x4_t(bk, bn_addr(ks, LD, 16 * kk, 16 * nd, lane));
        mma(dqa[2 * nd], as, bk[0], bk[1]);
        mma(dqa[2 * nd + 1], as, bk[2], bk[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + qw + g + 8 * r;
    if (qi >= S) continue;
    bf16* dst = dq + b * sdq.b + h * sdq.h + qi * sdq.s + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(dqa[j][2 * r] * scale, dqa[j][2 * r + 1] * scale);
  }
}

// --------------------------------------------------------- f32, CUDA cores
constexpr int F32_THREADS = 256;  // 16 row groups x 16 column groups

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int64_t st, int row0,
                                              int S) {
  constexpr int KP = D + 1;
  for (int idx = threadIdx.x; idx < TILE * D; idx += F32_THREADS) {
    const int r = idx / D, c = idx % D;
    dst[r * KP + c] = row0 + r < S ? src[(row0 + r) * st + c] : 0.f;
  }
}

template <int D>
constexpr size_t f32_smem_kv() {  // K, V, Q, dO tiles, P^T and dS^T, lse and Di
  return sizeof(float) * (4 * size_t(TILE) * (D + 1) + 2 * size_t(TILE) * (TILE + 1) + 2 * TILE);
}
template <int D>
constexpr size_t f32_smem_q() {  // Q, dO, K, V tiles, dS, lse and Di
  return sizeof(float) * (4 * size_t(TILE) * (D + 1) + size_t(TILE) * (TILE + 1) + 2 * TILE);
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv, Strides sq, Strides sk,
                    Strides sv, Strides sdo, Strides sdk, Strides sdv, int H, int rep, Mask mask,
                    float scale, float scale_log2) {
  constexpr int KP = D + 1, PP = TILE + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + TILE * KP;
  float* qs = vs + TILE * KP;
  float* dos = qs + TILE * KP;
  float* ps = dos + TILE * KP;  // P^T: key x query
  float* dss = ps + TILE * PP;  // dS^T
  float* lse_s = dss + TILE * PP;
  float* dl_s = lse_s + TILE;

  const int S = mask.S;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;  // keys ty + 16 i; queries / columns tx + 16 j
  const int k0 = blockIdx.x * TILE, hk = blockIdx.y, b = blockIdx.z;
  load_tile_f32<D>(ks, k + b * sk.b + hk * sk.h, sk.s, k0, S);
  load_tile_f32<D>(vs, v + b * sv.b + hk * sv.h, sv.s, k0, S);

  float dka[4][DC], dva[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int2 qr = mask.queries(k0);
  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    const float* lse_h = lse + (int64_t(b) * H + h) * S;
    const float* dl_h = delta + (int64_t(b) * H + h) * S;
    for (int q0 = (qr.x / TILE) * TILE; q0 <= qr.y; q0 += TILE) {
      __syncthreads();
      load_tile_f32<D>(qs, q + b * sq.b + h * sq.h, sq.s, q0, S);
      load_tile_f32<D>(dos, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S);
      if (tid < TILE) {
        const int qi = q0 + tid;
        lse_s[tid] = qi < S ? lse_h[qi] : INFINITY;
        dl_s[tid] = qi < S ? dl_h[qi] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = ks[(ty + 16 * i) * KP + d];
          vv[i] = vs[(ty + 16 * i) * KP + d];
          qv[i] = qs[(tx + 16 * i) * KP + d];
          ov[i] = dos[(tx + 16 * i) * KP + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kr = ty + 16 * i, qc = tx + 16 * j;
          const float p = mask.ok(q0 + qc, k0 + kr) ? exp2f(s[i][j] * scale_log2 - lse_s[qc]) : 0.f;
          ps[kr * PP + qc] = p;
          dss[kr * PP + qc] = p * (dp[i][j] - dl_s[qc]);
        }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < TILE; ++qq) {
        float pv[4], sv_[4], ov[DC], qv[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = ps[(ty + 16 * i) * PP + qq];
          sv_[i] = dss[(ty + 16 * i) * PP + qq];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          ov[c] = dos[qq * KP + tx + 16 * c];
          qv[c] = qs[qq * KP + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dva[i][c] = fmaf(pv[i], ov[c], dva[i][c]);
            dka[i][c] = fmaf(sv_[i], qv[c], dka[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[b * sdk.b + hk * sdk.h + kj * sdk.s + tx + 16 * c] = dka[i][c] * scale;
      dv[b * sdv.b + hk * sdv.h + kj * sdv.s + tx + 16 * c] = dva[i][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo,
                  Strides sdq, int H, int rep, Mask mask, float scale, float scale_log2) {
  constexpr int KP = D + 1, PP = TILE + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + TILE * KP;
  float* ks = dos + TILE * KP;
  float* vs = ks + TILE * KP;
  float* dss = vs + TILE * KP;  // dS: query x key
  float* lse_s = dss + TILE * PP;
  float* dl_s = lse_s + TILE;

  const int S = mask.S;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;  // queries ty + 16 i; keys / columns tx + 16 j
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / rep;
  load_tile_f32<D>(qs, q + b * sq.b + h * sq.h, sq.s, q0, S);
  load_tile_f32<D>(dos, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S);
  if (tid < TILE) {
    const int qi = q0 + tid;
    lse_s[tid] = qi < S ? lse[(int64_t(b) * H + h) * S + qi] : INFINITY;
    dl_s[tid] = qi < S ? delta[(int64_t(b) * H + h) * S + qi] : 0.f;
  }
  float dqa[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dqa[i][c] = 0.f;

  const int2 kt = mask.key_tiles(q0);
  for (int it = kt.x; it <= kt.y; ++it) {
    const int k0 = it * TILE;
    __syncthreads();
    load_tile_f32<D>(ks, k + b * sk.b + hk * sk.h, sk.s, k0, S);
    load_tile_f32<D>(vs, v + b * sv.b + hk * sv.h, sv.s, k0, S);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty + 16 * i) * KP + d];
        ov[i] = dos[(ty + 16 * i) * KP + d];
        kv[i] = ks[(tx + 16 * i) * KP + d];
        vv[i] = vs[(tx + 16 * i) * KP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = ty + 16 * i, kc = tx + 16 * j;
        const float p = mask.ok(q0 + qr, k0 + kc) ? exp2f(s[i][j] * scale_log2 - lse_s[qr]) : 0.f;
        dss[qr * PP + kc] = p * (dp[i][j] - dl_s[qr]);
      }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < TILE; ++kk) {
      float dsv[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = ks[kk * KP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) dqa[i][c] = fmaf(dsv[i], kv[c], dqa[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[b * sdq.b + h * sdq.h + qi * sdq.s + tx + 16 * c] = dqa[i][c] * scale;
  }
}

// ------------------------------------------------------------------ host
// The dynamic shared-memory limit is an attribute of the current card's
// context: raise it once for each card a kernel is launched on.
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

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int B, H, KV;
  Mask mask;
  float scale;
};

template <typename T>
cudaError_t launch_delta(const Args& a, int D, cudaStream_t stream) {
  const int64_t rows = int64_t(a.B) * a.H * a.mask.S;
  constexpr int WARPS = 8;
  delta_kernel<T><<<unsigned((rows + WARPS - 1) / WARPS), 32 * WARPS, 0, stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, a.so, a.sdo, a.H,
      a.mask.S, D, rows);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  using T = Bf16Tiles<D>;
  cudaError_t err = launch_delta<bf16>(a, D, stream);
  if (err != cudaSuccess) return err;
  const int S = a.mask.S, tiles = (S + TILE - 1) / TILE, rep = a.H / a.KV;
  const float scale_log2 = a.scale * LOG2E;
  static std::atomic<uint64_t> sized_kv{0}, sized_q{0};
  auto kv = dkdv_bf16_kernel<D>;
  err = size_smem_once(reinterpret_cast<const void*>(kv), int(T::SMEM_KV), sized_kv);
  if (err != cudaSuccess) return err;
  kv<<<dim3(tiles, a.KV, a.B), 128, T::SMEM_KV, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), a.lse, a.delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.H, rep, a.mask, a.scale,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto qk = dq_bf16_kernel<D>;
  err = size_smem_once(reinterpret_cast<const void*>(qk), int(T::SMEM_Q), sized_q);
  if (err != cudaSuccess) return err;
  qk<<<dim3(tiles, a.H, a.B), 128, T::SMEM_Q, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), a.lse, a.delta, static_cast<bf16*>(a.dq), a.sq, a.sk,
      a.sv, a.sdo, a.sdq, a.H, rep, a.mask, a.scale, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  cudaError_t err = launch_delta<float>(a, D, stream);
  if (err != cudaSuccess) return err;
  const int S = a.mask.S, tiles = (S + TILE - 1) / TILE, rep = a.H / a.KV;
  const float scale_log2 = a.scale * LOG2E;
  static std::atomic<uint64_t> sized_kv{0}, sized_q{0};
  auto kv = dkdv_f32_kernel<D>;
  err = size_smem_once(reinterpret_cast<const void*>(kv), int(f32_smem_kv<D>()), sized_kv);
  if (err != cudaSuccess) return err;
  kv<<<dim3(tiles, a.KV, a.B), F32_THREADS, f32_smem_kv<D>(), stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv,
      a.H, rep, a.mask, a.scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto qk = dq_f32_kernel<D>;
  err = size_smem_once(reinterpret_cast<const void*>(qk), int(f32_smem_q<D>()), sized_q);
  if (err != cudaSuccess) return err;
  qk<<<dim3(tiles, a.H, a.B), F32_THREADS, f32_smem_q<D>(), stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dq), a.sq, a.sk, a.sv, a.sdo, a.sdq, a.H, rep, a.mask, a.scale,
      scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(int dtype, const Args& a, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<D>(a, stream);
  if (dtype == 1) return launch_bf16<D>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 24 element strides, (batch,
// sequence, head) of q, k, v, o, do, dq, dk and dv in that order. lse is
// the forward's contiguous (B, H, S) base-2 log-sum-exp; delta a (B, H, S)
// f32 scratch the call fills. window <= 0 means none. bf16 loads 16 bytes
// at a time: 16-byte aligned data, strides multiples of 8 elements (the
// wrapper checks). Launches three kernels on `stream`; returns
// cudaGetLastError() after the last launch that ran (0 on success).
int repro_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const float* lse, float* delta, void* dq, void* dk,
                              void* dv, int dtype, int B, int H, int KV, int S, int D,
                              const int64_t* strides, float scale, int causal, int window,
                              void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || H % KV != 0) return int(cudaErrorInvalidValue);
  const int64_t* s = strides;
  Args a{q, k, v, o, dout, lse, delta, dq, dk, dv,
         Strides{s[0], s[1], s[2]}, Strides{s[3], s[4], s[5]}, Strides{s[6], s[7], s[8]},
         Strides{s[9], s[10], s[11]}, Strides{s[12], s[13], s[14]}, Strides{s[15], s[16], s[17]},
         Strides{s[18], s[19], s[20]}, Strides{s[21], s[22], s[23]},
         B, H, KV, Mask{S, causal, window}, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return int(dispatch<64>(dtype, a, st));
    case 128:
      return int(dispatch<128>(dtype, a, st));
    default:
      return int(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
