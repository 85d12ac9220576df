// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_attn_kernel, l.34; flash_attention, l.115) and computes what it and
// repro.kernels.ref.mha compute: scores q.k / sqrt(D), optional softcap
// cap*tanh(s/cap), causal mask k <= q and window mask k > q - window set
// to -1e30, online softmax with the running max, denominator and
// accumulator in f32, and a row whose denominator is 0 writes 0. In bf16
// the weights p enter the PV product rounded to bf16, as the model's own
// attention rounds its softmax weights (repro/models/layers.py:366); the
// denominator sums the unrounded p.
//
// Layout. q and o are (B, S, H, D) and k, v are (B, S, Kv, D) in memory
// (the model's layout); the caller passes element strides for batch,
// sequence and head, and the head_dim stride must be 1. Query head h
// reads kv head h / (H / Kv): GQA needs no repeated copy of K/V. Head
// dims 64, 128 and 256 (recurrentgemma's local attention, window 2048).
//
// Shared design. A loop over key tiles inside each block takes the place
// of the TPU grid's sequential kv axis; tiles the causal or window mask
// rules out entirely are never visited (the Pallas kernel's
// pl.when(needed)). S need not divide a tile: keys past S score -inf (they
// add exactly 0 even while a row's running max is still the -1e30 mask
// value) and rows past S are not stored.
//
// Bound. At the serving shapes (S 512 to 3000, D 128 or 256) the work is
// 4*D flops per unmasked (query, key) pair and head against 2*D*(2H +
// 2Kv) bytes a position: yi-6b at S 2000 does 32.8 GFLOP on 21 MB
// (0.033 ms at 989 TFLOP/s against 0.006 ms at 3.35 TB/s),
// recurrentgemma's wave 265 GFLOP on 55 MB (0.268 against 0.016 ms). Far
// above the card's ridge: the bound is the tensor cores' rate, and the
// design is about keeping them fed.
//
// bf16 (the serving path). It replaces a first version built on Ampere's
// mma.sync.m16n8k16, with K and V staged through registers behind two
// __syncthreads a key tile, Q re-read from shared memory at every k-step
// and every score taken through the mask; that version ran at 12% of its
// bound at yi-6b's S 2000 and 17% on recurrentgemma's wave. Here:
//  - Blocks. One block per (query tile, head, batch): a producer
//    warpgroup and CONSUMERS warpgroups of 64 query rows each (Tiles<D>).
//    The grid's slowest axis is the query tile, last tile first, so that
//    the causal blocks with the most key tiles start first across all
//    heads and batches.
//  - Loads. One thread of the producer brings Q once, then each key
//    tile's K and V through a ring of STAGES slots in shared memory with
//    TMA (cp.async.bulk.tensor, 128-byte swizzle, 64-column boxes, since
//    a box row of a 128-byte swizzle holds at most 64 bf16). Each slot's
//    K and V have their own full (transaction-count) and free mbarriers,
//    so K is refilled as soon as its S product is done. Tensor maps are
//    encoded on the host at each call from the caller's strides (4-d: D,
//    S, heads, batch), so a box past S comes back zero-filled and never
//    reads the next head; GQA picks kv head h / rep by coordinate.
//    setmaxnreg hands the producer's registers to the consumers.
//  - Products. S = Q.K^T is wgmma.mma_async with both operands in shared
//    memory (K-major). P is rounded to bf16 in registers, where the
//    accumulator layout of S is wgmma's register-A layout, and O += P.V
//    is wgmma with A from registers and the (keys, D) V tile as the
//    MN-major B operand.
//  - Softmax in base 2, scale * log2(e) folded into one multiply (the
//    softcap, when set, on every tile before the fold); the causal,
//    window and ragged-edge masks only on tiles that straddle an edge.
//  - Refinements, each a named constant below so that
//    scripts/torch_kernel_ab.py --ablate can build the kernel without it
//    and time both in turns (PERF.md): OVERLAP (a warpgroup issues tile
//    i's S before tile i-1's PV and runs tile i's softmax while the PV
//    runs) and PINGPONG (the two consumer warpgroups take turns to issue
//    their products, so that one's softmax runs under the other's).
//  - Measured choices (scripts/torch_kernel_ab.py on the H100, PERF.md):
//    128-row query tiles at every D, since 64-row ones (one consumer
//    warpgroup, twice the blocks) were 14-40% slower on the card at every
//    path shape, yi-6b's S 512 (128 blocks on 132 SMs) too. Not measured
//    against alternatives: two ring slots, the fewest that let a tile's
//    loads run under the previous tile's products; key tiles of 128 at D
//    64 / 128 and of 64 at D 256, where the 64 x 256 f32 O accumulator
//    takes 128 registers a thread.
// What is left between the kernel and its bound (it reaches 42% of it at
// yi-6b's S 2000) is not measured apart: the softmax's exp2 work, the
// causal blocks' unequal lengths and the epilogue's stores are the
// candidates. At yi-6b's S 512 and 1000 a call takes longer to issue
// from Python than the kernel runs.
//
// ptxas (sm_90a, CUDA 12.8): bf16 at D 64, 128 and 256 launches at 168
// registers a thread (setmaxnreg then gives the producer 40 and the
// consumers 232), no spills, 16 barriers (the ping-pong's are named at run
// time); dynamic shared memory 83,016 / 164,936 / 197,704 bytes, one
// block an SM. f32 (unchanged): 80 / 112 / 127 registers, no spills.
//
// f32 (the checks at 2e-5): the products run as f32 FMAs on the CUDA
// cores, 256 threads each holding a 4x4 block of scores and a 4x(D/16)
// block of the accumulator; the tensor cores' TF32 would not hold 2e-5.
//
// Row log-sum-exp for the backward (flash_attention_bwd.cu). With a
// non-null `lse` (a contiguous (B, H, S) f32 tensor) both paths also write
// each row's log-sum-exp in BASE 2 of its scores in base-2 units:
// lse2 = log2(sum_k 2^(s_k log2 e)) for the scaled (and capped, masked)
// score s_k, so that the backward recovers p = 2^(s log2 e - lse2). The
// bf16 path keeps its running max in those units already (m + log2 l);
// the f32 path converts its natural-base max and sum ((m + ln l) log2 e).
// A row whose denominator is 0 gets +inf, which makes every p of it 0 in
// the backward; rows past S are not stored. With lse == null nothing else
// changes: the serving path's output is the same to the bit.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched from the driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BQ = 64;  // f32 path: queries per block
constexpr int BK = 64;  // f32 path: keys per tile
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  int64_t b, s, h;  // element strides; head_dim stride is 1
};

struct Mask {
  int S, causal, window;
  float scale, softcap;

  // the score of (query qi, key kj) after scale, softcap and masks
  __device__ __forceinline__ float apply(float dot, int qi, int kj) const {
    float x = dot * scale;
    if (softcap > 0.f) x = softcap * tanhf(x / softcap);
    bool ok = true;
    if (causal) ok = kj <= qi;
    if (window > 0) ok = ok && kj > qi - window;
    x = ok ? x : MASKED;
    return kj < S ? x : -INFINITY;  // past the ragged edge: no key at all
  }

  // the TK-key tiles some query in [q0, q0 + TQ) may attend to
  template <int TQ = BQ, int TK = BK>
  __device__ __forceinline__ int2 key_tiles(int q0) const {
    const int q_last = min(q0 + TQ, S) - 1;
    const int hi = causal ? q_last / TK : (S - 1) / TK;
    const int lo = window > 0 ? max(0, q0 - window + 1) / TK : 0;
    return make_int2(lo, hi);
  }

  // whether every (query, key) pair of the 64 rows from qw and the keys
  // [k0, k0 + TK) is kept: no causal, window or ragged edge crosses them
  template <int TK>
  __device__ __forceinline__ bool interior(int qw, int k0) const {
    const int q_last = min(qw + 63, S - 1);
    if (k0 + TK > S) return false;
    if (causal && k0 + TK - 1 > qw) return false;
    return !(window > 0 && k0 <= q_last - window);
  }
};

// ------------------------------------------------------------ f32, CUDA cores
constexpr int F32_THREADS = 256;  // 16 row groups x 16 column groups

// max / sum over the 16 lanes that share a row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D +
                          size_t(BQ) * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, float* __restrict__ o,
                               float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                               Strides so, int rep, Mask mask) {
  constexpr int KP = D + 1;   // padded row stride of the Q and K tiles
  constexpr int PP = BK + 1;  // padded row stride of the P tile
  constexpr int DC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;           // BQ x KP
  float* ks = qs + BQ * KP;   // BK x KP
  float* vs = ks + BK * KP;   // BK x D
  float* ps = vs + BK * D;    // BQ x PP

  const int S = mask.S;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty + 16 i
  const int tx = tid % 16;  // score columns tx + 16 j, output columns tx + 16 c
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + (h / rep) * sk.h;
  const float* vb = v + b * sv.b + (h / rep) * sv.h;
  float* ob = o + b * so.b + h * so.h;

  for (int idx = tid; idx < BQ * D; idx += F32_THREADS) {
    const int r = idx / D, c = idx % D;
    const int qi = q0 + r;
    qs[r * KP + c] = qi < S ? qb[qi * sq.s + c] : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int2 kt_range = mask.key_tiles(q0);
  for (int kt = kt_range.x; kt <= kt_range.y; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < BK * D; idx += F32_THREADS) {
      const int r = idx / D, c = idx % D;
      const int kj = k0 + r;
      ks[r * KP + c] = kj < S ? kb[kj * sk.s + c] : 0.f;
      vs[r * D + c] = kj < S ? vb[kj * sv.s + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * KP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * KP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = mask.apply(s[i][j], qi, k0 + tx + 16 * j);
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(row_max));
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = corr * l[i] + group_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * PP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < DC; ++c) ob[qi * so.s + tx + 16 * c] = acc[i][c] / safe;
    if (lse != nullptr && tx == 0)
      lse[(int64_t(b) * gridDim.y + h) * S + qi] = l[i] == 0.f ? INFINITY : (m[i] + logf(l[i])) * LOG2E;
  }
}

// ------------------------------------------------- bf16: Hopper primitives
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

// arrive once and add `bytes` to the transactions the current phase awaits
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// spin until the phase of parity `parity` has completed (a fresh barrier
// counts its phase of parity 1 as completed)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one (64 columns x rows) box of a 4-d tensor map into shared memory,
// completing on `bar`; coordinates innermost first
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor of a tile in 128-byte-swizzled atoms (8
// rows x 128 B, 1024-byte aligned, as TMA writes them). A K-major operand
// steps 16 columns by adding 32 bytes to the start address (`lbo` unused);
// for an MN-major one `lbo` is the distance between 64-column atom
// columns and `sbo` between 8-row groups along K.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= uint64_t((lbo >> 4) & 0x3FFF) << 16;
  d |= uint64_t((sbo >> 4) & 0x3FFF) << 32;
  d |= uint64_t(1) << 62;  // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of the warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pin registers that an asynchronous wgmma reads or writes, so that the
// compiler neither moves nor reads them across its issue or its wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
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

// The wgmma shapes the kernel issues. Accumulator element 4j + 2r + c of a
// thread (warp w, lane 4g + t of its warpgroup) is row 16w + g + 8r,
// column 8j + 2t + c of the 64 x N tile.
// d (+)= A . B^T for a 64 x 64 tile: A (64 x 16) and B (64 x 16) from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A . B^T for a 64 x 128 tile: A (64 x 16) and B (128 x 16) from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A . B for a 64 x 64 tile: A (64 x 16 bf16) from registers, B (16 x 64) from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A . B for a 64 x 128 tile: A (64 x 16 bf16) from registers, B (16 x 128) from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ------------------------------------------------------ bf16: the kernel
// Refinements over the plain pipeline; scripts/torch_kernel_ab.py --ablate
// builds the kernel with each set to false and times it (PERF.md).
constexpr bool OVERLAP = true;   // tile i's softmax runs under tile i-1's PV
constexpr bool PINGPONG = true;  // the two consumer warpgroups take turns to issue

template <int D>
struct Tiles {
  static constexpr int CONSUMERS = 2;                // warpgroups of 64 query rows
  static constexpr int BM = 64 * CONSUMERS;          // queries a block
  static constexpr int BN = D == 256 ? 64 : 128;     // keys a tile: S's accumulator beside O's
  static constexpr int STAGES = 2;                   // K/V ring slots
  static constexpr int ON = D == 256 ? 128 : D;      // O columns a PV wgmma
  static constexpr int OH = D / ON;                  // PV wgmmas a k-step
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  static constexpr uint32_t Q_BYTES = BM * D * 2;
  static constexpr uint32_t KV_BYTES = BN * D * 2;   // one K or V tile
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 4 * STAGES);
  // with two consumers, 384 threads launch at 168 registers; setmaxnreg
  // moves the producer's share to the consumers (128 x 40 + 256 x 232)
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
};

// one arrival on `bar` from each warp of the calling warpgroup
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// Shared memory: Q, then STAGES K tiles, then STAGES V tiles, then the
// barriers. A (rows, D) tile is D / 64 atom columns of rows x 128 B each,
// as TMA writes a 64-column box with 128-byte swizzle.
template <int D>
__global__ void __launch_bounds__(Tiles<D>::THREADS, 1)
    flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                                float* __restrict__ lse, Strides so, int rep, Mask mask,
                                float scale_log2) {
  using T = Tiles<D>;
  constexpr int BM = T::BM, BN = T::BN, ST = T::STAGES, ON = T::ON, OH = T::OH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* ks = qs + T::Q_BYTES;
  uint8_t* vs = ks + ST * T::KV_BYTES;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(vs + ST * T::KV_BYTES);
  uint64_t* full_k = full_q + 1;  // a slot's K (or V) tile has landed
  uint64_t* full_v = full_k + ST;
  uint64_t* free_k = full_v + ST;  // every consumer warp is done with it
  uint64_t* free_v = free_k + ST;

  const int S = mask.S;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int h = blockIdx.x, b = blockIdx.y;
  const int2 kt = mask.key_tiles<BM, BN>(q0);
  const int n_tiles = kt.y - kt.x + 1;  // visited from kt.y down to kt.x
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&free_k[s], 4 * T::CONSUMERS);  // one arrival per consumer warp
      mbar_init(&free_v[s], 4 * T::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full
    if constexpr (T::CONSUMERS == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, T::Q_BYTES);
#pragma unroll
      for (int d = 0; d < D / 64; ++d) tma_load(qs + d * BM * 128, &tq, full_q, d * 64, q0, h, b);
      const int hk = h / rep;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        const uint32_t free_parity = ((i / ST) & 1) ^ 1;
        const int k0 = (kt.y - i) * BN;
        mbar_wait(&free_k[s], free_parity);
        mbar_expect_tx(&full_k[s], T::KV_BYTES);
#pragma unroll
        for (int d = 0; d < D / 64; ++d)
          tma_load(ks + s * T::KV_BYTES + d * BN * 128, &tk, &full_k[s], d * 64, k0, hk, b);
        mbar_wait(&free_v[s], free_parity);
        mbar_expect_tx(&full_v[s], T::KV_BYTES);
#pragma unroll
        for (int d = 0; d < D / 64; ++d)
          tma_load(vs + s * T::KV_BYTES + d * BN * 128, &tv, &full_v[s], d * 64, k0, hk, b);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns the query rows qw .. qw + 63
    if constexpr (T::CONSUMERS == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::CONSUMER_REGS));
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int qw = q0 + 64 * cw;
    const int qi0 = qw + 16 * warp + g;  // this thread's rows: qi0 and qi0 + 8
    const uint8_t* q_rows = qs + cw * 64 * 128;

    float acc[OH][ON / 2];  // O: column 8j + 2t + c of row r in acc[j / (ON / 8)][4 (j % (ON / 8)) + 2r + c]
#pragma unroll
    for (int x = 0; x < OH; ++x)
#pragma unroll
      for (int y = 0; y < ON / 2; ++y) acc[x][y] = 0.f;
    float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};  // l: this thread's share of the row
    uint32_t pa[BN / 16][4];  // p of the tile whose PV is next, as wgmma's A fragments

    // S = Q . K^T of the K tile in slot `slot`: D / 16 k-steps
    auto issue_s = [&](float (&sc)[BN / 2], int slot) {
      const uint64_t da = sw128_desc(q_rows, 16, 1024);
      const uint64_t db = sw128_desc(ks + slot * T::KV_BYTES, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // descriptor addresses count 16-byte units
        const uint64_t a = da + (kk / 4) * (BM * 8) + (kk % 4) * 2;
        const uint64_t bb = db + (kk / 4) * (BN * 8) + (kk % 4) * 2;
        if constexpr (BN == 128)
          wgmma_ss_n128(sc, a, bb, kk > 0);
        else
          wgmma_ss_n64(sc, a, bb, kk > 0);
      }
      wgmma_commit();
    };
    // O += P . V of the V tile in slot `slot`: BN / 16 k-steps of 16 keys
    auto issue_pv = [&](int slot) {
      const uint64_t db = sw128_desc(vs + slot * T::KV_BYTES, BN * 128, 1024);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int x = 0; x < OH; ++x) {
          const uint64_t bb = db + x * (ON / 64) * (BN * 8) + kk * 128;
          if constexpr (ON == 128)
            wgmma_rs_n128(acc[x], pa[kk], bb);
          else
            wgmma_rs_n64(acc[x], pa[kk], bb);
        }
      wgmma_commit();
    };
    // the tile's scores into p (in place, base 2), the running max and sum;
    // leaves each row's correction of the earlier tiles in corr
    auto softmax = [&](float (&sc)[BN / 2], int k0, float (&corr)[2]) {
      if (mask.softcap > 0.f) {
        const float inv_cap = mask.scale / mask.softcap, cap_log2 = mask.softcap * LOG2E;
#pragma unroll
        for (int x = 0; x < BN / 2; ++x) sc[x] = cap_log2 * tanhf(sc[x] * inv_cap);
      } else {
#pragma unroll
        for (int x = 0; x < BN / 2; ++x) sc[x] *= scale_log2;
      }
      if (!mask.interior<BN>(qw, k0)) {  // the per-element mask only where an edge crosses
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = qi0 + 8 * (e / 2), kj = k0 + 8 * j + 2 * t + (e % 2);
            bool ok = true;
            if (mask.causal) ok = kj <= qi;
            if (mask.window > 0) ok = ok && kj > qi - mask.window;
            const float x = ok ? sc[4 * j + e] : MASKED;
            sc[4 * j + e] = kj < S ? x : -INFINITY;
          }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int x = 0; x < BN / 2; ++x) mx[(x / 2) % 2] = fmaxf(mx[(x / 2) % 2], sc[x]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad share a row
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int x = 0; x < BN / 2; ++x) {
        sc[x] = ex2(sc[x] - m[(x / 2) % 2]);
        l[(x / 2) % 2] += sc[x];
      }
    };
    // p rounded to bf16 as wgmma's A fragments: k-step kk of the PV covers
    // the score column blocks 2kk and 2kk + 1
    auto pack_p = [&](const float (&sc)[BN / 2]) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        pa[j / 2][(j % 2) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
      }
    };
    // PINGPONG: warpgroup cw waits on named barrier 1 + cw before it
    // issues and then lets the other one issue. Both walk the same key
    // tiles, n_tiles + 1 turns each; a tile that adds nothing to a
    // warpgroup's rows is masked whole (its weights vanish once the row
    // meets its first kept key). Warpgroup 0 goes first.
    auto my_turn = [&]() {
      if constexpr (PINGPONG && T::CONSUMERS == 2)
        asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
    };
    auto their_turn = [&]() {
      if constexpr (PINGPONG && T::CONSUMERS == 2)
        asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
    };
    if (cw == 1) their_turn();

    mbar_wait(full_q, 0);
    {  // the first tile: its S alone
      float sc[BN / 2], corr[2];
      mbar_wait(&full_k[0], 0);
      my_turn();
      wgmma_fence();
      issue_s(sc, 0);
      their_turn();
      wgmma_wait<0>();
      pin(sc);
      warp_arrive(&free_k[0]);
      softmax(sc, kt.y * BN, corr);
      pack_p(sc);
    }
    for (int i = 1; i < n_tiles; ++i) {
      // tile i's S and tile i-1's PV in one turn
      const int s = i % ST, prev = (i - 1) % ST;
      float sc[BN / 2], corr[2];
      mbar_wait(&full_k[s], (i / ST) & 1);
      mbar_wait(&full_v[prev], ((i - 1) / ST) & 1);
      my_turn();
      pin(pa);
#pragma unroll
      for (int x = 0; x < OH; ++x) pin(acc[x]);
      wgmma_fence();
      issue_s(sc, s);
      issue_pv(prev);
      their_turn();
      wgmma_wait<OVERLAP ? 1 : 0>();  // S is done; with OVERLAP the PV may still run
      pin(sc);
      warp_arrive(&free_k[s]);
      softmax(sc, (kt.y - i) * BN, corr);
      wgmma_wait<0>();  // the PV is done: its V slot and pa are free
#pragma unroll
      for (int x = 0; x < OH; ++x) pin(acc[x]);
      pin(pa);
      warp_arrive(&free_v[prev]);
#pragma unroll
      for (int x = 0; x < OH; ++x)
#pragma unroll
        for (int y = 0; y < ON / 2; ++y) acc[x][y] *= corr[(y / 2) % 2];
      pack_p(sc);
    }
    {  // the last tile's PV alone
      const int last = n_tiles - 1;
      mbar_wait(&full_v[last % ST], (last / ST) & 1);
      my_turn();
      pin(pa);
#pragma unroll
      for (int x = 0; x < OH; ++x) pin(acc[x]);
      wgmma_fence();
      issue_pv(last % ST);
      if (cw == 0) their_turn();  // warpgroup 1's last turn: nobody waits for it
      wgmma_wait<0>();
#pragma unroll
      for (int x = 0; x < OH; ++x) pin(acc[x]);
      pin(pa);
    }

    // O = acc / l, rows past S not stored; a quad writes 16 bytes of a row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = qi0 + 8 * r;
      if (qi >= S) continue;
      const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
      bf16* dst = o + b * so.b + h * so.h + qi * so.s + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int x = j / (ON / 8), y = 4 * (j % (ON / 8)) + 2 * r;
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(acc[x][y] * inv, acc[x][y + 1] * inv);
      }
      if (lse != nullptr && t == 0)  // m is in base-2 units already
        lse[(int64_t(b) * gridDim.x + h) * S + qi] = l[r] == 0.f ? INFINITY : m[r] + log2f(l[r]);
    }
  }
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so the
// library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a bf16 (D, S, heads, B) view with the caller's element
// strides (innermost first), read in boxes of 64 columns x `rows` with
// 128-byte swizzle; elements past an extent read as zero. TMA takes
// strides that are positive multiples of 16 bytes (the wrapper checks); a
// dimension of extent 1 is never stepped, so its stride is replaced by one
// that TMA takes, whatever the caller's.
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int heads, int B, Strides st,
              int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(heads), cuuint64_t(B)};
  cuuint64_t strides[3] = {cuuint64_t(st.s) * 2, cuuint64_t(st.h) * 2, cuuint64_t(st.b) * 2};
  cuuint64_t any = cuuint64_t(D) * 2;
  for (int i = 0; i < 3; ++i)
    if (dims[i + 1] > 1 && strides[i] > any) any = strides[i];
  for (int i = 0; i < 3; ++i)
    if (dims[i + 1] == 1) strides[i] = any;
  const cuuint32_t box[4] = {64, cuuint32_t(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, Strides sq,
                        Strides sk, Strides sv, Strides so, int B, int H, int KV, Mask mask,
                        cudaStream_t stream) {
  using T = Tiles<D>;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, D, mask.S, H, B, sq, T::BM) ||
      !make_map(&mk, k, D, mask.S, KV, B, sk, T::BN) ||
      !make_map(&mv, v, D, mask.S, KV, B, sv, T::BN))
    return cudaErrorInvalidValue;
  auto kern = flash_attention_bf16_kernel<D>;
  static std::atomic<uint64_t> sized{0};  // the cards whose shared-memory limit is raised
  const cudaError_t err = size_smem_once(reinterpret_cast<const void*>(kern), int(T::SMEM), sized);
  if (err != cudaSuccess) return err;
  // the query tile is the slowest axis: each wave of blocks mixes heads
  const dim3 grid(H, B, (mask.S + T::BM - 1) / T::BM);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(mq, mk, mv, static_cast<bf16*>(o), lse, so, H / KV,
                                              mask, mask.scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, Strides sq,
                       Strides sk, Strides sv, Strides so, int B, int H, int rep, Mask mask,
                       cudaStream_t stream) {
  auto kern = flash_attention_f32_kernel<D>;
  const size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((mask.S + BQ - 1) / BQ, H, B);
  kern<<<grid, F32_THREADS, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                            static_cast<const float*>(v), static_cast<float*>(o), lse,
                                            sq, sk, sv, so, rep, mask);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16
template <int D>
cudaError_t dispatch(int dtype, const void* q, const void* k, const void* v, void* o, float* lse,
                     Strides sq,
                     Strides sk, Strides sv, Strides so, int B, int H, int KV, Mask mask,
                     cudaStream_t stream) {
  if (dtype == 0) return launch_f32<D>(q, k, v, o, lse, sq, sk, sv, so, B, H, H / KV, mask, stream);
  if (dtype == 1) return launch_bf16<D>(q, k, v, o, lse, sq, sk, sv, so, B, H, KV, mask, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. window <= 0 and softcap <= 0 mean none.
// lse: null, or a contiguous (B, H, S) f32 output of each row's base-2
// log-sum-exp (see the note at the top).
// bf16 reads through TMA: 16-byte aligned data, strides positive multiples
// of 8 elements where the extent is above 1 (the wrapper checks). Returns
// cudaGetLastError() after the launch (0 on success).
int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                              int dtype,
                              int B, int H, int KV, int S, int D, int64_t q_sb, int64_t q_ss,
                              int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                              int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
                              int64_t o_ss, int64_t o_sh, float scale, int causal, int window,
                              float softcap, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || H % KV != 0) return int(cudaErrorInvalidValue);
  const Strides sq{q_sb, q_ss, q_sh}, sk{k_sb, k_ss, k_sh}, sv{v_sb, v_ss, v_sh},
      so{o_sb, o_ss, o_sh};
  const Mask mask{S, causal, window, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return int(dispatch<64>(dtype, q, k, v, o, lse, sq, sk, sv, so, B, H, KV, mask, st));
    case 128:
      return int(dispatch<128>(dtype, q, k, v, o, lse, sq, sk, sv, so, B, H, KV, mask, st));
    case 256:
      return int(dispatch<256>(dtype, q, k, v, o, lse, sq, sk, sv, so, B, H, KV, mask, st));
    default:
      return int(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
