// Flash-attention backward for Hopper (sm_90a), written by hand.
//
// What it replaces: no TPU kernel. The JAX package defines no custom VJP
// for its Pallas flash_attention (src/repro/kernels/flash_attention.py);
// it takes its attention gradient by differentiating the plain XLA
// layers._chunked_attention (src/repro/models/layers.py:314). The port's
// forward runs K1 (flash_attention.cu), so its gradient needs a kernel of
// its own: this one. It computes dQ, dK and dV of repro_torch.kernels.
// ref.mha for a causal and/or sliding-window mask, from the forward's
// saved output O and row log-sum-exp:
//   P  = 2^(scale log2(e) Q K^T - lse2)  (masked entries 0; lse2 is the
//        forward's base-2 log-sum-exp, see flash_attention.cu),
//   Di = rowsum(dO o O) in f32,  dV = P^T dO,  dS = P o (dO V^T - Di),
//   dQ = scale dS K,  dK = scale dS^T Q.
// One base, 2, runs through the forward and the backward.
// With a softcap (gemma2-2b: 50, head dim 256 only) the score is capped
// before the mask, as in the forward and in JAX (layers.py:356-357): with
// t = tanh(scale Q K^T / cap) and the capped score c = cap t,
//   P  = 2^(cap log2(e) t - lse2),  dS = P o (dO V^T - Di) o (1 - t^2),
// and dQ, dK as above (dc/ds = scale (1 - t^2)). t is computed as the
// forward computes it (tanhf of the same product), so P meets the lse2 the
// forward wrote; the kernels keep no t: where P is made they fold 1 - t^2
// into the value dS takes in its place (P o (1 - t^2)), and in dK/dV round
// P itself to bf16 for dV's product on the way. The cap is a template
// parameter (CAP), so the instances without it run no code of it.
//
// Layout. q, o, do, dq are (B, S, H, D) and k, v, dk, dv (B, S, Kv, D) in
// memory, or any batch / sequence / head strides with a unit head_dim
// stride; query head h reads kv head h / (H / Kv). Head dims 64, 128 and
// 256 (recurrentgemma-9b's local attention, 16 / 1 heads, window 2048).
//
// Bound. Five products of 2 D operations a (query, key) pair and head
// (S and dP recomputed, dV, dQ, dK) against the forward's two: 10 D H
// operations an unmasked pair. At the training shape (4, 1024, 32 / 4,
// 128), causal, that is 8.6e10 operations, 0.087 ms at 989 TFLOP/s; the
// bytes (q, k, v, o, do, lse in; dq, dk, dv out) are 0.02 ms at 3.35 TB/s.
// So the bound is the tensor cores' rate.
//
// bf16 (the training path). It replaces a first version on Ampere's
// mma.sync with no overlap of loads and products, four warps a block and
// dK/dV blocks that each walked all 8 query heads of a GQA group (1.064 ms
// at the training shape, 8% of the bound). Here every product is wgmma and
// every tile comes by TMA (64 x 64 boxes, 128-byte swizzle, 4-d tensor maps
// (D, S, heads, B) encoded at each call from the caller's strides, so a
// box past S reads zeros). Two kernels a call and, with a GQA split, a
// short pass, in order on the caller's stream:
//  - dQ (and Di): the forward's skeleton. A block per (128-query tile,
//    head, batch), last tile first; a producer thread brings Q and dO once
//    and 128-key K / V tiles through a two-slot ring (full / free
//    mbarriers, V freed as soon as dP is done); two consumer warpgroups of
//    64 query rows compute S = Q K^T and dP = dO V^T from shared memory, P
//    and dS in registers, and dQ += dS K with the K tile as the MN-major B
//    operand. setmaxnreg gives the producer 24 registers, the consumers 240.
//  - dK/dV: a block per (128 keys, kv head, head group, batch), key tile 0
//    first under the causal mask (the most queries see it). K and V come
//    once; a producer warp streams 64-query steps through a two-slot ring
//    (Q and dO by TMA, lse2 and Di copied by its lanes). Each of two
//    consumer warpgroups owns 64 keys: S^T = K Q^T and dP^T = V dO^T from
//    shared memory, P^T and dS^T in registers (rounded to bf16 as wgmma's
//    A fragments: the accumulator layout is the register-A layout), dV +=
//    P^T dO and dK += dS^T Q with the dO and Q tiles as MN-major B operands,
//    so one swizzled tile serves both its uses.
//  - The GQA split: a kv head's rep query heads go to G = the largest
//    divisor of rep up to GQA_SPLIT blocks (yi-6b: 8 heads, G 2: 256 dK/dV
//    blocks on 132 SMs instead of 128, whose longest would walk 128 steps).
//    With G > 1 each block stores its f32 partial dK and dV, and
//    reduce_dkdv_kernel adds the G partials in the order g = 0 .. G - 1:
//    the same bits at every call, no atomics.
//  - Masks: tiles the mask rules out are never visited; the per-element
//    mask only on a tile an edge crosses. Queries past S carry lse2 = +inf
//    (P = 0), keys past S are masked, nothing past S is stored.
//  - dQ stays a kernel of its own (S and dP computed again: 7 products a
//    pair, not the bound's 5, 0.1217 ms at the training shape at best):
//    folding it into dK/dV would sum dQ across key tiles, which needs
//    atomics or an ordered reduction across blocks.
// Named refinements and choices, each measured on and off at the training
// shape by scripts/torch_kernel_ab.py --kernel attention_bwd --ablate
// (medians of 4 processes, NVIDIA H100 80GB HBM3, 700 W; all 0.3729 ms,
// graph 0.3614: dK/dV 171.8 us, dQ 178.5, the pass 12.8):
//  - FUSED_DI: each dQ consumer computes its rows' Di = rowsum(dO o O)
//    from global memory under its first tile's products and stores it for
//    dK/dV (it adds 23.6 us to dQ; a pass of its own takes 37.3): off
//    0.3868 ms.
//  - STAGGER: S and dP (S^T and dP^T) are two wgmma groups, P is computed
//    while dP runs, and in dK/dV dV is issued before dS^T is computed:
//    off 0.3750 ms.
//  - GQA_SPLIT 2: 1 gives 0.4596 ms, 4 0.3962, 8 0.4558 (the pass grows
//    with G: 27.4 / 52.4 us).
//  - KV_CONSUMERS 2 (128-key dK/dV blocks): 1 gives 0.4515 ms.
//  - DQ_KEYS 128: 64-key dQ tiles give 0.3753 ms.
//  Measured slower and left out (PERF.md, Findings): the consumer warpgroups
//  taking turns to issue (the forward's PINGPONG); dQ issuing a tile's S
//  and dP with the previous tile's dQ; the G blocks as a cluster summing
//  through distributed shared memory in place of the pass.
// Head dim 256. At the tiles above neither kernel fits: a dK/dV
// warpgroup's dK and dV of 64 keys at 64 x 256 f32 are 256 registers a
// thread, and dQ's Q and dO of 128 rows (64 KB each) beside a two-slot
// ring of 128-key K / V tiles are 384 KB of shared memory. So at D 256:
//  - dK/dV: both consumer warpgroups take the block's same 64 keys and
//    each holds one D half of dK and dV (128 registers); each computes S^T
//    and dP^T over all of D itself (a third more products in this kernel)
//    and takes its half of the Q and dO tiles as the MN-major B operands.
//    K, V and a two-slot Q / dO ring are 198,696 bytes. With one kv head
//    (rep 16) the GQA split is GQA_SPLIT_D256: at the training call
//    (4, 1024, 16/1, 256) 4 x 16 key tiles x G blocks, 256 at G 4, where
//    G 2's 128 would leave the longest block 128 of the card's 8,704 steps.
//  - dQ: 64-key K / V tiles and a one-slot ring (197,672 bytes; V is
//    freed as soon as dP is done, so the next V loads under dQ's
//    product), the 64 x 256 dQ accumulator as two n128 wgmmas a k-step.
//  The softcap (CAP) runs in these D 256 tiles only: one tanhf, a
//  multiply-add and a multiply more an element where P is made. At
//  gemma2's call (4, 1024, 8/4, 256), causal: 0.3156 ms with a cap of 50
//  against 0.2558 without (dK/dV 165.9 us against 119.8: both of its
//  warpgroups make P of the same tile, so each tanhf runs twice there;
//  dQ 111.0 against 100.4); with tanh.approx.f32 0.2617 ms, but P would
//  no longer meet the forward's lse2 (scripts/torch_kernel_ab.py --kernel
//  attention_bwd --variants fast_tanh; H100 80GB HBM3, 700 W).
//  At the training call (4, 1024, 16/1, 256), causal, window 2048: 0.3988
//  ms (dK/dV 190.2 us, dQ 186.1, the pass 10.9), 22% of the 0.0869 ms
//  bound; GQA_SPLIT_D256 2 gives 0.5308 ms (dK/dV 328.0 us), 8 gives
//  0.4288 (the pass 26.3 us) (scripts/torch_kernel_ab.py --kernel
//  attention_bwd --variants split_d256_2,split_d256_8; H100 80GB HBM3,
//  700 W). f32 at D 256 takes tiles of 32 rows (f32_rows).
// Queries and keys of different lengths (whisper-tiny's cross attention,
// the decoder's Sq tokens over the encoder's Sk = 1500 frames) come without
// a mask, as the forward takes them: Di, lse2, the dQ grid and its rows run
// over Sq; the dK/dV grid, its key bound, the partials and the reduction
// over Sk; q and dO are tensor maps over Sq, k and v over Sk. With no mask
// every key tile sees every query and every query row keeps all Sk keys.
// A query offset (context parallelism, as the forward takes it) moves the
// dQ blocks' key-tile walks, the dK/dV blocks' query walks (a key block no
// query sees walks none and writes dK = dV = 0) and the interior tests by
// qoff. Per element, the dK/dV kernels test the query's position (their
// callers add qoff once a query step), the dQ kernels compare a key's
// distance past the query's index with qoff (the f32 one a tile's diagonal
// with 0): a query position held in a dQ kernel's register made ptxas
// spill 4-16 bytes in three of them. Queries past Sq are left to their lse2
// of +inf (p 0), so the hot loops test no more than before.
// Scratch beyond Di (the wrapper sizes it by
// repro_flash_attention_bwd_scratch): with G > 1 the partials, G x 2 x B x
// Sk x Kv x D f32, 33.5 MB at the training shape, written once and read
// once (at least 0.020 ms at 3.35 TB/s; the pass measures 12.8 us, the
// partials partly in L2).
// ptxas (sm_90a, CUDA 12.8): dQ and dK/dV at D 64, 128 and 256 launch at
// 168 registers (setmaxnreg then 24 / 240), no spills; dynamic shared
// memory dK/dV 198,696 / 133,160 / 67,624 bytes and dQ 197,672 / 197,704 /
// 99,400 at D 256 / 128 / 64, one block an SM; the pass 32 registers; the
// f32 kernels at D 256 80 (dQ) and 126 (dK/dV) registers, no spills.
//
// f32 (the checks at f32 precision): the products run as f32 FMAs on the
// CUDA cores, 256 threads each holding a 4 x 4 block of scores and 4 x
// (D / 16) of an accumulator, as the forward's f32 kernel does; the tensor
// cores' TF32 would not hold f32's tolerance. Its Di is a pass of its own
// (a warp a row).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched from the driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int TILE = 64;  // f32: keys a dK/dV block, queries a dQ block, keys a dQ step

struct Strides {
  int64_t b, s, h;  // element strides; head_dim stride is 1
};

// Sq queries and Sk keys; query i sits at position qoff + i and key j at
// j. With a causal mask, a window or an offset the queries lie within the
// keys (qoff + Sq <= Sk, the wrapper checks); without, the lengths are free.
struct Mask {
  int Sq, Sk, causal, window, qoff;

  // whether query qi (at position qoff + qi) sees key kj (the dQ kernels'
  // test: no position held a row). A query past Sq needs no test here: its
  // lse2 is +inf, so its p is 0 and its dS 0
  __device__ __forceinline__ bool ok(int qi, int kj) const {
    if (kj >= Sk) return false;
    const int dk = kj - qi;  // the key's distance past the query's index
    if (causal && dk > qoff) return false;
    return !(window > 0 && dk <= qoff - window);
  }
  // the same for the query at position qp (the dK/dV kernels' test: their
  // callers add qoff once a query step)
  __device__ __forceinline__ bool ok_at(int qp, int kj) const {
    if (kj >= Sk) return false;
    if (causal && kj > qp) return false;
    return !(window > 0 && kj <= qp - window);
  }
  // the first and last query that may see a key of [k0, k0 + TK); lo > hi
  // where none does (under a causal mask, the keys past the last query)
  template <int TK = TILE>
  __device__ __forceinline__ int2 queries(int k0) const {
    const int k_last = min(k0 + TK, Sk) - 1;
    const int lo = causal ? max(0, k0 - qoff) : 0;
    const int hi = window > 0 ? min(Sq - 1, k_last + window - 1 - qoff) : Sq - 1;
    return make_int2(lo, hi);
  }
  // the TK-key tiles some query of [q0, q0 + TQ) may see
  template <int TQ = TILE, int TK = TILE>
  __device__ __forceinline__ int2 key_tiles(int q0) const {
    const int q_last = min(q0 + TQ, Sq) - 1 + qoff;  // positions
    const int hi = causal ? min(q_last, Sk - 1) / TK : (Sk - 1) / TK;
    const int lo = window > 0 ? max(0, q0 + qoff - window + 1) / TK : 0;
    return make_int2(lo, hi);
  }
  // whether every pair of the 64 query rows from qw and the keys [k0, k0 +
  // TK) is kept (rows past Sq aside: their lse2 is +inf)
  template <int TK>
  __device__ __forceinline__ bool interior(int qw, int k0) const {
    const int q_last = min(qw + 63, Sq - 1) + qoff;
    if (k0 + TK > Sk) return false;
    if (causal && k0 + TK - 1 > qw + qoff) return false;
    return !(window > 0 && k0 <= q_last - window);
  }
  // the same for the 64 keys from kw and the queries [q0, q0 + TQ) (queries
  // past Sq aside: their lse2 is +inf)
  template <int TQ>
  __device__ __forceinline__ bool interior_keys(int kw, int q0) const {
    if (kw + 64 > Sk) return false;
    if (causal && kw + 63 > q0 + qoff) return false;
    return !(window > 0 && kw <= min(q0 + TQ, Sq) - 1 + qoff - window);
  }
};

// The softcap's constants, computed on the host as the forward computes
// them on the device (flash_attention.cu's softmax and Mask::apply): inv =
// scale / cap and log2 = cap log2(e) (bf16), cap itself (f32, whose
// forward caps the scaled score). Unused by the instances without a cap.
struct Cap {
  float inv, log2, cap;
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

// ------------------------------------------------- bf16: Hopper primitives
// A copy of flash_attention.cu:301-445 (mbarriers, TMA, the shared-memory
// descriptor, the wgmma wrappers): each source builds alone.
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
template <int M, int N>
__device__ __forceinline__ void pin(float (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) pin(r[i]);
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

// The wgmma shapes the kernels issue. Accumulator element 4j + 2r + c of a
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

// ------------------------------------------------------ bf16: the kernels
// d (+)= A . B^T of a 64 x N tile, both operands K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate) {
  if constexpr (N == 128)
    wgmma_ss_n128(d, a, b, accumulate);
  else
    wgmma_ss_n64(d, a, b, accumulate);
}
// d += A . B of a 64 x N tile, A from registers, B MN-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 128)
    wgmma_rs_n128(d, a, b);
  else
    wgmma_rs_n64(d, a, b);
}

// A (rows, D) tile in shared memory is D / 64 atom columns of rows x 128 B,
// as TMA writes 64-column boxes with 128-byte swizzle. The descriptor of
// 16-column k-step kk of a K-major operand that starts at `desc` in a tile
// of R rows (descriptor addresses count 16-byte units):
template <int R>
__device__ __forceinline__ uint64_t k_step(uint64_t desc, int kk) {
  return desc + (kk / 4) * (R * 8) + (kk % 4) * 2;
}

// rows [row0, row0 + R) of head `head`, batch b into a tile of R rows: R / 64
// x D / 64 boxes of 64 x 64 (a box past S reads zeros and counts its bytes)
template <int R, int D>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map, uint64_t* bar, int row0,
                                          int head, int b) {
#pragma unroll
  for (int d = 0; d < D / 64; ++d)
#pragma unroll
    for (int r = 0; r < R / 64; ++r)
      tma_load(dst + d * R * 128 + r * 64 * 128, map, bar, d * 64, row0 + 64 * r, head, b);
}

// p = 2^(s scale log2(e) - lse2) of the 64 x N scores in place (0 where
// the mask drops the pair), as wgmma accumulators whose element 4j + 2r +
// c is at (row0 + 8r, col0 + 8j + 2t + c). ROW_Q says whether rows are
// queries (dQ, row0 the query index) or keys (dK/dV, the transposed
// products, col0 the query position); lse2 comes from the caller per
// element.
template <int N, bool ROW_Q, typename Lse>
__device__ __forceinline__ void probs(float (&sc)[N / 2], const Mask& mask, bool interior, int row0, int col0,
                                      int t, float scale_log2, Lse lse_of) {
#pragma unroll
  for (int x = 0; x < N / 2; ++x) {
    const int r = (x / 2) % 2, c = 8 * (x / 4) + 2 * t + (x % 2);
    const float p = ex2(sc[x] * scale_log2 - lse_of(r, c));
    const bool ok = interior || (ROW_Q ? mask.ok(row0 + 8 * r, col0 + c) : mask.ok_at(col0 + c, row0 + 8 * r));
    sc[x] = ok ? p : 0.f;
  }
}
// The same with the softcap: p = 2^(cap log2(e) t - lse2) with t =
// tanh(s scale / cap); sc keeps p (1 - t^2) (0 where the mask drops the
// pair: t is finite, so nothing turns 0 into NaN), the value dscores takes
// for p, and with PACK p itself goes to `pa` rounded to bf16 as wgmma's A
// fragments (pack_a's layout).
template <int N, bool ROW_Q, bool PACK, typename Lse>
__device__ __forceinline__ void capped_probs(float (&sc)[N / 2], uint32_t (*pa)[4], const Mask& mask,
                                             bool interior, int row0, int col0, int t, const Cap& cap,
                                             Lse lse_of) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * j + e, r = e / 2, c = 8 * j + 2 * t + (e % 2);
      const float th = tanhf(sc[x] * cap.inv);
      const bool ok = interior || (ROW_Q ? mask.ok(row0 + 8 * r, col0 + c) : mask.ok_at(col0 + c, row0 + 8 * r));
      p[e] = ok ? ex2(cap.log2 * th - lse_of(r, c)) : 0.f;
      sc[x] = p[e] * fmaf(-th, th, 1.f);
    }
    if constexpr (PACK) {
      pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
  }
}
// ds = p (dp - Di) in place of dp (0 where p is: the tiles hold finite values)
template <int N, typename Di>
__device__ __forceinline__ void dscores(const float (&p)[N / 2], float (&dp)[N / 2], int t, Di di_of) {
#pragma unroll
  for (int x = 0; x < N / 2; ++x) dp[x] = p[x] * (dp[x] - di_of((x / 2) % 2, 8 * (x / 4) + 2 * t + (x % 2)));
}

// 64 x N scores rounded to bf16 as wgmma's A fragments: k-step kk covers
// the column blocks 2kk and 2kk + 1
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&sc)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    a[j / 2][(j % 2) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    a[j / 2][(j % 2) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

// one arrival on `bar` from each warp of the calling warpgroup
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// Refinements and measured choices; scripts/torch_kernel_ab.py --kernel
// attention_bwd --ablate builds the kernels with each changed and times
// them (PERF.md).
constexpr bool FUSED_DI = true;  // dQ's kernel computes Di from O and dO: no pass of its own
constexpr bool STAGGER = true;   // P is computed under dP's product, dS (dK/dV) under dV's
constexpr int GQA_SPLIT = 2;     // blocks a kv head's query heads are split over (at most), D 64 / 128
constexpr int GQA_SPLIT_D256 = 4;  // ... at D 256, whose dK/dV blocks hold 64 keys (GQA 16/1: 64 G blocks)
constexpr int KV_CONSUMERS = 2;  // dK/dV: warpgroups of 64 keys a block
constexpr int DQ_KEYS = 128;     // dQ: keys a tile of the K / V ring

template <int D>
struct KvTiles {  // dK/dV: a block per (BN keys, kv head, head group, batch)
  // D 256: dK and dV of 64 keys are 64 x 256 f32, 128 registers a thread
  // each, so the two warpgroups share the block's 64 keys and each holds
  // one D half of both, computing S^T and dP^T (over all of D) itself
  static constexpr int HALVES = D == 256 ? 2 : 1;
  static constexpr int CONSUMERS = D == 256 ? 2 : KV_CONSUMERS;
  static constexpr int DH = D / HALVES;               // dK / dV columns a warpgroup holds
  static constexpr int BN = 64 * CONSUMERS / HALVES;  // keys a block
  static constexpr int BQ = 64;              // queries a step
  static constexpr int STAGES = 2;           // Q / dO / lse2 / Di ring slots
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  static constexpr uint32_t KV_BYTES = BN * D * 2;  // the K (or V) tile
  static constexpr uint32_t Q_BYTES = BQ * D * 2;   // a slot's Q (or dO) tile
  static constexpr size_t SMEM =
      1024 + 2 * size_t(KV_BYTES) + 2 * STAGES * size_t(Q_BYTES) + 2 * STAGES * BQ * 4 + 8 * (1 + 2 * STAGES);
  // two consumers: 384 threads launch at 168 registers, and setmaxnreg
  // moves the producer's share to them (128 x 24 + 256 x 240 = 384 x 168;
  // asking for more than the launch holds never returns)
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = 240;
  static_assert(CONSUMERS != 2 || 128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 384 * 168);
};

template <int D>
struct QTiles {  // dQ: a block per (128 queries, head, batch), the forward's shape
  static constexpr int CONSUMERS = 2;
  static constexpr int BM = 64 * CONSUMERS;    // queries a block
  // D 256: Q and dO of 128 rows are 64 KB each, so the K / V tiles take 64
  // keys and the ring one slot (two would need 256 KB of shared memory)
  static constexpr int BN = D == 256 ? 64 : DQ_KEYS;  // keys a tile: S and dP beside dQ's accumulator
  static constexpr int STAGES = D == 256 ? 1 : 2;     // K / V ring slots
  static constexpr int ON = D == 256 ? 128 : D;       // dQ columns a wgmma (n128 at most)
  static constexpr int OH = D / ON;                   // dQ wgmmas a k-step
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  static constexpr uint32_t Q_BYTES = BM * D * 2;
  static constexpr uint32_t KV_BYTES = BN * D * 2;
  static constexpr size_t SMEM = 1024 + 2 * size_t(Q_BYTES) + 2 * STAGES * size_t(KV_BYTES) + 8 * (1 + 4 * STAGES);
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = 240;
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 384 * 168);
};

// the blocks a kv head's `rep` query heads are split over at head dim D: the
// largest divisor of rep up to GQA_SPLIT (GQA_SPLIT_D256 at D 256)
__host__ __device__ inline int gqa_split(int rep, int D) {
  const int cap = D == 256 ? GQA_SPLIT_D256 : GQA_SPLIT;
  int g = cap < rep ? cap : rep;
  while (rep % g) --g;
  return g;
}

// ---- dQ (and, with FUSED_DI, Di). Shared memory: Q, dO, STAGES K tiles,
// STAGES V tiles, then the barriers.
template <int D, bool CAP>
__global__ void __launch_bounds__(QTiles<D>::THREADS, 1)
    dq_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
                   float* __restrict__ delta, bf16* __restrict__ dq, Strides so, Strides sdo, Strides sdq,
                   int rep, Mask mask, float scale, float scale_log2, Cap cap) {
  using T = QTiles<D>;
  constexpr int BM = T::BM, BN = T::BN, ST = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* dos = qs + T::Q_BYTES;
  uint8_t* ks = dos + T::Q_BYTES;
  uint8_t* vs = ks + ST * T::KV_BYTES;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(vs + ST * T::KV_BYTES);  // Q and dO
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + ST;
  uint64_t* free_k = full_v + ST;
  uint64_t* free_v = free_k + ST;

  const int Sq = mask.Sq, H = gridDim.x;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;  // the longest rows first
  const int h = blockIdx.x, b = blockIdx.y;
  const int2 kt = mask.key_tiles<BM, BN>(q0);
  const int n_tiles = kt.y - kt.x + 1;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&free_k[s], 4 * T::CONSUMERS);
      mbar_init(&free_v[s], 4 * T::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread brings Q and dO once, then keeps the K / V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, 2 * T::Q_BYTES);
      load_rows<BM, D>(qs, &tq, full_q, q0, h, b);
      load_rows<BM, D>(dos, &tdo, full_q, q0, h, b);
      const int hk = h / rep;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        const uint32_t free_parity = ((i / ST) & 1) ^ 1;
        const int k0 = (kt.x + i) * BN;
        // V first: it is freed as soon as dP is done, K only after dQ's
        // product, so with one slot (D 256) V's load runs under that product
        mbar_wait(&free_v[s], free_parity);
        mbar_expect_tx(&full_v[s], T::KV_BYTES);
        load_rows<BN, D>(vs + s * T::KV_BYTES, &tv, &full_v[s], k0, hk, b);
        mbar_wait(&free_k[s], free_parity);
        mbar_expect_tx(&full_k[s], T::KV_BYTES);
        load_rows<BN, D>(ks + s * T::KV_BYTES, &tk, &full_k[s], k0, hk, b);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns the query rows qw .. qw + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::CONSUMER_REGS));
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int qw = q0 + 64 * cw;
    const int qi0 = qw + 16 * warp + g;  // this thread's rows: qi0 and qi0 + 8

    // each row's lse2 and Di; with FUSED_DI, Di = rowsum(dO o O) here, the
    // four lanes of a quad taking every fourth 16-byte chunk of the row.
    // Run under the first tile's products.
    float lse_r[2], dl_r[2];
    auto row_stats = [&]() {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = qi0 + 8 * r;
        const int64_t row = (int64_t(b) * H + h) * Sq + qi;
        if constexpr (FUSED_DI) {
          float acc = 0.f;
          if (qi < Sq) {
            const bf16* orow = o + b * so.b + h * so.h + qi * so.s;
            const bf16* drow = dout + b * sdo.b + h * sdo.h + qi * sdo.s;
#pragma unroll
            for (int c = t; c < D / 8; c += 4) {
              const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * c);
              const uint4 dv = *reinterpret_cast<const uint4*>(drow + 8 * c);
              const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
              const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 of = __bfloat1622float2(op[e]), df = __bfloat1622float2(dp[e]);
                acc = fmaf(of.x, df.x, acc);
                acc = fmaf(of.y, df.y, acc);
              }
            }
          }
          acc += __shfl_xor_sync(0xffffffffu, acc, 1);
          acc += __shfl_xor_sync(0xffffffffu, acc, 2);
          dl_r[r] = acc;
          if (t == 0 && qi < Sq) delta[row] = acc;
        } else {
          dl_r[r] = qi < Sq ? delta[row] : 0.f;
        }
        lse_r[r] = qi < Sq ? lse[row] : INFINITY;
      }
    };

    constexpr int ON = T::ON, OH = T::OH;
    float acc[OH][ON / 2];  // dQ / scale: column x ON + 8j + 2t + c of row r in acc[x][4j + 2r + c]
#pragma unroll
    for (int x = 0; x < OH; ++x)
#pragma unroll
      for (int y = 0; y < ON / 2; ++y) acc[x][y] = 0.f;
    const uint64_t dq_a = sw128_desc(qs + cw * 64 * 128, 16, 1024);
    const uint64_t ddo_a = sw128_desc(dos + cw * 64 * 128, 16, 1024);
    // With the cap, before the loop: under the first tile's products the
    // cap's tanhf leaves too few registers, and ptxas spills three values
    // of the set-up at D 256
    if constexpr (CAP) row_stats();
    mbar_wait(full_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % ST;
      const int k0 = (kt.x + i) * BN;
      uint8_t* kslot = ks + s * T::KV_BYTES;
      float sc[BN / 2], dp[BN / 2];
      mbar_wait(&full_k[s], (i / ST) & 1);
      mbar_wait(&full_v[s], (i / ST) & 1);
      // S = Q K^T and dP = dO V^T, D / 16 k-steps each
      wgmma_fence();
      {
        const uint64_t dk_b = sw128_desc(kslot, 16, 1024);
        const uint64_t dv_b = sw128_desc(vs + s * T::KV_BYTES, 16, 1024);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<BN>(sc, k_step<BM>(dq_a, kk), k_step<BN>(dk_b, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<BN>(dp, k_step<BM>(ddo_a, kk), k_step<BN>(dv_b, kk), kk > 0);
        wgmma_commit();
      }
      if (!CAP && i == 0) row_stats();
      if constexpr (STAGGER)
        wgmma_wait<1>();  // S is done; dP may still run
      else
        wgmma_wait<0>();
      pin(sc);
      if constexpr (CAP)  // sc: p (1 - t^2), what dscores takes for p
        capped_probs<BN, true, false>(sc, nullptr, mask, mask.interior<BN>(qw, k0), qi0, k0, t, cap,
                                      [&](int r, int) { return lse_r[r]; });
      else
        probs<BN, true>(sc, mask, mask.interior<BN>(qw, k0), qi0, k0, t, scale_log2,
                        [&](int r, int) { return lse_r[r]; });
      wgmma_wait<0>();
      pin(dp);
      warp_arrive(&free_v[s]);
      dscores<BN>(sc, dp, t, [&](int r, int) { return dl_r[r]; });
      uint32_t da[BN / 16][4];
      pack_a<BN>(da, dp);
      // dQ += dS K: the K tile as the MN-major B operand
      pin(acc);
      pin(da);
      wgmma_fence();
      {
        const uint64_t dk_n = sw128_desc(kslot, BN * 128, 1024);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int x = 0; x < OH; ++x) wgmma_rs<ON>(acc[x], da[kk], dk_n + x * (ON / 64) * (BN * 8) + kk * 128);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
      pin(da);
      warp_arrive(&free_k[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = qi0 + 8 * r;
      if (qi >= Sq) continue;
      bf16* dst = dq + b * sdq.b + h * sdq.h + qi * sdq.s + 2 * t;
#pragma unroll
      for (int x = 0; x < OH; ++x)
#pragma unroll
        for (int j = 0; j < ON / 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + x * ON + 8 * j) =
              pack_bf16(acc[x][4 * j + 2 * r] * scale, acc[x][4 * j + 2 * r + 1] * scale);
    }
  }
}

// ---- dK, dV. A block owns BN keys of kv head hk and walks the query
// steps of its group's share of the query heads (rep / G of them). With
// G == 1 it stores dK and dV; otherwise f32 partial sums into `part`,
// laid out (G, 2, B, KV, Sk, D), that reduce_dkdv_kernel adds in order.
// Shared memory: K, V, STAGES Q tiles, STAGES dO tiles, STAGES x BQ lse2,
// the same of Di, then the barriers.
template <int D, bool CAP>
__global__ void __launch_bounds__(KvTiles<D>::THREADS, 1)
    dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, float* __restrict__ part, Strides sdk, Strides sdv, int H,
                     int rep, int G, Mask mask, float scale, float scale_log2, Cap cap) {
  using T = KvTiles<D>;
  constexpr int BN = T::BN, BQ = T::BQ, ST = T::STAGES, DH = T::DH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* vs = ks + T::KV_BYTES;
  uint8_t* qs = vs + T::KV_BYTES;
  uint8_t* dos = qs + ST * T::Q_BYTES;
  float* lse_s = reinterpret_cast<float*>(dos + ST * T::Q_BYTES);
  float* dl_s = lse_s + ST * BQ;
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(dl_s + ST * BQ);
  uint64_t* full = full_kv + 1;  // a slot's Q, dO, lse2 and Di are in
  uint64_t* free_ = full + ST;   // every consumer warp is done with the slot

  const int Sq = mask.Sq, Sk = mask.Sk, KV = gridDim.x / G;
  // causal: key tile 0, which the most queries see, first
  const int tile = mask.causal ? blockIdx.z : gridDim.z - 1 - blockIdx.z;
  const int k0 = tile * BN, hk = blockIdx.x / G, grp = blockIdx.x % G, b = blockIdx.y;
  const int heads = rep / G, h0 = hk * rep + grp * heads;  // this block's query heads
  const int2 qr = mask.queries<BN>(k0);
  const int qt0 = qr.x / BQ, n_q = qr.y < qr.x ? 0 : qr.y / BQ - qt0 + 1;  // 0: dK = dV = 0
  const int n_steps = heads * n_q;  // step i: head h0 + i / n_q, queries (qt0 + i % n_q) BQ
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA's transaction arrival and the producer warp's lanes
      mbar_init(&free_[s], 4 * T::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one warp; lane 0 brings K and V once, then each step's
    // Q and dO tiles by TMA, while the lanes copy its lse2 and Di
    if constexpr (T::CONSUMERS == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::PRODUCER_REGS));
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(full_kv, 2 * T::KV_BYTES);
        load_rows<BN, D>(ks, &tk, full_kv, k0, hk, b);
        load_rows<BN, D>(vs, &tv, full_kv, k0, hk, b);
      }
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % ST, h = h0 + i / n_q, q0 = (qt0 + i % n_q) * BQ;
        mbar_wait(&free_[s], ((i / ST) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * T::Q_BYTES);
          load_rows<BQ, D>(qs + s * T::Q_BYTES, &tq, &full[s], q0, h, b);
          load_rows<BQ, D>(dos + s * T::Q_BYTES, &tdo, &full[s], q0, h, b);
        }
        const int64_t row = (int64_t(b) * H + h) * Sq;
#pragma unroll
        for (int x = lane; x < BQ; x += 32) {
          const int qi = q0 + x;
          lse_s[s * BQ + x] = qi < Sq ? lse[row + qi] : INFINITY;  // rows past Sq: p = 0
          dl_s[s * BQ + x] = qi < Sq ? delta[row + qi] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns the keys kw .. kw + 63 (and, at D
    // 256, the columns hf DH .. hf DH + DH - 1 of their dK and dV)
    if constexpr (T::CONSUMERS == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::CONSUMER_REGS));
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int hf = T::HALVES == 2 ? cw : 0;
    const int kw = k0 + (T::HALVES == 2 ? 0 : 64 * cw);
    const int kj0 = kw + 16 * warp + g;  // this thread's keys: kj0 and kj0 + 8

    float dka[DH / 2], dva[DH / 2];  // dK / scale and dV
#pragma unroll
    for (int x = 0; x < DH / 2; ++x) dka[x] = dva[x] = 0.f;
    const uint64_t dk_a = sw128_desc(ks + (kw - k0) * 128, 16, 1024);
    const uint64_t dv_a = sw128_desc(vs + (kw - k0) * 128, 16, 1024);
    mbar_wait(full_kv, 0);
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % ST, q0 = (qt0 + i % n_q) * BQ;
      uint8_t* qslot = qs + s * T::Q_BYTES;
      uint8_t* dslot = dos + s * T::Q_BYTES;
      float st[BQ / 2], dpt[BQ / 2];
      mbar_wait(&full[s], (i / ST) & 1);
      // S^T = K Q^T and dP^T = V dO^T, D / 16 k-steps each
      wgmma_fence();
      {
        const uint64_t dq_b = sw128_desc(qslot, 16, 1024), ddo_b = sw128_desc(dslot, 16, 1024);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<BQ>(st, k_step<BN>(dk_a, kk), k_step<BQ>(dq_b, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<BQ>(dpt, k_step<BN>(dv_a, kk), k_step<BQ>(ddo_b, kk), kk > 0);
        wgmma_commit();
      }
      if constexpr (STAGGER)
        wgmma_wait<1>();  // S^T is done; dP^T may still run
      else
        wgmma_wait<0>();
      pin(st);
      const float* ls = lse_s + s * BQ;
      const float* dl = dl_s + s * BQ;
      uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
      if constexpr (CAP) {  // st: p (1 - t^2), what dscores takes for p; pa: p in bf16
        capped_probs<BQ, false, true>(st, pa, mask, mask.interior_keys<BQ>(kw, q0), kj0, q0 + mask.qoff, t, cap,
                                      [&](int, int c) { return ls[c]; });
      } else {
        probs<BQ, false>(st, mask, mask.interior_keys<BQ>(kw, q0), kj0, q0 + mask.qoff, t, scale_log2,
                         [&](int, int c) { return ls[c]; });
        pack_a<BQ>(pa, st);
      }
      // dV += P^T dO, then dK += dS^T Q: the dO and Q tiles (their D half) as MN-major B operands
      const int col0 = hf * (DH / 64) * BQ * 128;  // bytes to the half's first atom column
      const uint64_t dq_n = sw128_desc(qslot + col0, BQ * 128, 1024);
      const uint64_t ddo_n = sw128_desc(dslot + col0, BQ * 128, 1024);
      pin(dva);
      pin(pa);
      if constexpr (STAGGER) {  // dV under dS^T's elementwise work
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<DH>(dva, pa[kk], ddo_n + kk * 128);
        wgmma_commit();
        wgmma_wait<1>();  // dP^T is done; dV may still run
      } else {
        wgmma_wait<0>();
      }
      pin(dpt);
      dscores<BQ>(st, dpt, t, [&](int, int c) { return dl[c]; });
      pack_a<BQ>(sa, dpt);
      pin(dka);
      pin(sa);
      wgmma_fence();
      if constexpr (!STAGGER) {
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<DH>(dva, pa[kk], ddo_n + kk * 128);
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<DH>(dka, sa[kk], dq_n + kk * 128);
      wgmma_commit();
      wgmma_wait<0>();
      pin(dka);
      pin(dva);
      pin(pa);
      pin(sa);
      warp_arrive(&free_[s]);
    }

    const int B = gridDim.y;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kj = kj0 + 8 * r;
      if (kj >= Sk) continue;
      if (part == nullptr) {  // one block a kv head: store
        bf16* dkr = dk + b * sdk.b + hk * sdk.h + kj * sdk.s + hf * DH + 2 * t;
        bf16* dvr = dv + b * sdv.b + hk * sdv.h + kj * sdv.s + hf * DH + 2 * t;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          *reinterpret_cast<uint32_t*>(dkr + 8 * j) =
              pack_bf16(dka[4 * j + 2 * r] * scale, dka[4 * j + 2 * r + 1] * scale);
          *reinterpret_cast<uint32_t*>(dvr + 8 * j) = pack_bf16(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
        }
      } else {  // a partial sum of the group's share
        const int64_t plane = int64_t(B) * KV * Sk * D;
        float* pk = part + int64_t(2 * grp) * plane + ((int64_t(b) * KV + hk) * Sk + kj) * D + hf * DH + 2 * t;
        float* pv = pk + plane;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          *reinterpret_cast<float2*>(pk + 8 * j) = make_float2(dka[4 * j + 2 * r], dka[4 * j + 2 * r + 1]);
          *reinterpret_cast<float2*>(pv + 8 * j) = make_float2(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// ---- the G partial sums of dK and dV added in the order g = 0 .. G - 1
// (the same bits at every call), dK scaled, stored as bf16; 4 elements a thread
__global__ void reduce_dkdv_kernel(const float* __restrict__ part, bf16* __restrict__ dk, bf16* __restrict__ dv,
                                   Strides sdk, Strides sdv, int G, int KV, int Sk, int D, int64_t plane,
                                   float scale) {
  const int64_t idx = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (idx >= 2 * plane) return;
  const int which = idx >= plane;  // 0: dK, 1: dV
  const int64_t e = idx - which * plane;
  float4 acc = *reinterpret_cast<const float4*>(part + which * plane + e);
  for (int g = 1; g < G; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(part + (2 * g + which) * plane + e);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const float f = which ? 1.f : scale;
  const int d = int(e % D), s = int((e / D) % Sk), hk = int((e / (int64_t(D) * Sk)) % KV);
  const int b = int(e / (int64_t(D) * Sk * KV));
  const Strides st = which ? sdv : sdk;
  bf16* dst = (which ? dv : dk) + b * st.b + hk * st.h + s * st.s + d;
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(acc.x * f, acc.y * f), pack_bf16(acc.z * f, acc.w * f));
}

// --------------------------------------------------------- f32, CUDA cores
constexpr int F32_THREADS = 256;  // 16 row groups x 16 column groups

// rows of an f32 tile: TILE, and 32 at D 256, where four 64-row tiles of K,
// V, Q and dO (263 KB) would not fit in shared memory; each thread holds
// (R / 16) x (R / 16) scores
template <int D>
__host__ __device__ constexpr int f32_rows() {
  return D == 256 ? 32 : TILE;
}

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int64_t st, int row0,
                                              int S) {
  constexpr int KP = D + 1, R = f32_rows<D>();
  for (int idx = threadIdx.x; idx < R * D; idx += F32_THREADS) {
    const int r = idx / D, c = idx % D;
    dst[r * KP + c] = row0 + r < S ? src[(row0 + r) * st + c] : 0.f;
  }
}

template <int D>
constexpr size_t f32_smem_kv() {  // K, V, Q, dO tiles, P^T and dS^T, lse and Di
  constexpr size_t R = f32_rows<D>();
  return sizeof(float) * (4 * R * (D + 1) + 2 * R * (R + 1) + 2 * R);
}
template <int D>
constexpr size_t f32_smem_q() {  // Q, dO, K, V tiles, dS, lse and Di
  constexpr size_t R = f32_rows<D>();
  return sizeof(float) * (4 * R * (D + 1) + R * (R + 1) + 2 * R);
}

// p of an f32 pair (0 where the mask drops it) and dS's factor: with the
// cap 1 - t^2, the capped score made as the forward's f32 kernel makes it
// (Mask::apply: cap tanhf(s scale / cap)), in base 2; without it 1, a
// constant the compiler folds away
template <bool CAP>
__device__ __forceinline__ float f32_prob(float s, bool ok, float lse2, float scale_log2, float scale,
                                          const Cap& cap, float& dfac) {
  if constexpr (CAP) {
    const float th = tanhf(s * scale / cap.cap);
    dfac = fmaf(-th, th, 1.f);
    return ok ? exp2f(cap.cap * th * LOG2E - lse2) : 0.f;
  } else {
    dfac = 1.f;
    return ok ? exp2f(s * scale_log2 - lse2) : 0.f;
  }
}

template <int D, bool CAP>
__global__ void __launch_bounds__(F32_THREADS)
    dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv, Strides sq, Strides sk,
                    Strides sv, Strides sdo, Strides sdk, Strides sdv, int H, int rep, Mask mask,
                    float scale, float scale_log2, Cap cap) {
  constexpr int R = f32_rows<D>(), RI = R / 16, KP = D + 1, PP = R + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + R * KP;
  float* qs = vs + R * KP;
  float* dos = qs + R * KP;
  float* ps = dos + R * KP;  // P^T: key x query
  float* dss = ps + R * PP;  // dS^T
  float* lse_s = dss + R * PP;
  float* dl_s = lse_s + R;

  const int Sq = mask.Sq, Sk = mask.Sk;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;  // keys ty + 16 i; queries / columns tx + 16 j
  const int k0 = blockIdx.x * R, hk = blockIdx.y, b = blockIdx.z;
  load_tile_f32<D>(ks, k + b * sk.b + hk * sk.h, sk.s, k0, Sk);
  load_tile_f32<D>(vs, v + b * sv.b + hk * sv.h, sv.s, k0, Sk);

  float dka[RI][DC], dva[RI][DC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int2 qr = mask.queries<R>(k0);
  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    const float* lse_h = lse + (int64_t(b) * H + h) * Sq;
    const float* dl_h = delta + (int64_t(b) * H + h) * Sq;
    for (int q0 = (qr.x / R) * R; qr.x <= qr.y && q0 <= qr.y; q0 += R) {
      __syncthreads();
      load_tile_f32<D>(qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
      load_tile_f32<D>(dos, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq);
      if (tid < R) {
        const int qi = q0 + tid;
        lse_s[tid] = qi < Sq ? lse_h[qi] : INFINITY;
        dl_s[tid] = qi < Sq ? dl_h[qi] : 0.f;
      }
      __syncthreads();

      float s[RI][RI], dp[RI][RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[RI], vv[RI], qv[RI], ov[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          kv[i] = ks[(ty + 16 * i) * KP + d];
          vv[i] = vs[(ty + 16 * i) * KP + d];
          qv[i] = qs[(tx + 16 * i) * KP + d];
          ov[i] = dos[(tx + 16 * i) * KP + d];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < RI; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          const int kr = ty + 16 * i, qc = tx + 16 * j;
          float dfac;
          const float p =
              f32_prob<CAP>(s[i][j], mask.ok_at(q0 + mask.qoff + qc, k0 + kr), lse_s[qc], scale_log2, scale, cap, dfac);
          ps[kr * PP + qc] = p;
          dss[kr * PP + qc] = p * (dp[i][j] - dl_s[qc]) * dfac;
        }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < R; ++qq) {
        float pv[RI], sv_[RI], ov[DC], qv[DC];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pv[i] = ps[(ty + 16 * i) * PP + qq];
          sv_[i] = dss[(ty + 16 * i) * PP + qq];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          ov[c] = dos[qq * KP + tx + 16 * c];
          qv[c] = qs[qq * KP + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dva[i][c] = fmaf(pv[i], ov[c], dva[i][c]);
            dka[i][c] = fmaf(sv_[i], qv[c], dka[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= Sk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[b * sdk.b + hk * sdk.h + kj * sdk.s + tx + 16 * c] = dka[i][c] * scale;
      dv[b * sdv.b + hk * sdv.h + kj * sdv.s + tx + 16 * c] = dva[i][c];
    }
  }
}

template <int D, bool CAP>
__global__ void __launch_bounds__(F32_THREADS)
    dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo,
                  Strides sdq, int H, int rep, Mask mask, float scale, float scale_log2, Cap cap) {
  constexpr int R = f32_rows<D>(), RI = R / 16, KP = D + 1, PP = R + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + R * KP;
  float* ks = dos + R * KP;
  float* vs = ks + R * KP;
  float* dss = vs + R * KP;  // dS: query x key
  float* lse_s = dss + R * PP;
  float* dl_s = lse_s + R;

  const int Sq = mask.Sq, Sk = mask.Sk;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;  // queries ty + 16 i; keys / columns tx + 16 j
  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / rep;
  load_tile_f32<D>(qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
  load_tile_f32<D>(dos, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq);
  if (tid < R) {
    const int qi = q0 + tid;
    lse_s[tid] = qi < Sq ? lse[(int64_t(b) * H + h) * Sq + qi] : INFINITY;
    dl_s[tid] = qi < Sq ? delta[(int64_t(b) * H + h) * Sq + qi] : 0.f;
  }
  float dqa[RI][DC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dqa[i][c] = 0.f;

  const int2 kt = mask.key_tiles<R, R>(q0);
  for (int it = kt.x; it <= kt.y; ++it) {
    const int k0 = it * R, diag = k0 - q0 - mask.qoff;
    __syncthreads();
    load_tile_f32<D>(ks, k + b * sk.b + hk * sk.h, sk.s, k0, Sk);
    load_tile_f32<D>(vs, v + b * sv.b + hk * sv.h, sv.s, k0, Sk);
    __syncthreads();

    float s[RI][RI], dp[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], ov[RI], kv[RI], vv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = qs[(ty + 16 * i) * KP + d];
        ov[i] = dos[(ty + 16 * i) * KP + d];
        kv[i] = ks[(tx + 16 * i) * KP + d];
        vv[i] = vs[(tx + 16 * i) * KP + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int qr = ty + 16 * i, kc = tx + 16 * j;
        float dfac;
        const int dk = diag + kc - qr;  // key position less query position
        const bool keep = k0 + kc < Sk && !(mask.causal && dk > 0) && !(mask.window > 0 && dk <= -mask.window);
        const float p = f32_prob<CAP>(s[i][j], keep, lse_s[qr], scale_log2, scale, cap, dfac);
        dss[qr * PP + kc] = p * (dp[i][j] - dl_s[qr]) * dfac;
      }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < R; ++kk) {
      float dsv[RI], kv[DC];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = dss[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = ks[kk * KP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) dqa[i][c] = fmaf(dsv[i], kv[c], dqa[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[b * sdq.b + h * sdq.h + qi * sdq.s + tx + 16 * c] = dqa[i][c] * scale;
  }
}

// ------------------------------------------------------------------ host
// A copy of flash_attention.cu:742-798: the tensor-map encoder, the map,
// the shared-memory attribute.
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
// strides (innermost first), read in boxes of 64 columns x 64 rows with
// 128-byte swizzle; elements past an extent read as zero. TMA takes
// strides that are positive multiples of 16 bytes (the wrapper checks); a
// dimension of extent 1 is never stepped, so its stride is replaced by one
// that TMA takes, whatever the caller's.
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int heads, int B, Strides st) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(heads), cuuint64_t(B)};
  cuuint64_t strides[3] = {cuuint64_t(st.s) * 2, cuuint64_t(st.h) * 2, cuuint64_t(st.b) * 2};
  cuuint64_t any = cuuint64_t(D) * 2;
  for (int i = 0; i < 3; ++i)
    if (dims[i + 1] > 1 && strides[i] > any) any = strides[i];
  for (int i = 0; i < 3; ++i)
    if (dims[i + 1] == 1) strides[i] = any;
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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
  Cap cap;  // cap 0: none
};

template <typename T>
cudaError_t launch_delta(const Args& a, int D, cudaStream_t stream) {
  const int64_t rows = int64_t(a.B) * a.H * a.mask.Sq;
  constexpr int WARPS = 8;
  delta_kernel<T><<<unsigned((rows + WARPS - 1) / WARPS), 32 * WARPS, 0, stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, a.so, a.sdo, a.H,
      a.mask.Sq, D, rows);
  return cudaGetLastError();
}

// floats of `delta` a bf16 call uses: Di (B x H x Sq, rounded up to 64 so
// that the partials after it are 256-byte aligned), then with a GQA split
// the partial sums of dK and dV (G x 2 x B x KV x Sk x D)
int64_t bf16_scratch_floats(int B, int H, int KV, int Sq, int Sk, int D) {
  const int64_t di = (int64_t(B) * H * Sq + 63) / 64 * 64;
  const int G = gqa_split(H / KV, D);
  return G > 1 ? di + int64_t(G) * 2 * B * KV * Sk * D : di;
}

template <int D, bool CAP>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  using TQ = QTiles<D>;
  using TK = KvTiles<D>;
  const int Sq = a.mask.Sq, Sk = a.mask.Sk, rep = a.H / a.KV, G = gqa_split(rep, D);
  const float scale_log2 = a.scale * LOG2E;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, a.q, D, Sq, a.H, a.B, a.sq) || !make_map(&mk, a.k, D, Sk, a.KV, a.B, a.sk) ||
      !make_map(&mv, a.v, D, Sk, a.KV, a.B, a.sv) || !make_map(&mdo, a.dout, D, Sq, a.H, a.B, a.sdo))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (!FUSED_DI) {
    err = launch_delta<bf16>(a, D, stream);
    if (err != cudaSuccess) return err;
  }
  static std::atomic<uint64_t> sized_q{0}, sized_kv{0};
  auto qk = dq_bf16_kernel<D, CAP>;
  err = size_smem_once(reinterpret_cast<const void*>(qk), int(TQ::SMEM), sized_q);
  if (err != cudaSuccess) return err;
  qk<<<dim3(a.H, a.B, (Sq + TQ::BM - 1) / TQ::BM), TQ::THREADS, TQ::SMEM, stream>>>(
      mq, mk, mv, mdo, static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      static_cast<bf16*>(a.dq), a.so, a.sdo, a.sdq, rep, a.mask, a.scale, scale_log2, a.cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* part = G > 1 ? a.delta + (int64_t(a.B) * a.H * Sq + 63) / 64 * 64 : nullptr;
  auto kv = dkdv_bf16_kernel<D, CAP>;
  err = size_smem_once(reinterpret_cast<const void*>(kv), int(TK::SMEM), sized_kv);
  if (err != cudaSuccess) return err;
  kv<<<dim3(G * a.KV, a.B, (Sk + TK::BN - 1) / TK::BN), TK::THREADS, TK::SMEM, stream>>>(
      mq, mk, mv, mdo, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), part, a.sdk,
      a.sdv, a.H, rep, G, a.mask, a.scale, scale_log2, a.cap);
  err = cudaGetLastError();
  if (err != cudaSuccess || G == 1) return err;
  const int64_t plane = int64_t(a.B) * a.KV * Sk * D;
  constexpr int THREADS = 256;
  reduce_dkdv_kernel<<<unsigned((2 * plane / 4 + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      part, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.sdk, a.sdv, G, a.KV, Sk, D, plane, a.scale);
  return cudaGetLastError();
}

template <int D, bool CAP>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  cudaError_t err = launch_delta<float>(a, D, stream);
  if (err != cudaSuccess) return err;
  constexpr int R = f32_rows<D>();
  const int q_tiles = (a.mask.Sq + R - 1) / R, k_tiles = (a.mask.Sk + R - 1) / R, rep = a.H / a.KV;
  const float scale_log2 = a.scale * LOG2E;
  static std::atomic<uint64_t> sized_kv{0}, sized_q{0};
  auto kv = dkdv_f32_kernel<D, CAP>;
  err = size_smem_once(reinterpret_cast<const void*>(kv), int(f32_smem_kv<D>()), sized_kv);
  if (err != cudaSuccess) return err;
  kv<<<dim3(k_tiles, a.KV, a.B), F32_THREADS, f32_smem_kv<D>(), stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv,
      a.H, rep, a.mask, a.scale, scale_log2, a.cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto qk = dq_f32_kernel<D, CAP>;
  err = size_smem_once(reinterpret_cast<const void*>(qk), int(f32_smem_q<D>()), sized_q);
  if (err != cudaSuccess) return err;
  qk<<<dim3(q_tiles, a.H, a.B), F32_THREADS, f32_smem_q<D>(), stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dq), a.sq, a.sk, a.sv, a.sdo, a.sdq, a.H, rep, a.mask, a.scale,
      scale_log2, a.cap);
  return cudaGetLastError();
}

// the softcap at head dim 256 only (gemma2-2b's): no config has one at 64 or 128
template <int D>
cudaError_t dispatch(int dtype, const Args& a, cudaStream_t stream) {
  if (a.cap.cap > 0.f) {
    if constexpr (D == 256) {
      if (dtype == 0) return launch_f32<D, true>(a, stream);
      if (dtype == 1) return launch_bf16<D, true>(a, stream);
    }
    return cudaErrorInvalidValue;
  }
  if (dtype == 0) return launch_f32<D, false>(a, stream);
  if (dtype == 1) return launch_bf16<D, false>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 24 element strides, (batch,
// sequence, head) of q, k, v, o, do, dq, dk and dv in that order. q, o, do
// and dq hold Sq rows at positions q_offset .. q_offset + Sq - 1, k, v, dk
// and dv Sk; with a causal mask, a window or an offset, 0 <= q_offset and
// q_offset + Sq <= Sk (keys no query sees get dk = dv = 0). lse is the forward's contiguous (B, H, Sq)
// base-2 log-sum-exp; delta an f32 scratch of
// repro_flash_attention_bwd_scratch(...) floats that the call fills (its
// first B x H x Sq are Di). window <= 0 means none. bf16 reads
// through TMA and 16 bytes at a time: 16-byte aligned data, strides
// multiples of 8 elements (the wrapper checks). softcap <= 0 means none;
// a softcap is taken at D 256 only. Launches its kernels on
// `stream`; returns cudaGetLastError() after the last launch that ran (0
// on success).
int repro_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const float* lse, float* delta, void* dq, void* dk,
                              void* dv, int dtype, int B, int H, int KV, int Sq, int Sk, int D,
                              const int64_t* strides, float scale, int causal, int window,
                              int q_offset, float softcap, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || Sq <= 0 || Sk <= 0 || H % KV != 0) return int(cudaErrorInvalidValue);
  if (q_offset < 0 || ((causal || window > 0 || q_offset > 0) && q_offset + Sq > Sk))
    return int(cudaErrorInvalidValue);
  const int64_t* s = strides;
  Args a{q, k, v, o, dout, lse, delta, dq, dk, dv,
         Strides{s[0], s[1], s[2]}, Strides{s[3], s[4], s[5]}, Strides{s[6], s[7], s[8]},
         Strides{s[9], s[10], s[11]}, Strides{s[12], s[13], s[14]}, Strides{s[15], s[16], s[17]},
         Strides{s[18], s[19], s[20]}, Strides{s[21], s[22], s[23]},
         B, H, KV, Mask{Sq, Sk, causal, window, q_offset}, scale,
         softcap > 0.f ? Cap{scale / softcap, softcap * LOG2E, softcap} : Cap{0.f, 0.f, 0.f}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return int(dispatch<64>(dtype, a, st));
    case 128:
      return int(dispatch<128>(dtype, a, st));
    case 256:
      return int(dispatch<256>(dtype, a, st));
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The floats of f32 scratch `delta` that repro_flash_attention_bwd needs
// for these shapes (-1 for arguments it refuses).
int64_t repro_flash_attention_bwd_scratch(int dtype, int B, int H, int KV, int Sq, int Sk, int D) {
  if (B <= 0 || H <= 0 || KV <= 0 || Sq <= 0 || Sk <= 0 || H % KV != 0) return -1;
  if (dtype == 1) return bf16_scratch_floats(B, H, KV, Sq, Sk, D);
  return int64_t(B) * H * Sq;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
