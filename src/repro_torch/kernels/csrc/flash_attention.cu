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
// reads kv head h / (H / Kv): GQA needs no repeated copy of K/V.
//
// Shared design. One block per (64-query tile, head, batch). A loop over
// 64-key tiles inside the block takes the place of the TPU grid's
// sequential kv axis; tiles the causal or window mask rules out entirely
// are never visited (the Pallas kernel's pl.when(needed)). S need not
// divide the tile: keys past S score -inf (they add exactly 0 even while
// a row's running max is still the -1e30 mask value) and rows past S are
// not stored. Query tiles are issued last-first, so the causal tiles with
// the most keys start first.
//
// Head dims 64, 128 and 256 (recurrentgemma's local attention, whose
// window of 2048 makes the skipped key tiles matter at S past it).
//
// Bound. At the serving shapes (S up to 3000, D 128 or 256) the work is
// ~4*D*H flops per unmasked (query, key) pair against ~4*S*H*D*2 bytes:
// hundreds of flops a byte, far above the card's ridge, so the kernel is
// bound by operations.
//
// bf16 (the serving path): both products run on the tensor cores as
// mma.sync.m16n8k16 with f32 accumulators. 4 warps own 16 query rows each;
// Q's fragments are read from the shared Q tile at each k-step (held in
// registers for the whole key loop beside a D-wide accumulator they would
// spill at D 256), the scores of a 16 x 64 tile never leave registers (the
// accumulator layout of QK^T is the operand layout of PV), and V's
// fragments come from the row-major V tile through ldmatrix.trans. Tiles are staged with 16-byte loads, rows
// padded by 8 elements so fragment loads hit 32 distinct banks. Loads do
// not yet overlap the products (cp.async / TMA and wgmma come later).
//
// f32 (the checks at 2e-5): the products run as f32 FMAs on the CUDA
// cores, 256 threads each holding a 4x4 block of scores and a 4x(D/16)
// block of the accumulator; the tensor cores' TF32 would not hold 2e-5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // queries per block
constexpr int BK = 64;  // keys per tile
constexpr float MASKED = -1e30f;

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

  // the key tiles some query in [q0, q0 + BQ) may attend to
  __device__ __forceinline__ int2 key_tiles(int q0) const {
    const int q_last = min(q0 + BQ, S) - 1;
    const int hi = causal ? q_last / BK : (S - 1) / BK;
    const int lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
    return make_int2(lo, hi);
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
                               const float* __restrict__ v, float* __restrict__ o, Strides sq,
                               Strides sk, Strides sv, Strides so, int rep, Mask mask) {
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
  }
}

// ----------------------------------------------------------- bf16, tensor cores
using bf16 = __nv_bfloat16;
constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (size_t(BQ) + 2 * size_t(BK)) * (D + 8);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four transposed 8x8 b16 matrices; lanes 8i..8i+7 address matrix i's rows
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// rows [r0, r0 + 64) of a (rows, D) bf16 matrix into a padded tile; rows
// past S are zero. 16-byte copies: the wrapper checks the alignment.
template <int D>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src, int64_t row_stride,
                                          int r0, int S) {
  constexpr int P = D + 8;
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < 64 * CH; idx += MMA_THREADS) {
    const int r = idx / CH, c = (idx % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(tile + r * P + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, bf16* __restrict__ o, Strides sq,
                                Strides sk, Strides sv, Strides so, int rep, Mask mask) {
  constexpr int P = D + 8;    // padded row stride of the Q, K and V tiles
  constexpr int KS = D / 16;  // k-steps of QK^T
  constexpr int NT = BK / 8;  // 8-key column tiles of the scores
  constexpr int OT = D / 8;   // 8-wide column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x P
  bf16* ks = qs + BQ * P;                         // BK x P
  bf16* vs = ks + BK * P;                         // BK x P

  const int S = mask.S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group and column pair
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* kb = k + b * sk.b + (h / rep) * sk.h;
  const bf16* vb = v + b * sv.b + (h / rep) * sv.h;
  bf16* ob = o + b * so.b + h * so.h;

  load_tile<D>(qs, q + b * sq.b + h * sq.h, sq.s, q0, S);
  // this warp's rows: g and g + 8 of its 16
  const int row = warp * 16 + g;
  const int qi[2] = {q0 + row, q0 + row + 8};

  float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};  // l: this thread's share of the row
  float acc[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int2 kt_range = mask.key_tiles(q0);
  for (int kt = kt_range.x; kt <= kt_range.y; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K and V are no longer read
    load_tile<D>(ks, kb, sk.s, k0, S);
    load_tile<D>(vs, vb, sv.s, k0, S);
    __syncthreads();  // K and V (and, before the first tile, Q) are in place

    // scores: s[j] is the 16 x 8 tile of keys k0 + 8j ..; element e sits at
    // row g + 8 (e / 2), key 2t + (e % 2)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      // Q's fragment for this k-step, read from the Q tile: holding all KS
      // of them for the whole key loop would spill at D 256
      const bf16* pq = qs + row * P + kk * 16 + 2 * t;
      const uint32_t qf[4] = {ld32(pq), ld32(pq + 8 * P), ld32(pq + 8), ld32(pq + 8 * P + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bf16* p = ks + (8 * j + g) * P + kk * 16 + 2 * t;
        mma_bf16(s[j], qf, ld32(p), ld32(p + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = mask.apply(s[j][e], qi[e / 2], k0 + 8 * j + 2 * t + (e % 2));
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e / 2]);
        l[e / 2] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < OT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e / 2];

    // acc += p . V, 16 keys a step; p's accumulator layout is mma's A layout
    const int mi = lane / 8, ri = lane % 8;  // ldmatrix: matrix and row this lane addresses
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < OT; n += 2) {
        uint32_t bv[4];  // keys +0..7 / +8..15 of columns 8n.., then of 8(n+1)..
        ldmatrix_x4_trans(bv, vs + (kk * 16 + (mi & 1) * 8 + ri) * P + (n + (mi >> 1)) * 8);
        mma_bf16(acc[n], a, bv[0], bv[1]);
        mma_bf16(acc[n + 1], a, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= S) continue;
    const float safe = l[r] == 0.f ? 1.f : l[r];
    bf16* dst = ob + qi[r] * so.s + 2 * t;
#pragma unroll
    for (int n = 0; n < OT; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          pack_bf16(acc[n][2 * r] / safe, acc[n][2 * r + 1] / safe);
  }
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, T*, Strides, Strides, Strides, Strides,
                        int, Mask);

template <typename T>
cudaError_t launch(Kernel<T> kern, int threads, size_t smem, const void* q, const void* k,
                   const void* v, void* o, Strides sq, Strides sk, Strides sv, Strides so,
                   int B, int H, int rep, Mask mask, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((mask.S + BQ - 1) / BQ, H, B);
  kern<<<grid, threads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(o), sq, sk,
                                        sv, so, rep, mask);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16
template <int D>
cudaError_t dispatch(int dtype, const void* q, const void* k, const void* v, void* o, Strides sq,
                     Strides sk, Strides sv, Strides so, int B, int H, int rep, Mask mask,
                     cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(flash_attention_f32_kernel<D>, F32_THREADS, f32_smem_bytes<D>(), q, k, v,
                         o, sq, sk, sv, so, B, H, rep, mask, stream);
  if (dtype == 1)
    return launch<bf16>(flash_attention_bf16_kernel<D>, MMA_THREADS, mma_smem_bytes<D>(), q, k, v,
                        o, sq, sk, sv, so, B, H, rep, mask, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. window <= 0 and softcap <= 0 mean none.
// Returns cudaGetLastError() after the launch (0 on success).
int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                              int B, int H, int KV, int S, int D, int64_t q_sb, int64_t q_ss,
                              int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                              int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
                              int64_t o_ss, int64_t o_sh, float scale, int causal, int window,
                              float softcap, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || H % KV != 0) return int(cudaErrorInvalidValue);
  const Strides sq{q_sb, q_ss, q_sh}, sk{k_sb, k_ss, k_sh}, sv{v_sb, v_ss, v_sh},
      so{o_sb, o_ss, o_sh};
  const Mask mask{S, causal, window, scale, softcap};
  const int rep = H / KV;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return int(dispatch<64>(dtype, q, k, v, o, sq, sk, sv, so, B, H, rep, mask, st));
    case 128:
      return int(dispatch<128>(dtype, q, k, v, o, sq, sk, sv, so, B, H, rep, mask, st));
    case 256:
      return int(dispatch<256>(dtype, q, k, v, o, sq, sk, sv, so, B, H, rep, mask, st));
    default:
      return int(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
