// Attention kernels for Hopper (sm_90a).
//
// Replaces these Pallas kernels of vast_tpu/ops/flash_attention.py:
//   _tmajor_fwd_kernel       (:762, wrapper self_attention_tmajor :851)
//   _tmajor_fwd_kernel_bias  (:789, the same with an additive score bias)
//   _single_kernel_nolse     (:87, wrapper flash_attention :156; the
//                             head-major forward without the lse output)
//   _tmajor_bwd_kernel       (:795, wrapper self_attention_tmajor_bwd :898)
//   _tmajor_bwd_kernel_bias  (:841); the backward is described at its
//                             kernels below
// One forward kernel body serves the first three: it reads q, k, v, the output and the
// bias through (batch, head, row) element strides, so the token-major fused
// qkv layout and the head-major layout differ only in the strides the two
// C entry points at the end of this file pass.
//
// Contract. Per (batch b, head h):
//   s = (q . k^T) * scale  [+ bias[b, h]]   in fp32,
// keys >= kend masked (kend = lk_true, or Lk), softmax in fp32, p . v
// accumulated in fp32, output in the input type. D <= 128 at run time
// (EVA01-g 88, BEATs and BERT 64). The bias is read through its own strides
// (a stride of 0 reads one shared (Lq, Lk) plane, never broadcast in
// memory), in the input type or in fp32. A row whose scores are all -inf
// gives zeros, as the Pallas kernel's l == 0 guard does.
//
// What bounds it on an H100: at EVA's shape (B 64, L 257, H 16, D 88) the
// arithmetic intensity is about L/2 = 128 FLOP per byte of qkv, below the
// card's ~295 FLOP/byte bf16 ridge, so the floor is HBM bytes: each input
// read once and the output written once (BEATs' bias adds B*H*L*L*2 bytes).
// BERT's grouped rerank (Lq = 40 x T texts, Lk 2312, D 64) has intensity
// about Lq * Lk / (Lq + Lk): 281 FLOP/byte at T = 8, at the ridge, and
// bound by operations for more texts.
// What the design does about it: each block owns one (query tile, head,
// batch row) and streams that head's K/V through shared memory with an
// online softmax, so neither the scores nor the probabilities reach device
// memory and the bias is read exactly once. D is padded nowhere in device
// memory: loads and stores are masked at D and at the sequence ends, and
// the padding to the tensor-core tile lives in shared memory only. What it
// does not do yet: TMA and wgmma, and the query tiles of one head each
// re-read its K/V (from L2). Those are later work.
//
// Two forward kernels:
// * bf16 (the main path): tensor cores through mma.sync m16n8k16, bf16
//   operands and fp32 accumulators. 8 warps x 16 query rows; key tiles of
//   64, double-buffered: cp.async brings tile i+1 (16 bytes a thread, when
//   D and every stride are multiples of 8; plain one-value stores
//   otherwise) while tile i is computed. D is padded to DP (a multiple of
//   16) in shared memory. Registers are capped at 128 a thread so that 2
//   blocks share an SM (ptxas gave 158 at DP 96 uncapped); warps whose
//   rows all lie past Lq only help load. V stays row-major and its B
//   fragments come through ldmatrix.trans. The scores stay in registers,
//   the row max/sum are reduced over each quad of lanes, and the
//   probabilities are rounded to bf16 as the A operand of p . v (as the
//   Pallas kernel casts p to v's dtype).
// * fp32: CUDA cores in full fp32 (tensor cores would round the products
//   to TF32). 8 warps x 8 query rows; in q . k^T each lane owns one key
//   of a 32-key tile, in p . v each lane owns head dims lane + 32c.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kMaxD = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kF32 = 0, kBf16 = 1;      // dtype codes of the C interface

// operands, and the rows of Params::st
enum Operand { kQ, kK, kV, kO, kBias };

struct Params {
  const void* in[3];      // q, k, v
  void* out;
  const void* bias;       // null: no bias
  long long st[5][3];     // element strides (batch, head, row) by Operand
  int lq, kend, d;
  float scale;
};

struct NoBias {};

template <typename BiasT>
constexpr bool kHasBias = !std::is_same<BiasT, NoBias>::value;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the (b, h) plane of an operand with batch and head strides sb, sh
template <typename T>
__device__ __forceinline__ T* plane(const void* base, long long sb,
                                    long long sh, int b, int h) {
  return static_cast<T*>(const_cast<void*>(base)) + b * sb + h * sh;
}

// the max a row's exponentials are taken against: 0 while every score of
// the row is -inf, so exp gives 0 there and not NaN
__device__ __forceinline__ float exp_ref(float m) {
  return m == -INFINITY ? 0.f : m;
}

// ---------------------------------------------------------------------
// bf16: tensor cores (mma.sync)
// ---------------------------------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaBlockQ = 16 * kMmaWarps;  // 128 query rows per block
constexpr int kMmaBlockK = 64;              // keys per shared-memory tile
constexpr int kMmaBlocksPerSm = 2;          // caps registers at 128/thread

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two adjacent bf16 of shared memory (the lower column in the low half)
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// transposing load of a 16 x 8 B fragment from a row-major [k][n] tile:
// lanes 0-15 give the addresses of rows k = 0..15 (8 contiguous n each)
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

// asynchronous 16-byte copy to shared memory; zero-fills when !valid
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// shared tiles: the q rows and two buffers each of k and v rows, each row
// DP (+8 against bank conflicts) wide
template <int DP>
struct MmaSmem {
  static constexpr int kLd = DP + 8;
  static constexpr size_t kBytes =
      sizeof(__nv_bfloat16) * (kMmaBlockQ + 4 * kMmaBlockK) * kLd;
};

// rows [row0, row0 + ROWS) of one operand plane into a shared tile, zero
// past ``rend`` and past D. ``vec``: D, the strides and the bases allow
// 16-byte copies, so each thread issues asynchronous ones (complete at the
// matching cp_async_wait); otherwise plain one-value stores.
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int rend, int D, bool vec) {
  constexpr int kLd = MmaSmem<DP>::kLd;
  if (vec) {
    constexpr int kChunks = DP / 8;
    for (int i = threadIdx.x; i < ROWS * kChunks; i += blockDim.x) {
      const int r = i / kChunks, c = i - r * kChunks;
      const bool valid = row0 + r < rend && c * 8 < D;
      cp_async_16(dst + r * kLd + c * 8,
                  valid ? src + (long long)(row0 + r) * row_stride + c * 8
                        : src,
                  valid);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += blockDim.x) {
      const int r = i / DP, d = i - r * DP;
      dst[r * kLd + d] = (row0 + r < rend && d < D)
                             ? src[(long long)(row0 + r) * row_stride + d]
                             : __float2bfloat16(0.f);
    }
  }
}

// Fragment layouts of mma.m16n8k16 (PTX ISA), g = lane / 4, t = lane % 4:
//   A (16 x 16, row): a0 (g, 2t..2t+1) a1 (g+8, 2t..) a2 (g, 2t+8..)
//                     a3 (g+8, 2t+8..)
//   B (16 x 8, col):  b0 (k 2t..2t+1, n g) b1 (k 2t+8.., n g)
//   C (16 x 8):       c0,c1 (g, 2t, 2t+1) c2,c3 (g+8, 2t, 2t+1)
template <int DP, typename BiasT>
__global__ void __launch_bounds__(kMmaWarps * 32, kMmaBlocksPerSm)
attention_fwd_mma_kernel(const Params p, bool vec) {
  using S = MmaSmem<DP>;
  constexpr int kSteps = DP / 16;               // k-steps of q . k^T
  constexpr int kScoreTiles = kMmaBlockK / 8;   // n-tiles of the scores
  constexpr int kOutTiles = DP / 8;             // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // buffer j of k at kv + 2j * tile, of v at kv + (2j + 1) * tile
  __nv_bfloat16* kv = qs + kMmaBlockQ * S::kLd;
  constexpr int kTile = kMmaBlockK * S::kLd;

  const int q0 = blockIdx.x * kMmaBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lq = p.lq, kend = p.kend, D = p.d;
  const long long k_rs = p.st[kK][2], v_rs = p.st[kV][2];
  const auto* qg =
      plane<const __nv_bfloat16>(p.in[kQ], p.st[kQ][0], p.st[kQ][1], b, h);
  const auto* kg =
      plane<const __nv_bfloat16>(p.in[kK], p.st[kK][0], p.st[kK][1], b, h);
  const auto* vg =
      plane<const __nv_bfloat16>(p.in[kV], p.st[kV][0], p.st[kV][1], b, h);

  // the q tile and the first k/v tile, in flight together
  load_tile<kMmaBlockQ, DP>(qs, qg, p.st[kQ][2], q0, lq, D, vec);
  load_tile<kMmaBlockK, DP>(kv, kg, k_rs, 0, kend, D, vec);
  load_tile<kMmaBlockK, DP>(kv + kTile, vg, v_rs, 0, kend, D, vec);
  cp_async_commit();
  const int wr = warp * 16;                     // the warp's first row
  // a warp whose rows all lie past Lq only helps load the tiles
  const bool active = q0 + wr < lq;
  const __nv_bfloat16* qw = qs + (wr + g) * S::kLd + 2 * t;

  const int row0 = q0 + wr + g, row1 = row0 + 8;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[kOutTiles][4];
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const BiasT* bias_bh = nullptr;
  long long bias_rs = 0;
  if constexpr (kHasBias<BiasT>) {
    bias_bh = plane<const BiasT>(p.bias, p.st[kBias][0], p.st[kBias][1], b, h);
    bias_rs = p.st[kBias][2];
  }

  const int n_tiles = (kend + kMmaBlockK - 1) / kMmaBlockK;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kMmaBlockK;
    if (it + 1 < n_tiles) {       // the next tile loads while this one runs
      __nv_bfloat16* nxt = kv + 2 * ((it + 1) & 1) * kTile;
      load_tile<kMmaBlockK, DP>(nxt, kg, k_rs, k0 + kMmaBlockK, kend, D, vec);
      load_tile<kMmaBlockK, DP>(nxt + kTile, vg, v_rs, k0 + kMmaBlockK, kend,
                                D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();              // tile `it` (and q) visible to all warps
    const __nv_bfloat16* ks = kv + 2 * (it & 1) * kTile;
    const __nv_bfloat16* vs = ks + kTile;
    if (active) {
      float s[kScoreTiles][4];
#pragma unroll
      for (int n = 0; n < kScoreTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t qa[4];
        qa[0] = ld_pair(qw + kk * 16);
        qa[1] = ld_pair(qw + 8 * S::kLd + kk * 16);
        qa[2] = ld_pair(qw + kk * 16 + 8);
        qa[3] = ld_pair(qw + 8 * S::kLd + kk * 16 + 8);
#pragma unroll
        for (int n = 0; n < kScoreTiles; ++n) {
          const __nv_bfloat16* kp = ks + (n * 8 + g) * S::kLd + kk * 16 + 2 * t;
          mma_16816(s[n], qa, ld_pair(kp), ld_pair(kp + 8));
        }
      }

      // scale, bias, mask; running max over the quad that shares a row
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < kScoreTiles; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + n * 8 + 2 * t + (i & 1);
          const int row = i < 2 ? row0 : row1;
          float x = s[n][i] * p.scale;
          if constexpr (kHasBias<BiasT>) {
            if (key < kend && row < lq)
              x += to_float(bias_bh[(long long)row * bias_rs + key]);
          }
          x = key < kend ? x : -INFINITY;
          s[n][i] = x;
          if (i < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float e0 = exp_ref(mn0), e1 = exp_ref(mn1);
      const float alpha0 = expf(m0 - e0), alpha1 = expf(m1 - e1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < kScoreTiles; ++n) {
        s[n][0] = expf(s[n][0] - e0);
        s[n][1] = expf(s[n][1] - e0);
        s[n][2] = expf(s[n][2] - e1);
        s[n][3] = expf(s[n][3] - e1);
        sum0 += s[n][0] + s[n][1];
        sum1 += s[n][2] + s[n][3];
      }
      l0 = l0 * alpha0 + sum0;   // this lane's part; the quad sums at the end
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int n = 0; n < kOutTiles; ++n) {
        o[n][0] *= alpha0;
        o[n][1] *= alpha0;
        o[n][2] *= alpha1;
        o[n][3] *= alpha1;
      }

      // o += p . v: two score n-tiles form one A fragment of 16 keys
#pragma unroll
      for (int kk = 0; kk < kMmaBlockK / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const __nv_bfloat16* vrow = vs + (kk * 16 + (lane & 15)) * S::kLd;
#pragma unroll
        for (int n = 0; n < kOutTiles; ++n) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, vrow + n * 8);
          mma_16816(o[n], pa, b0, b1);
        }
      }
    }
    __syncthreads();              // buffer it & 1 is refilled next
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  // a row with no finite score has l == 0 and gives zeros
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  auto* og = plane<__nv_bfloat16>(p.out, p.st[kO][0], p.st[kO][1], b, h);
  const long long o_rs = p.st[kO][2];
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i < 2 ? row0 : row1;
      const int d = n * 8 + 2 * t + (i & 1);
      if (row < lq && d < D)
        og[(long long)row * o_rs + d] =
            __float2bfloat16(o[n][i] * (i < 2 ? inv0 : inv1));
    }
  }
}

template <int DP, typename BiasT>
cudaError_t launch_mma(const Params& p, int B, int H, cudaStream_t stream) {
  // 16-byte copies need D, every stride of q/k/v and their bases to be
  // multiples of 8 elements (16 bytes)
  bool vec = p.d % 8 == 0;
  for (int o = kQ; o <= kV; ++o) {
    vec = vec && reinterpret_cast<uintptr_t>(p.in[o]) % 16 == 0;
    for (int j = 0; j < 3; ++j) vec = vec && p.st[o][j] % 8 == 0;
  }
  auto kern = attention_fwd_mma_kernel<DP, BiasT>;
  const size_t smem = MmaSmem<DP>::kBytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.lq + kMmaBlockQ - 1) / kMmaBlockQ, H, B);
  kern<<<grid, kMmaWarps * 32, smem, stream>>>(p, vec);
  return cudaGetLastError();
}

template <typename BiasT>
cudaError_t dispatch_mma(const Params& p, int B, int H, cudaStream_t s) {
  switch ((p.d + 15) / 16) {
#define VAST_ATTN_CASE(N) \
  case N:                 \
    return launch_mma<16 * N, BiasT>(p, B, H, s);
    VAST_ATTN_CASE(1) VAST_ATTN_CASE(2) VAST_ATTN_CASE(3)
    VAST_ATTN_CASE(4) VAST_ATTN_CASE(5) VAST_ATTN_CASE(6)
    VAST_ATTN_CASE(7) VAST_ATTN_CASE(8)
#undef VAST_ATTN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------

constexpr int kRowsPerWarp = 8;
constexpr int kWarps = 8;
constexpr int kBlockQ = kRowsPerWarp * kWarps;  // 64 query rows per block
constexpr int kBlockK = 32;                     // keys per tile, one per lane
constexpr int kDimsPerLane = kMaxD / 32;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <typename BiasT>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_fp32_kernel(const Params p) {
  const int D = p.d, lq = p.lq, kend = p.kend;
  extern __shared__ float smem[];
  float* qs = smem;                       // [kBlockQ][D]
  float* ks = qs + kBlockQ * D;           // [kBlockK][D + 1], odd stride
  float* vs = ks + kBlockK * (D + 1);     // [kBlockK][D]

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float* qg =
      plane<const float>(p.in[kQ], p.st[kQ][0], p.st[kQ][1], b, h);
  const float* kg =
      plane<const float>(p.in[kK], p.st[kK][0], p.st[kK][1], b, h);
  const float* vg =
      plane<const float>(p.in[kV], p.st[kV][0], p.st[kV][1], b, h);
  const long long q_rs = p.st[kQ][2], k_rs = p.st[kK][2], v_rs = p.st[kV][2];

  for (int i = tid; i < kBlockQ * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    const int q = q0 + r;
    qs[i] = q < lq ? qg[(long long)q * q_rs + d] : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], o[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) o[r][c] = 0.f;
  }
  const BiasT* bias_bh = nullptr;
  long long bias_rs = 0;
  if constexpr (kHasBias<BiasT>) {
    bias_bh = plane<const BiasT>(p.bias, p.st[kBias][0], p.st[kBias][1], b, h);
    bias_rs = p.st[kBias][2];
  }
  const float* qw = qs + warp * kRowsPerWarp * D;

  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and q is loaded)
    for (int i = tid; i < kBlockK * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D;
      const int key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < kend) {
        kx = kg[(long long)key * k_rs + d];
        vx = vg[(long long)key * v_rs + d];
      }
      ks[j * (D + 1) + d] = kx;
      vs[j * D + d] = vx;
    }
    __syncthreads();

    const int key = k0 + lane;
    const bool valid = key < kend;
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* kr = ks + lane * (D + 1);
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        s[r] = fmaf(qw[r * D + d], kd, s[r]);
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int q = q0 + warp * kRowsPerWarp + r;
      float x = s[r] * p.scale;
      if constexpr (kHasBias<BiasT>) {
        if (valid && q < lq) x += to_float(bias_bh[(long long)q * bias_rs + key]);
      }
      x = valid ? x : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float e = exp_ref(m_new);
      const float pr = expf(x - e);
      const float alpha = expf(m[r] - e);
      l[r] = l[r] * alpha + warp_sum(pr);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kDimsPerLane; ++c) o[r][c] *= alpha;
      s[r] = pr;
    }

    const int jn = min(kBlockK, kend - k0);
    for (int j = 0; j < jn; ++j) {
      const float* vr = vs + j * D;
      float vd[kDimsPerLane];
#pragma unroll
      for (int c = 0; c < kDimsPerLane; ++c) {
        const int d = lane + 32 * c;
        vd[c] = d < D ? vr[d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pr = __shfl_sync(kFull, s[r], j);
#pragma unroll
        for (int c = 0; c < kDimsPerLane; ++c) o[r][c] = fmaf(pr, vd[c], o[r][c]);
      }
    }
  }

  float* og = plane<float>(p.out, p.st[kO][0], p.st[kO][1], b, h);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int q = q0 + warp * kRowsPerWarp + r;
    if (q >= lq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    float* orow = og + (long long)q * p.st[kO][2];
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) orow[d] = o[r][c] * inv;
    }
  }
}

template <typename BiasT>
cudaError_t launch_fp32(const Params& p, int B, int H, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kBlockQ * p.d + (size_t)kBlockK * (p.d + 1) +
                       (size_t)kBlockK * p.d);
  auto kern = attention_fwd_fp32_kernel<BiasT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.lq + kBlockQ - 1) / kBlockQ, H, B);
  kern<<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// Backward of the token-major kernel: dqkv (and ds) from (qkv, o, do)
// ---------------------------------------------------------------------
//
// Replaces _tmajor_bwd_kernel (vast_tpu/ops/flash_attention.py:795) and
// _tmajor_bwd_kernel_bias (:841), wrapper self_attention_tmajor_bwd
// (:898). Per (batch b, head h), in fp32 from the inputs:
//   s = (q . k^T) * scale [+ bias], keys >= kend masked, p = softmax(s)
//   delta = rowsum(do . o),   ds = p * (do . v^T - delta)
//   dv = p^T . do,   dk = ds^T . q * scale,   dq = ds . k * scale
// ds is the cotangent of the score before the scale, so with a bias it is
// also the bias's (dbias, written in the bias type, full batch: a shared
// bias is summed over the batch by the caller).
//
// What bounds it on an H100: five L x L x D products per (b, h), 10 L^2 D
// FLOP, against qkv + o + do read and dqkv written: about L/3 FLOP per
// byte at EVA's shape (L 257), below the bf16 ridge, so bytes set the
// floor, as for the forward. What the design does about it: the Pallas
// kernel held whole L x L score tiles per head in VMEM; here no score
// reaches device memory (except ds as dbias, which is an output). An
// FA2-style split into two kernels, with no atomics, so the gradients are
// deterministic:
// * dQ: one block per (query tile of 64, head, batch). It computes delta
//   for its rows from o and do, sweeps the keys once for the row max and
//   sum (the lse, kept in registers), then once more for p, dp, ds and
//   dq, writing ds into dbias (each (row, key) is seen once here). It
//   stores lse and delta, (B, H, L) fp32 scratch, for the second kernel.
// * dK/dV: one block per (key tile of 64, head, batch), looping over the
//   query tiles, recomputing p from the stored lse; dk and dv accumulate
//   in registers.
// So the forward saves nothing beyond its output, as in vast_tpu; with s
// and dp recomputed in both kernels and s once more for the lse, that is
// eight L x L x D products (16 L^2 D FLOP) where five would do.
// bf16: mma.sync m16n8k16 with fp32 accumulators, 4 warps x 16 rows,
// streamed tiles of 32 rows, D padded to DP in shared memory only, loads
// masked at L, kend and D as in the forward. p and ds are rounded to bf16
// as the A operands of their products, as the Pallas kernel casts them.
// fp32: CUDA cores, one lane per streamed row, as the fp32 forward.

constexpr int kBwdWarps = 4;
constexpr int kBwdRows = 16 * kBwdWarps;  // rows a block owns (64)
constexpr int kBwdInner = 32;             // rows of a streamed tile

struct BwdParams {
  const void* qkv;      // (B, L, H*3*D), each head's [q | k | v]
  const void* o;        // (B, L, H*D)
  const void* dout;     // (B, L, H*D)
  const void* bias;     // (B or 1, H, L, L) or null
  void* dqkv;           // as qkv
  void* dbias;          // (B, H, L, L) or null
  float* lse;           // (B, H, L) scratch: written by dQ, read by dK/dV
  float* delta;         // (B, H, L) scratch, likewise
  long long bias_bs;    // batch stride of the bias (0: shared)
  int B, L, H, D, kend;
  float scale;
};

template <int DP>
struct BwdSmem {
  static constexpr int kLd = DP + 8;
  // two tiles of kBwdRows and two of kBwdInner rows, and two fp32 rows
  static constexpr size_t kBytes =
      sizeof(__nv_bfloat16) * (2 * kBwdRows + 2 * kBwdInner) * kLd +
      sizeof(float) * 2 * kBwdInner;
};

// acc (16 x NT*8, C layout) += A . B^T with A the warp's 16 rows at `a`
// and B the NT*8 rows at `bs`, both [row][d] tiles DP (+8) wide
template <int DP, int NT>
__device__ __forceinline__ void mma_abt(float acc[NT][4],
                                        const __nv_bfloat16* a,
                                        const __nv_bfloat16* bs, int g,
                                        int t) {
  constexpr int kLd = DP + 8;
  const __nv_bfloat16* aw = a + g * kLd + 2 * t;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t fa[4];
    fa[0] = ld_pair(aw + kk * 16);
    fa[1] = ld_pair(aw + 8 * kLd + kk * 16);
    fa[2] = ld_pair(aw + kk * 16 + 8);
    fa[3] = ld_pair(aw + 8 * kLd + kk * 16 + 8);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const __nv_bfloat16* bp = bs + (n * 8 + g) * kLd + kk * 16 + 2 * t;
      mma_16816(acc[n], fa, ld_pair(bp), ld_pair(bp + 8));
    }
  }
}

// acc (16 x DP, C layout) += X . Y with X (16 x NT*8) in C-layout
// registers, rounded to bf16, and Y the NT*8 rows of a [row][d] tile
template <int DP, int NT>
__device__ __forceinline__ void mma_cy(float acc[DP / 8][4],
                                       float x[NT][4],
                                       const __nv_bfloat16* ys, int lane) {
  constexpr int kLd = DP + 8;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t fa[4];
    fa[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    fa[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    fa[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    fa[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const __nv_bfloat16* yrow = ys + (kk * 16 + (lane & 15)) * kLd;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, yrow + n * 8);
      mma_16816(acc[n], fa, b0, b1);
    }
  }
}

// rows row0 and row0 + 8 of a C-layout accumulator, times mul, into a
// plane with row stride rs; rows >= rend and columns >= D are not stored
template <int DP, typename T>
__device__ __forceinline__ void store_acc(T* dst, long long rs,
                                          float acc[DP / 8][4],
                                          int row0, int rend, int D,
                                          float mul, int t) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i < 2 ? row0 : row0 + 8;
      const int d = n * 8 + 2 * t + (i & 1);
      if (row < rend && d < D) {
        if constexpr (std::is_same<T, float>::value)
          dst[(long long)row * rs + d] = acc[n][i] * mul;
        else
          dst[(long long)row * rs + d] = __float2bfloat16(acc[n][i] * mul);
      }
    }
  }
}

__device__ __forceinline__ void to_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void to_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// the planes of head h of batch row b: q (k at +D, v at +2D) in qkv, and
// the (B, L, H*D) o / do
template <typename T>
struct BwdPlanes {
  const T* q;
  const T* o;
  const T* dout;
  T* dq;
  long long rs3, rs1;   // row strides of qkv and of o
  __device__ BwdPlanes(const BwdParams& p, int b, int h) {
    rs3 = 3LL * p.H * p.D;
    rs1 = (long long)p.H * p.D;
    q = static_cast<const T*>(p.qkv) + b * p.L * rs3 + 3LL * h * p.D;
    dq = static_cast<T*>(p.dqkv) + b * p.L * rs3 + 3LL * h * p.D;
    o = static_cast<const T*>(p.o) + b * p.L * rs1 + (long long)h * p.D;
    dout = static_cast<const T*>(p.dout) + b * p.L * rs1 + (long long)h * p.D;
  }
};

template <typename BiasT>
__device__ __forceinline__ const BiasT* bias_plane(const BwdParams& p, int b,
                                                   int h) {
  return static_cast<const BiasT*>(p.bias) + b * p.bias_bs +
         (long long)h * p.L * p.L;
}

template <typename BiasT>
__device__ __forceinline__ BiasT* dbias_plane(const BwdParams& p, int b,
                                              int h) {
  return static_cast<BiasT*>(p.dbias) +
         ((long long)b * p.H + h) * p.L * p.L;
}

template <int DP, typename BiasT>
__global__ void __launch_bounds__(kBwdWarps * 32)
attention_bwd_dq_mma_kernel(const BwdParams p, bool vec) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = BwdSmem<DP>::kLd;
  constexpr int kNT = kBwdInner / 8;            // n-tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kBwdRows * kLd;
  bf16* ks = dos + kBwdRows * kLd;
  bf16* vs = ks + kBwdInner * kLd;

  const int q0 = blockIdx.x * kBwdRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int L = p.L, D = p.D, kend = p.kend;
  const BwdPlanes<bf16> pl(p, b, h);
  const bf16* kg = pl.q + D;
  const bf16* vg = pl.q + 2 * D;

  load_tile<kBwdRows, DP>(qs, pl.q, pl.rs3, q0, L, D, vec);
  load_tile<kBwdRows, DP>(dos, pl.dout, pl.rs1, q0, L, D, vec);
  cp_async_commit();

  const int wr = warp * 16;
  const bool active = q0 + wr < L;
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const long long stat0 = ((long long)b * p.H + h) * L;

  // delta of the warp's 16 rows, from do and o in device memory
  float delta0 = 0.f, delta1 = 0.f;
  if (active) {
    for (int r = 0; r < 16; ++r) {
      const int row = q0 + wr + r;
      float acc = 0.f;
      if (row < L)
        for (int d = lane; d < D; d += 32)
          acc += __bfloat162float(pl.dout[row * pl.rs1 + d]) *
                 __bfloat162float(pl.o[row * pl.rs1 + d]);
      acc = warp_sum(acc);
      if (r == g) delta0 = acc;
      if (r == g + 8) delta1 = acc;
      if (lane == 0 && row < L) p.delta[stat0 + row] = acc;
    }
  }

  const BiasT* bias_bh = nullptr;
  BiasT* dbias_bh = nullptr;
  if constexpr (kHasBias<BiasT>) {
    bias_bh = bias_plane<BiasT>(p, b, h);
    dbias_bh = dbias_plane<BiasT>(p, b, h);
  }
  // scaled, biased and masked scores of a tile of keys from k0
  auto scores = [&](float s[kNT][4], int k0) {
#pragma unroll
    for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    mma_abt<DP, kNT>(s, qs + wr * kLd, ks, g, t);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + n * 8 + 2 * t + (i & 1);
        const int row = i < 2 ? row0 : row1;
        float x = s[n][i] * p.scale;
        if constexpr (kHasBias<BiasT>) {
          if (key < kend && row < L)
            x += to_float(bias_bh[(long long)row * L + key]);
        }
        s[n][i] = key < kend ? x : -INFINITY;
      }
    }
  };

  // sweep 1: the row max and sum, hence the lse
  const int n_tiles = (kend + kBwdInner - 1) / kBwdInner;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBwdInner;
    __syncthreads();                  // the previous tile is consumed
    load_tile<kBwdInner, DP>(ks, kg, pl.rs3, k0, kend, D, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    float s[kNT][4];
    scores(s, k0);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float e0 = exp_ref(mn0), e1 = exp_ref(mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      sum0 += expf(s[n][0] - e0) + expf(s[n][1] - e0);
      sum1 += expf(s[n][2] - e1) + expf(s[n][3] - e1);
    }
    l0 = l0 * expf(m0 - e0) + sum0;
    l1 = l1 * expf(m1 - e1) + sum1;
    m0 = mn0;
    m1 = mn1;
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  // a row with no finite score gets lse = +inf, so its p is 0
  const float lse0 = l0 > 0.f ? exp_ref(m0) + logf(l0) : INFINITY;
  const float lse1 = l1 > 0.f ? exp_ref(m1) + logf(l1) : INFINITY;
  if (active && t == 0) {
    if (row0 < L) p.lse[stat0 + row0] = lse0;
    if (row1 < L) p.lse[stat0 + row1] = lse1;
  }

  // sweep 2: p, dp = do . v^T, ds, dq += ds . k
  float dq[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBwdInner;
    __syncthreads();
    load_tile<kBwdInner, DP>(ks, kg, pl.rs3, k0, kend, D, vec);
    load_tile<kBwdInner, DP>(vs, vg, pl.rs3, k0, kend, D, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    float s[kNT][4], dpv[kNT][4];
    scores(s, k0);
#pragma unroll
    for (int n = 0; n < kNT; ++n) dpv[n][0] = dpv[n][1] = dpv[n][2] = dpv[n][3] = 0.f;
    mma_abt<DP, kNT>(dpv, dos + wr * kLd, vs, g, t);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + n * 8 + 2 * t + (i & 1);
        const int row = i < 2 ? row0 : row1;
        const float pr = expf(s[n][i] - (i < 2 ? lse0 : lse1));
        const float ds = pr * (dpv[n][i] - (i < 2 ? delta0 : delta1));
        if constexpr (kHasBias<BiasT>) {
          if (row < L && key < L)
            to_out(dbias_bh + (long long)row * L + key, ds);
        }
        s[n][i] = ds;
      }
    }
    mma_cy<DP, kNT>(dq, s, ks, lane);
  }
  if (active) store_acc<DP>(pl.dq, pl.rs3, dq, row0, L, D, p.scale, t);
}

template <int DP, typename BiasT>
__global__ void __launch_bounds__(kBwdWarps * 32)
attention_bwd_dkv_mma_kernel(const BwdParams p, bool vec) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = BwdSmem<DP>::kLd;
  constexpr int kNT = kBwdInner / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kBwdRows * kLd;
  bf16* qs = vs + kBwdRows * kLd;
  bf16* dos = qs + kBwdInner * kLd;
  float* lse_s = reinterpret_cast<float*>(dos + kBwdInner * kLd);
  float* delta_s = lse_s + kBwdInner;

  const int k0 = blockIdx.x * kBwdRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int L = p.L, D = p.D, kend = p.kend;
  const BwdPlanes<bf16> pl(p, b, h);
  const long long stat0 = ((long long)b * p.H + h) * L;

  load_tile<kBwdRows, DP>(ks, pl.q + D, pl.rs3, k0, kend, D, vec);
  load_tile<kBwdRows, DP>(vs, pl.q + 2 * D, pl.rs3, k0, kend, D, vec);
  cp_async_commit();

  const int wr = warp * 16;
  // keys in [kend, L) get dk = dv = 0 (their p is 0), so they are stored
  const bool active = k0 + wr < L;
  const int key0 = k0 + wr + g, key1 = key0 + 8;
  const BiasT* bias_bh = nullptr;
  if constexpr (kHasBias<BiasT>) bias_bh = bias_plane<BiasT>(p, b, h);

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  const int n_tiles = (L + kBwdInner - 1) / kBwdInner;
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = it * kBwdInner;
    __syncthreads();
    load_tile<kBwdInner, DP>(qs, pl.q, pl.rs3, q0, L, D, vec);
    load_tile<kBwdInner, DP>(dos, pl.dout, pl.rs1, q0, L, D, vec);
    cp_async_commit();
    for (int i = threadIdx.x; i < kBwdInner; i += blockDim.x) {
      const int q = q0 + i;
      lse_s[i] = q < L ? p.lse[stat0 + q] : INFINITY;
      delta_s[i] = q < L ? p.delta[stat0 + q] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    // transposed tiles: rows are this warp's keys, columns queries
    float st[kNT][4], dpt[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
      dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
    }
    mma_abt<DP, kNT>(st, ks + wr * kLd, qs, g, t);
    mma_abt<DP, kNT>(dpt, vs + wr * kLd, dos, g, t);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = n * 8 + 2 * t + (i & 1);
        const int q = q0 + qi;
        const int key = i < 2 ? key0 : key1;
        float pr = 0.f;
        if (key < kend && q < L) {
          float x = st[n][i] * p.scale;
          if constexpr (kHasBias<BiasT>)
            x += to_float(bias_bh[(long long)q * L + key]);
          pr = expf(x - lse_s[qi]);
        }
        st[n][i] = pr;
        dpt[n][i] = pr * (dpt[n][i] - delta_s[qi]);
      }
    }
    mma_cy<DP, kNT>(dv, st, dos, lane);
    mma_cy<DP, kNT>(dk, dpt, qs, lane);
  }
  if (active) {
    store_acc<DP>(pl.dq + D, pl.rs3, dk, key0, L, D, p.scale, t);
    store_acc<DP>(pl.dq + 2 * D, pl.rs3, dv, key0, L, D, 1.f, t);
  }
}

template <int DP, typename BiasT>
cudaError_t launch_bwd_mma(const BwdParams& p, cudaStream_t stream) {
  bool vec = p.D % 8 == 0;
  const void* const bases[3] = {p.qkv, p.o, p.dout};
  for (const void* ptr : bases)
    vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  const size_t smem = BwdSmem<DP>::kBytes;
  auto dq_kern = attention_bwd_dq_mma_kernel<DP, BiasT>;
  auto dkv_kern = attention_bwd_dkv_mma_kernel<DP, BiasT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          dkv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.L + kBwdRows - 1) / kBwdRows, p.H, p.B);
  dq_kern<<<grid, kBwdWarps * 32, smem, stream>>>(p, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kern<<<grid, kBwdWarps * 32, smem, stream>>>(p, vec);
  return cudaGetLastError();
}

template <typename BiasT>
cudaError_t dispatch_bwd_mma(const BwdParams& p, cudaStream_t s) {
  switch ((p.D + 15) / 16) {
#define VAST_BWD_CASE(N) \
  case N:                \
    return launch_bwd_mma<16 * N, BiasT>(p, s);
    VAST_BWD_CASE(1) VAST_BWD_CASE(2) VAST_BWD_CASE(3)
    VAST_BWD_CASE(4) VAST_BWD_CASE(5) VAST_BWD_CASE(6)
    VAST_BWD_CASE(7) VAST_BWD_CASE(8)
#undef VAST_BWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// fp32 backward on CUDA cores: 8 warps x 8 rows a block, streamed tiles of
// 32 rows with one lane per streamed row; each lane owns the head dims
// lane + 32c of its accumulators

constexpr int kF32BwdRows = kRowsPerWarp * kWarps;   // 64

template <typename BiasT>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dq_fp32_kernel(const BwdParams p) {
  const int D = p.D, L = p.L, kend = p.kend;
  extern __shared__ float smem[];
  float* qs = smem;                          // [64][D]
  float* dos = qs + kF32BwdRows * D;         // [64][D]
  float* ks = dos + kF32BwdRows * D;         // [32][D + 1]
  float* vs = ks + kBlockK * (D + 1);        // [32][D + 1]

  const int q0 = blockIdx.x * kF32BwdRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const BwdPlanes<float> pl(p, b, h);
  const float* kg = pl.q + D;
  const float* vg = pl.q + 2 * D;
  const long long stat0 = ((long long)b * p.H + h) * L;

  for (int i = tid; i < kF32BwdRows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D, q = q0 + r;
    qs[i] = q < L ? pl.q[q * pl.rs3 + d] : 0.f;
    dos[i] = q < L ? pl.dout[q * pl.rs1 + d] : 0.f;
  }
  __syncthreads();
  const int wr = warp * kRowsPerWarp;
  const float* qw = qs + wr * D;
  const float* dow = dos + wr * D;
  float delta[kRowsPerWarp], m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int q = q0 + wr + r;
    float acc = 0.f;
    if (q < L)
      for (int d = lane; d < D; d += 32) acc += dow[r * D + d] * pl.o[q * pl.rs1 + d];
    delta[r] = warp_sum(acc);
    if (lane == 0 && q < L) p.delta[stat0 + q] = delta[r];
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  const BiasT* bias_bh = nullptr;
  BiasT* dbias_bh = nullptr;
  if constexpr (kHasBias<BiasT>) {
    bias_bh = bias_plane<BiasT>(p, b, h);
    dbias_bh = dbias_plane<BiasT>(p, b, h);
  }
  auto score = [&](const float* kr, int r, int key) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(qw[r * D + d], kr[d], s);
    float x = s * p.scale;
    const int q = q0 + wr + r;
    if constexpr (kHasBias<BiasT>) {
      if (key < kend && q < L) x += to_float(bias_bh[(long long)q * L + key]);
    }
    return key < kend ? x : -INFINITY;
  };

  // sweep 1: row max and sum
  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    __syncthreads();
    for (int i = tid; i < kBlockK * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D, key = k0 + j;
      ks[j * (D + 1) + d] = key < kend ? kg[key * pl.rs3 + d] : 0.f;
    }
    __syncthreads();
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float x = score(ks + lane * (D + 1), r, key);
      const float m_new = fmaxf(m[r], warp_max(x));
      const float e = exp_ref(m_new);
      l[r] = l[r] * expf(m[r] - e) + warp_sum(expf(x - e));
      m[r] = m_new;
    }
  }
  float lse[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    lse[r] = l[r] > 0.f ? exp_ref(m[r]) + logf(l[r]) : INFINITY;
    const int q = q0 + wr + r;
    if (lane == 0 && q < L) p.lse[stat0 + q] = lse[r];
  }

  // sweep 2: ds and dq
  float dq[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) dq[r][c] = 0.f;
  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    __syncthreads();
    for (int i = tid; i < kBlockK * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D, key = k0 + j;
      const bool valid = key < kend;
      ks[j * (D + 1) + d] = valid ? kg[key * pl.rs3 + d] : 0.f;
      vs[j * (D + 1) + d] = valid ? vg[key * pl.rs3 + d] : 0.f;
    }
    __syncthreads();
    const int key = k0 + lane;
    const float* vr = vs + lane * (D + 1);
    float ds[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float pr = expf(score(ks + lane * (D + 1), r, key) - lse[r]);
      float dpv = 0.f;
      for (int d = 0; d < D; ++d) dpv = fmaf(dow[r * D + d], vr[d], dpv);
      ds[r] = pr * (dpv - delta[r]);
      const int q = q0 + wr + r;
      if constexpr (kHasBias<BiasT>) {
        if (q < L && key < L) dbias_bh[(long long)q * L + key] = ds[r];
      }
    }
    const int jn = min(kBlockK, kend - k0);
    for (int j = 0; j < jn; ++j) {
      const float* kr = ks + j * (D + 1);
      float kd[kDimsPerLane];
#pragma unroll
      for (int c = 0; c < kDimsPerLane; ++c) {
        const int d = lane + 32 * c;
        kd[c] = d < D ? kr[d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float dsj = __shfl_sync(kFull, ds[r], j);
#pragma unroll
        for (int c = 0; c < kDimsPerLane; ++c) dq[r][c] = fmaf(dsj, kd[c], dq[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int q = q0 + wr + r;
    if (q >= L) continue;
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) pl.dq[q * pl.rs3 + d] = dq[r][c] * p.scale;
    }
  }
}

template <typename BiasT>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dkv_fp32_kernel(const BwdParams p) {
  const int D = p.D, L = p.L, kend = p.kend;
  extern __shared__ float smem[];
  float* ks = smem;                          // [64][D]
  float* vs = ks + kF32BwdRows * D;          // [64][D]
  float* qs = vs + kF32BwdRows * D;          // [32][D + 1]
  float* dos = qs + kBlockK * (D + 1);       // [32][D + 1]
  float* lse_s = dos + kBlockK * (D + 1);    // [32]
  float* delta_s = lse_s + kBlockK;          // [32]

  const int k0 = blockIdx.x * kF32BwdRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const BwdPlanes<float> pl(p, b, h);
  const long long stat0 = ((long long)b * p.H + h) * L;
  for (int i = tid; i < kF32BwdRows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D, key = k0 + r;
    const bool valid = key < kend;
    ks[i] = valid ? pl.q[key * pl.rs3 + D + d] : 0.f;
    vs[i] = valid ? pl.q[key * pl.rs3 + 2 * D + d] : 0.f;
  }
  const int wr = warp * kRowsPerWarp;
  const BiasT* bias_bh = nullptr;
  if constexpr (kHasBias<BiasT>) bias_bh = bias_plane<BiasT>(p, b, h);

  float dk[kRowsPerWarp][kDimsPerLane], dv[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) dk[r][c] = dv[r][c] = 0.f;
  for (int q0 = 0; q0 < L; q0 += kBlockK) {
    __syncthreads();
    for (int i = tid; i < kBlockK * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D, q = q0 + j;
      const bool valid = q < L;
      qs[j * (D + 1) + d] = valid ? pl.q[q * pl.rs3 + d] : 0.f;
      dos[j * (D + 1) + d] = valid ? pl.dout[q * pl.rs1 + d] : 0.f;
    }
    for (int i = tid; i < kBlockK; i += blockDim.x) {
      const int q = q0 + i;
      lse_s[i] = q < L ? p.lse[stat0 + q] : INFINITY;
      delta_s[i] = q < L ? p.delta[stat0 + q] : 0.f;
    }
    __syncthreads();
    const int q = q0 + lane;
    const float* qr = qs + lane * (D + 1);
    const float* dor = dos + lane * (D + 1);
    float pr[kRowsPerWarp], ds[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int key = k0 + wr + r;
      const float* kr = ks + (wr + r) * D;
      const float* vr = vs + (wr + r) * D;
      float s = 0.f, dpv = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(kr[d], qr[d], s);
        dpv = fmaf(vr[d], dor[d], dpv);
      }
      float x = 0.f;
      if (key < kend && q < L) {
        x = s * p.scale;
        if constexpr (kHasBias<BiasT>) x += to_float(bias_bh[(long long)q * L + key]);
        x = expf(x - lse_s[lane]);
      }
      pr[r] = x;
      ds[r] = x * (dpv - delta_s[lane]);
    }
    const int in = min(kBlockK, L - q0);
    for (int i = 0; i < in; ++i) {
      float qd[kDimsPerLane], dod[kDimsPerLane];
#pragma unroll
      for (int c = 0; c < kDimsPerLane; ++c) {
        const int d = lane + 32 * c;
        qd[c] = d < D ? qs[i * (D + 1) + d] : 0.f;
        dod[c] = d < D ? dos[i * (D + 1) + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pi = __shfl_sync(kFull, pr[r], i);
        const float dsi = __shfl_sync(kFull, ds[r], i);
#pragma unroll
        for (int c = 0; c < kDimsPerLane; ++c) {
          dv[r][c] = fmaf(pi, dod[c], dv[r][c]);
          dk[r][c] = fmaf(dsi, qd[c], dk[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int key = k0 + wr + r;
    if (key >= L) continue;
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        pl.dq[key * pl.rs3 + D + d] = dk[r][c] * p.scale;
        pl.dq[key * pl.rs3 + 2 * D + d] = dv[r][c];
      }
    }
  }
}

template <typename BiasT>
cudaError_t launch_bwd_fp32(const BwdParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)kF32BwdRows * p.D +
                                       2 * (size_t)kBlockK * (p.D + 1) +
                                       2 * (size_t)kBlockK);
  auto dq_kern = attention_bwd_dq_fp32_kernel<BiasT>;
  auto dkv_kern = attention_bwd_dkv_fp32_kernel<BiasT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          dkv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.L + kF32BwdRows - 1) / kF32BwdRows, p.H, p.B);
  dq_kern<<<grid, kWarps * 32, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kern<<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t run(const Params& p, int dtype, int bias_dtype, int B, int H,
                cudaStream_t s) {
  if (p.d < 1 || p.d > kMaxD || p.lq < 1 || p.kend < 1 || B < 1 || H < 1 ||
      B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  if (dtype == kF32) {
    if (!p.bias) return launch_fp32<NoBias>(p, B, H, s);
    if (bias_dtype == kF32) return launch_fp32<float>(p, B, H, s);
  } else if (dtype == kBf16) {
    if (!p.bias) return dispatch_mma<NoBias>(p, B, H, s);
    if (bias_dtype == kBf16) return dispatch_mma<__nv_bfloat16>(p, B, H, s);
    if (bias_dtype == kF32) return dispatch_mma<float>(p, B, H, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype codes: 0 = float32,
// 1 = bfloat16. A null bias means no bias. Each returns the cudaError_t of
// its launch.

// Token-major fused self-attention (self_attention_tmajor): qkv (B, L,
// H*3*D), each head's [q|k|v] contiguous; out (B, L, H*D); bias (B or 1,
// H, L, L) in qkv's type, batch stride 0 when shared.
extern "C" int vast_tmajor_attention_fwd(const void* qkv, const void* bias,
                                         void* out, int dtype, int B, int L,
                                         int H, int D, int kend,
                                         long long bias_batch_stride,
                                         float scale, void* stream) {
  if (kend > L || (dtype != kF32 && dtype != kBf16))
    return (int)cudaErrorInvalidValue;
  const long long es = dtype == kF32 ? 4 : 2, row = 3LL * H * D;
  Params p = {};
  for (int o = kQ; o <= kV; ++o) {
    p.in[o] = static_cast<const char*>(qkv) + o * D * es;
    p.st[o][0] = L * row;
    p.st[o][1] = 3LL * D;
    p.st[o][2] = row;
  }
  p.st[kO][0] = (long long)L * H * D;
  p.st[kO][1] = D;
  p.st[kO][2] = (long long)H * D;
  p.st[kBias][0] = bias_batch_stride;
  p.st[kBias][1] = (long long)L * L;
  p.st[kBias][2] = L;
  p.out = out;
  p.bias = bias;
  p.lq = L;
  p.kend = kend;
  p.d = D;
  p.scale = scale;
  return (int)run(p, dtype, dtype, B, H, static_cast<cudaStream_t>(stream));
}

// Head-major attention (flash_attention): q (B, H, Lq, D), k and v (B, H,
// Lk, D), out (B, H, Lq, D) and bias (B, H, Lq, Lk), each through
// ``strides``: 15 element strides, (batch, head, row) of q, k, v, out and
// bias in that order (the last axis of each is contiguous; 0 broadcasts).
// Keys >= kend are masked.
extern "C" int vast_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, const void* bias,
                                        void* out, int dtype, int bias_dtype,
                                        int B, int H, int Lq, int D, int kend,
                                        const long long* strides, float scale,
                                        void* stream) {
  Params p = {};
  p.in[kQ] = q;
  p.in[kK] = k;
  p.in[kV] = v;
  memcpy(p.st, strides, sizeof(p.st));
  p.out = out;
  p.bias = bias;
  p.lq = Lq;
  p.kend = kend;
  p.d = D;
  p.scale = scale;
  return (int)run(p, dtype, bias_dtype, B, H,
                  static_cast<cudaStream_t>(stream));
}

// Backward of the token-major attention (self_attention_tmajor_bwd): from
// qkv, o (the forward's output) and dout (its cotangent), all (B, L, ...)
// as above, writes dqkv in qkv's fused per-head [dq | dk | dv] layout and
// type and, with a bias, dbias = ds, (B, H, L, L) in the bias's type
// (qkv's). lse and delta are (B, H, L) fp32 scratch. Keys >= kend are
// masked and get dk = dv = 0; dbias is not written past the last 32-key
// tile that holds a key < kend, so the caller zero-fills it when kend < L.
// Two launches (dQ, then dK/dV); returns the first error.
extern "C" int vast_tmajor_attention_bwd(const void* qkv, const void* o,
                                         const void* dout, const void* bias,
                                         void* dqkv, void* dbias, float* lse,
                                         float* delta, int dtype, int B,
                                         int L, int H, int D, int kend,
                                         long long bias_batch_stride,
                                         float scale, void* stream) {
  if (D < 1 || D > kMaxD || L < 1 || kend < 1 || kend > L || B < 1 ||
      H < 1 || B > 65535 || H > 65535 || (bias == nullptr) != (dbias == nullptr))
    return (int)cudaErrorInvalidValue;
  const BwdParams p = {qkv,   o,     dout, bias, dqkv, dbias, lse, delta,
                       bias_batch_stride, B, L, H, D, kend, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)(bias ? launch_bwd_fp32<float>(p, s)
                      : launch_bwd_fp32<NoBias>(p, s));
  if (dtype == kBf16)
    return (int)(bias ? dispatch_bwd_mma<__nv_bfloat16>(p, s)
                      : dispatch_bwd_mma<NoBias>(p, s));
  return (int)cudaErrorInvalidValue;
}
