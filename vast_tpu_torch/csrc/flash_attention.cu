// Attention forward kernels for Hopper (sm_90a).
//
// Replaces these Pallas kernels of vast_tpu/ops/flash_attention.py:
//   _tmajor_fwd_kernel       (:762, wrapper self_attention_tmajor :851)
//   _tmajor_fwd_kernel_bias  (:789, the same with an additive score bias)
//   _single_kernel_nolse     (:87, wrapper flash_attention :156; the
//                             head-major forward without the lse output)
// One kernel body serves all three: it reads q, k, v, the output and the
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
// Two kernels:
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
