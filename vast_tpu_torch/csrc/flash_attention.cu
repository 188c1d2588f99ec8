// Attention kernels for Hopper (sm_90a).
//
// Replaces these Pallas kernels of vast_tpu/ops/flash_attention.py:
//   _tmajor_fwd_kernel       (:762, wrapper self_attention_tmajor :851)
//   _tmajor_fwd_kernel_bias  (:789, the same with an additive score bias)
//   _single_kernel_nolse     (:87, wrapper flash_attention :156; the
//                             head-major forward without the lse output)
//   _single_kernel           (:52, the same with the lse output)
//   _looped_kernel_nolse / _looped_kernel (:137 / :94, the same at
//                             Lk > 4096: every Lk streams alike here);
//                             in bf16 these six have a body of their own
//                             for Hopper, wgmma fed by the copy engine
//                             ("The forward for Hopper" below)
//   the backward kernels, listed and described at their kernels below:
//   _tmajor_bwd_kernel(_bias) (:795, :841) and flash_attention_bwd's
//   fused and tiled kernels (:321, :363, :372, :413, :451)
// and the two of scripts/bench_tmajor_variants.py, the token-major layout
// probe: attention_dma (:78) and _sect_kernel (:118), described at their
// entries at the end of this file; in bf16 _sect_kernel runs on the
// Hopper forward body and attention_dma on a Hopper body of its own, the
// resident strip ("The layout probe's attention_dma for Hopper" below).
// Each forward body reads q, k, v, the output and the bias through (batch,
// head, row) element strides, so the token-major fused qkv layout and the
// head-major layout differ only in the strides the C entry points pass;
// each backward body serves every backward the same way. The mma.sync
// body takes its tiles from a loader: threads issuing cp.async through the
// strides, or (attention_dma's counterpart) the copy engine.
//
// Contract. Per (batch b, head h):
//   s = (q . k^T) * scale  [+ bias[b, h]]   in fp32,
// keys >= kend masked (kend = lk_true, or Lk), softmax in fp32, p . v
// accumulated in fp32, output in the input type. D <= 128 at run time
// (EVA01-g 88, BEATs and BERT 64). The bias is read through its own strides
// (a stride of 0 reads one shared (Lq, Lk) plane, never broadcast in
// memory), in the input type or in fp32. A row whose scores are all -inf
// gives zeros, as the Pallas kernel's l == 0 guard does. On request every
// forward entry also writes each row's lse = m + log(l), the backward's
// residual (+inf for such a row, so that its p is 0).
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
// the padding to the tensor-core tile lives in shared memory only. Every
// bf16 forward whose operands the copy engine can read (vast_tpu's :52,
// :87, :94, :137, :762, :789, and the probe's two) runs on wgmma with every
// tile brought by the copy engine (its section below says what bounds it
// at each path shape and what its design does about it). The other bodies
// still use mma.sync and threads' cp.async, the copy engine only at
// attention_dma's mma.sync entry; and the query tiles of one head each
// re-read its K/V (from L2).
//
// Two forward kernels besides the Hopper one:
// * bf16 (operands the copy engine cannot read): tensor cores through
//   mma.sync m16n8k16, bf16 operands and fp32 accumulators. 8 warps x 16
//   query rows; key tiles of 64, double-buffered: cp.async brings tile
//   i+1 (16 bytes a thread, when D and every stride are multiples of 8;
//   plain one-value stores otherwise) while tile i is computed. D is
//   padded to DP (a multiple of 16) in shared memory. Registers are capped
//   at 128 a thread so that 2 blocks share an SM (ptxas gave 158 at DP 96
//   uncapped); warps whose rows all lie past Lq only help load. V stays
//   row-major and its B fragments come through ldmatrix.trans. The scores
//   stay in registers, the row max/sum are reduced over each quad of
//   lanes, and the probabilities are rounded to bf16 as the A operand of
//   p . v (as the Pallas kernel casts p to v's dtype).
// * fp32: CUDA cores in full fp32 (tensor cores would round the products
//   to TF32). 8 warps x 8 query rows; in q . k^T each lane owns one key
//   of a 32-key tile, in p . v each lane owns head dims lane + 32c.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <climits>
#include <initializer_list>
#include <type_traits>

// The C entry points (at the end) fall into six parts by the bodies
// they reach: 0 the mma.sync / CUDA-core forward (run), 1 the Hopper
// forward (run_sm90), 2 the layout probe's strips (the copy engine's ring
// and the resident strip), 3 the mma.sync / CUDA-core backward (run_bwd),
// 4 the Hopper backward (run_bwd_sm90), 5 the window attention ("Window
// attention for Hopper", the last section). vast_tpu_torch/build.py compiles
// each part apart (-DVAST_PART=k), all at once, and links them into one
// library; a part defines only its entries and the dispatchers that
// instantiate their kernels. Without VAST_PART one compile defines all.
#ifdef VAST_PART
#define VAST_PART_ON(k) (VAST_PART == (k))
#else
#define VAST_PART_ON(k) 1
#endif

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
  float* lse;             // null: none; else (B, heads, lq) fp32, contiguous
  long long st[5][3];     // element strides (batch, head, row) by Operand
  int lq, kend, d, heads;
  float scale;
};

// the logsumexp of a row's scaled, biased and masked scores from its max m
// and its sum l of exp(s - m); +inf for a row with no finite score, so
// that exp(s - lse) is 0 there and not NaN
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : INFINITY;
}

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

// The bf16 forward's loader through the operands' strides: every thread
// issues cp.async copies (load_tile), rows past the sequence ends and
// columns past D zero. A loader brings the q tile with the first k/v tile
// (first), one k/v tile into a buffer while the previous one is computed
// (next), and waits for tile `it` (wait; `more`: a later one is in flight).
// The copy engine's loader, TmaTiles, is at attention_dma's counterpart.
template <int DP>
struct CpAsyncTiles {
  const __nv_bfloat16 *qg, *kg, *vg;    // the block's (b, h) planes
  long long q_rs, k_rs, v_rs;
  int lq, kend, d;
  bool vec;

  __device__ __forceinline__ void first(__nv_bfloat16* qs, __nv_bfloat16* ks,
                                        __nv_bfloat16* vs, int q0) const {
    load_tile<kMmaBlockQ, DP>(qs, qg, q_rs, q0, lq, d, vec);
    next(ks, vs, 0, 0);
  }
  __device__ __forceinline__ void next(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                       int k0, int /*stage*/) const {
    load_tile<kMmaBlockK, DP>(ks, kg, k_rs, k0, kend, d, vec);
    load_tile<kMmaBlockK, DP>(vs, vg, v_rs, k0, kend, d, vec);
    cp_async_commit();
  }
  __device__ __forceinline__ void wait(int /*it*/, bool more) const {
    if (more) cp_async_wait<1>(); else cp_async_wait<0>();
  }
};

// Fragment layouts of mma.m16n8k16 (PTX ISA), g = lane / 4, t = lane % 4:
//   A (16 x 16, row): a0 (g, 2t..2t+1) a1 (g+8, 2t..) a2 (g, 2t+8..)
//                     a3 (g+8, 2t+8..)
//   B (16 x 8, col):  b0 (k 2t..2t+1, n g) b1 (k 2t+8.., n g)
//   C (16 x 8):       c0,c1 (g, 2t, 2t+1) c2,c3 (g+8, 2t, 2t+1)
// The block's body over shared memory `smem` (MmaSmem<DP>::kBytes), its
// tiles from `tiles`.
template <int DP, typename BiasT, typename Tiles>
__device__ __forceinline__ void attention_fwd_mma(const Params& p,
                                                  const Tiles& tiles,
                                                  unsigned char* smem) {
  using S = MmaSmem<DP>;
  constexpr int kSteps = DP / 16;               // k-steps of q . k^T
  constexpr int kScoreTiles = kMmaBlockK / 8;   // n-tiles of the scores
  constexpr int kOutTiles = DP / 8;             // n-tiles of the output
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  // buffer j of k at kv + 2j * tile, of v at kv + (2j + 1) * tile
  __nv_bfloat16* kv = qs + kMmaBlockQ * S::kLd;
  constexpr int kTile = kMmaBlockK * S::kLd;

  const int q0 = blockIdx.x * kMmaBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lq = p.lq, kend = p.kend, D = p.d;

  // the q tile and the first k/v tile, in flight together
  tiles.first(qs, kv, kv + kTile, q0);
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
    const bool more = it + 1 < n_tiles;
    if (more) {                   // the next tile loads while this one runs
      __nv_bfloat16* nxt = kv + 2 * ((it + 1) & 1) * kTile;
      tiles.next(nxt, nxt + kTile, k0 + kMmaBlockK, (it + 1) & 1);
    }
    tiles.wait(it, more);
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
  if (p.lse && t == 0) {
    float* lse_bh = p.lse + ((long long)b * p.heads + h) * lq;
    if (row0 < lq) lse_bh[row0] = row_lse(m0, l0);
    if (row1 < lq) lse_bh[row1] = row_lse(m1, l1);
  }
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
__global__ void __launch_bounds__(kMmaWarps * 32, kMmaBlocksPerSm)
attention_fwd_mma_kernel(const Params p, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z;
  const CpAsyncTiles<DP> tiles{
      plane<const __nv_bfloat16>(p.in[kQ], p.st[kQ][0], p.st[kQ][1], b, h),
      plane<const __nv_bfloat16>(p.in[kK], p.st[kK][0], p.st[kK][1], b, h),
      plane<const __nv_bfloat16>(p.in[kV], p.st[kV][0], p.st[kV][1], b, h),
      p.st[kQ][2], p.st[kK][2], p.st[kV][2], p.lq, p.kend, p.d, vec};
  attention_fwd_mma<DP, BiasT>(p, tiles, smem_raw);
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

// The fp32 forward's loader through the operands' strides: plain loads by
// every thread, zero past the sequence ends. A loader brings the q tile
// (q; visible after the next __syncthreads) and a k/v tile (kv; `it`
// counts the tiles), and gives the k tile's row stride (k_ld): d + 1 here,
// odd, so that the 32 lanes, each on its own key, read 32 banks. The copy
// engine's loader, TmaF32Tiles, is at attention_dma's counterpart.
struct PlainF32Tiles {
  const float *qg, *kg, *vg;            // the block's (b, h) planes
  long long q_rs, k_rs, v_rs;
  int lq, kend, d;

  __device__ __forceinline__ int k_ld() const { return d + 1; }
  __device__ __forceinline__ void q(float* qs, int q0) const {
    for (int i = threadIdx.x; i < kBlockQ * d; i += blockDim.x) {
      const int r = i / d, c = i - r * d;
      const int row = q0 + r;
      qs[i] = row < lq ? qg[(long long)row * q_rs + c] : 0.f;
    }
  }
  __device__ __forceinline__ void kv(float* ks, float* vs, int k0,
                                     int /*it*/) const {
    for (int i = threadIdx.x; i < kBlockK * d; i += blockDim.x) {
      const int j = i / d, c = i - j * d;
      const int key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < kend) {
        kx = kg[(long long)key * k_rs + c];
        vx = vg[(long long)key * v_rs + c];
      }
      ks[j * (d + 1) + c] = kx;
      vs[j * d + c] = vx;
    }
  }
};

// The block's body over shared memory `smem`: q [kBlockQ][D], then k
// [kBlockK][k_ld], then v [kBlockK][D]; its tiles from `tiles`.
template <typename BiasT, typename Tiles>
__device__ __forceinline__ void attention_fwd_fp32(const Params& p,
                                                   const Tiles& tiles,
                                                   float* smem) {
  const int D = p.d, lq = p.lq, kend = p.kend;
  const int kld = tiles.k_ld();
  float* qs = smem;
  float* ks = qs + kBlockQ * D;
  float* vs = ks + kBlockK * kld;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  tiles.q(qs, q0);

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

  for (int k0 = 0, it = 0; k0 < kend; k0 += kBlockK, ++it) {
    __syncthreads();  // the previous tile is consumed (and q is loaded)
    tiles.kv(ks, vs, k0, it);
    __syncthreads();

    const int key = k0 + lane;
    const bool valid = key < kend;
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* kr = ks + lane * kld;
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
    if (p.lse && lane == 0)
      p.lse[((long long)b * p.heads + h) * lq + q] = row_lse(m[r], l[r]);
    float* orow = og + (long long)q * p.st[kO][2];
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) orow[d] = o[r][c] * inv;
    }
  }
}

template <typename BiasT>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_fp32_kernel(const Params p) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const PlainF32Tiles tiles{
      plane<const float>(p.in[kQ], p.st[kQ][0], p.st[kQ][1], b, h),
      plane<const float>(p.in[kK], p.st[kK][0], p.st[kK][1], b, h),
      plane<const float>(p.in[kV], p.st[kV][0], p.st[kV][1], b, h),
      p.st[kQ][2], p.st[kK][2], p.st[kV][2], p.lq, p.kend, p.d};
  attention_fwd_fp32<BiasT>(p, tiles, smem);
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
// Backward: dq, dk, dv (and ds) from (q, k, v, o, do)
// ---------------------------------------------------------------------
//
// Replaces these Pallas kernels of vast_tpu/ops/flash_attention.py:
//   _tmajor_bwd_kernel       (:795, wrapper self_attention_tmajor_bwd :898)
//   _tmajor_bwd_kernel_bias  (:841)
//   _bwd_fused_kernel_nods / _bwd_fused_kernel (:363 / :321, wrapper
//                            flash_attention_bwd :462, lq <= 512)
//   _bwd_dkv_kernel          (:372, flash_attention_bwd's tiled route)
//   _bwd_dq_kernel_nods / _bwd_dq_kernel (:451 / :413, the same route)
// Per (batch b, head h), in fp32 from the inputs:
//   s = (q . k^T) * scale [+ bias], keys >= kend masked, p = exp(s - lse)
//   delta = rowsum(do . o),   ds = p * (do . v^T - delta)
//   dv = p^T . do,   dk = ds^T . q * scale,   dq = ds . k * scale
// ds is the cotangent of the score before the scale, so with a bias it is
// also the bias's (dbias, written when asked for; a broadcast bias is
// summed over its broadcast axes by the caller). Keys >= kend get zero
// gradients. Every operand is read and written through (batch, head, row)
// strides, as in the forward, so one body serves both layouts: the
// token-major fused qkv (rows 3-4) and head-major q, k, v of any strides
// (rows 7-9; CLIP's packed in_proj output is read as it is).
//
// lse: both forwards save it (their lse output) while autograd records,
// so the backward reads it (lse_given). Called without it (the token-major
// entries' lse_given 0, as vast_tpu's token-major backward recomputes the
// statistics), the dQ kernel first sweeps the keys once for the row max
// and sum. A row with no finite score has lse = +inf and so p = 0.
//
// What bounds it on an H100: five Lq x Lk x D products per (b, h), 10 Lq
// Lk D FLOP, against q, k, v, o, do read and dq, dk, dv written: about L/3
// FLOP per byte at L = 257 and L/2.6 at CLIP's 577, below the bf16 ridge
// (~295), so bytes set the floor. What the design does about it: the
// Pallas kernels hold whole score tiles per head in VMEM (fused) or
// 512 x 512 tiles (tiled); here no score reaches device memory (except ds
// as dbias, which is an output). The VMEM choice between the fused and
// tiled routes has no counterpart: one FA2-style split into two kernels,
// with no atomics, so the gradients are deterministic:
// * dQ: one block per (query tile of 64, head, batch). It computes delta
//   for its rows from o and do (and, with no lse given, sweeps the keys
//   for the row max and sum), then sweeps the keys for p, dp, ds and dq,
//   writing ds into dbias (each (row, key) is seen once here). It stores
//   delta (and a computed lse), (B, H, Lq) fp32, for the second kernel.
// * dK/dV: one block per (key tile of 64, head, batch), looping over the
//   query tiles, recomputing p from the lse; dk and dv accumulate in
//   registers.
// s and dp are recomputed in both kernels: seven Lq x Lk x D products
// (eight with the lse sweep) where five would do.
// bf16: mma.sync m16n8k16 with fp32 accumulators, 4 warps x 16 rows,
// streamed tiles of 32 rows, D padded to DP in shared memory only, loads
// masked at L, kend and D as in the forward. p and ds are rounded to bf16
// as the A operands of their products, as the Pallas kernels cast them.
// fp32: CUDA cores, one lane per streamed row, as the fp32 forward.

constexpr int kBwdWarps = 4;
constexpr int kBwdRows = 16 * kBwdWarps;  // rows a block owns (64)
constexpr int kBwdInner = 32;             // rows of a streamed tile

// operands of the backward, and the rows of BwdParams::st
enum BwdOperand { bQ, bK, bV, bO, bDO, bDQ, bDK, bDV, bBias, bDBias,
                  kBwdOperands };

struct BwdParams {
  const void* in[5];      // q, k, v, o, do (by BwdOperand)
  void* grad[3];          // dq, dk, dv
  const void* bias;       // null: no bias
  void* dbias;            // (B, H, Lq, Lk) ds; null: not written
  float* lse;             // (B, H, Lq): read if lse_given, else written by dQ
  float* delta;           // (B, H, Lq) scratch: written by dQ, read by dK/dV
  long long st[kBwdOperands][3];  // element strides (batch, head, row)
  int B, H, lq, lk, D, kend;
  float scale;
  bool lse_given;
};

template <typename T>
__device__ __forceinline__ T* bwd_plane(const BwdParams& p, int op,
                                        const void* base, int b, int h) {
  return plane<T>(base, p.st[op][0], p.st[op][1], b, h);
}

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

// BiasT: the bias's type (NoBias: none). DsT: the type ds is written in
// as dbias (NoBias: not written).
template <int DP, typename BiasT, typename DsT>
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
  const int lq = p.lq, lk = p.lk, D = p.D, kend = p.kend;
  const bf16* qg = bwd_plane<const bf16>(p, bQ, p.in[bQ], b, h);
  const bf16* kg = bwd_plane<const bf16>(p, bK, p.in[bK], b, h);
  const bf16* vg = bwd_plane<const bf16>(p, bV, p.in[bV], b, h);
  const bf16* og = bwd_plane<const bf16>(p, bO, p.in[bO], b, h);
  const bf16* dog = bwd_plane<const bf16>(p, bDO, p.in[bDO], b, h);
  const long long k_rs = p.st[bK][2], v_rs = p.st[bV][2];
  const long long o_rs = p.st[bO][2], do_rs = p.st[bDO][2];

  load_tile<kBwdRows, DP>(qs, qg, p.st[bQ][2], q0, lq, D, vec);
  load_tile<kBwdRows, DP>(dos, dog, do_rs, q0, lq, D, vec);
  cp_async_commit();

  const int wr = warp * 16;
  const bool active = q0 + wr < lq;
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const long long stat0 = ((long long)b * p.H + h) * lq;

  // delta of the warp's 16 rows, from do and o in device memory
  float delta0 = 0.f, delta1 = 0.f;
  if (active) {
    for (int r = 0; r < 16; ++r) {
      const int row = q0 + wr + r;
      float acc = 0.f;
      if (row < lq)
        for (int d = lane; d < D; d += 32)
          acc += __bfloat162float(dog[row * do_rs + d]) *
                 __bfloat162float(og[row * o_rs + d]);
      acc = warp_sum(acc);
      if (r == g) delta0 = acc;
      if (r == g + 8) delta1 = acc;
      if (lane == 0 && row < lq) p.delta[stat0 + row] = acc;
    }
  }

  const BiasT* bias_bh = nullptr;
  long long bias_rs = 0;
  if constexpr (kHasBias<BiasT>) {
    bias_bh = bwd_plane<const BiasT>(p, bBias, p.bias, b, h);
    bias_rs = p.st[bBias][2];
  }
  DsT* dbias_bh = nullptr;
  long long dbias_rs = 0;
  if constexpr (kHasBias<DsT>) {
    dbias_bh = bwd_plane<DsT>(p, bDBias, p.dbias, b, h);
    dbias_rs = p.st[bDBias][2];
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
          if (key < kend && row < lq)
            x += to_float(bias_bh[(long long)row * bias_rs + key]);
        }
        s[n][i] = key < kend ? x : -INFINITY;
      }
    }
  };

  const int n_tiles = (kend + kBwdInner - 1) / kBwdInner;
  float lse0, lse1;
  if (p.lse_given) {
    lse0 = row0 < lq ? p.lse[stat0 + row0] : INFINITY;
    lse1 = row1 < lq ? p.lse[stat0 + row1] : INFINITY;
  } else {
    // sweep 1: the row max and sum, hence the lse
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    for (int it = 0; it < n_tiles; ++it) {
      const int k0 = it * kBwdInner;
      __syncthreads();                // the previous tile is consumed
      load_tile<kBwdInner, DP>(ks, kg, k_rs, k0, kend, D, vec);
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
    lse0 = row_lse(m0, l0);
    lse1 = row_lse(m1, l1);
    if (active && t == 0) {
      if (row0 < lq) p.lse[stat0 + row0] = lse0;
      if (row1 < lq) p.lse[stat0 + row1] = lse1;
    }
  }

  // sweep 2: p, dp = do . v^T, ds, dq += ds . k
  float dq[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBwdInner;
    __syncthreads();
    load_tile<kBwdInner, DP>(ks, kg, k_rs, k0, kend, D, vec);
    load_tile<kBwdInner, DP>(vs, vg, v_rs, k0, kend, D, vec);
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
        if constexpr (kHasBias<DsT>) {
          if (row < lq && key < lk)
            to_out(dbias_bh + (long long)row * dbias_rs + key, ds);
        }
        s[n][i] = ds;
      }
    }
    mma_cy<DP, kNT>(dq, s, ks, lane);
  }
  if (active)
    store_acc<DP>(bwd_plane<bf16>(p, bDQ, p.grad[0], b, h), p.st[bDQ][2],
                  dq, row0, lq, D, p.scale, t);
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
  const int lq = p.lq, lk = p.lk, D = p.D, kend = p.kend;
  const bf16* qg = bwd_plane<const bf16>(p, bQ, p.in[bQ], b, h);
  const bf16* dog = bwd_plane<const bf16>(p, bDO, p.in[bDO], b, h);
  const long long q_rs = p.st[bQ][2], do_rs = p.st[bDO][2];
  const long long stat0 = ((long long)b * p.H + h) * lq;

  load_tile<kBwdRows, DP>(ks, bwd_plane<const bf16>(p, bK, p.in[bK], b, h),
                          p.st[bK][2], k0, kend, D, vec);
  load_tile<kBwdRows, DP>(vs, bwd_plane<const bf16>(p, bV, p.in[bV], b, h),
                          p.st[bV][2], k0, kend, D, vec);
  cp_async_commit();

  const int wr = warp * 16;
  // keys in [kend, lk) get dk = dv = 0 (their p is 0), so they are stored
  const bool active = k0 + wr < lk;
  const int key0 = k0 + wr + g, key1 = key0 + 8;
  const BiasT* bias_bh = nullptr;
  long long bias_rs = 0;
  if constexpr (kHasBias<BiasT>) {
    bias_bh = bwd_plane<const BiasT>(p, bBias, p.bias, b, h);
    bias_rs = p.st[bBias][2];
  }

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  const int n_tiles = (lq + kBwdInner - 1) / kBwdInner;
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = it * kBwdInner;
    __syncthreads();
    load_tile<kBwdInner, DP>(qs, qg, q_rs, q0, lq, D, vec);
    load_tile<kBwdInner, DP>(dos, dog, do_rs, q0, lq, D, vec);
    cp_async_commit();
    for (int i = threadIdx.x; i < kBwdInner; i += blockDim.x) {
      const int q = q0 + i;
      lse_s[i] = q < lq ? p.lse[stat0 + q] : INFINITY;
      delta_s[i] = q < lq ? p.delta[stat0 + q] : 0.f;
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
        if (key < kend && q < lq) {
          float x = st[n][i] * p.scale;
          if constexpr (kHasBias<BiasT>)
            x += to_float(bias_bh[(long long)q * bias_rs + key]);
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
    store_acc<DP>(bwd_plane<bf16>(p, bDK, p.grad[1], b, h), p.st[bDK][2],
                  dk, key0, lk, D, p.scale, t);
    store_acc<DP>(bwd_plane<bf16>(p, bDV, p.grad[2], b, h), p.st[bDV][2],
                  dv, key0, lk, D, 1.f, t);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// dQ over the query tiles, then dK/dV over the key tiles, both of
// `threads` threads with `smem` bytes; returns the first error
template <typename DqKernel, typename DkvKernel, typename... Args>
cudaError_t launch_bwd_pair(const BwdParams& p, DqKernel dq_kern,
                            DkvKernel dkv_kern, int rows, int threads,
                            size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(dq_kern, smem);
  if (err == cudaSuccess) err = allow_smem(dkv_kern, smem);
  if (err != cudaSuccess) return err;
  dq_kern<<<dim3((p.lq + rows - 1) / rows, p.H, p.B), threads, smem,
            stream>>>(p, args...);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kern<<<dim3((p.lk + rows - 1) / rows, p.H, p.B), threads, smem,
             stream>>>(p, args...);
  return cudaGetLastError();
}

template <int DP, typename BiasT, typename DsT>
cudaError_t launch_bwd_mma(const BwdParams& p, cudaStream_t stream) {
  // 16-byte copies need D, every stride of the tiled operands and their
  // bases to be multiples of 8 elements (16 bytes)
  bool vec = p.D % 8 == 0;
  for (int o : {bQ, bK, bV, bDO}) {
    vec = vec && reinterpret_cast<uintptr_t>(p.in[o]) % 16 == 0;
    for (int j = 0; j < 3; ++j) vec = vec && p.st[o][j] % 8 == 0;
  }
  return launch_bwd_pair(p, attention_bwd_dq_mma_kernel<DP, BiasT, DsT>,
                         attention_bwd_dkv_mma_kernel<DP, BiasT>, kBwdRows,
                         kBwdWarps * 32, BwdSmem<DP>::kBytes, stream, vec);
}

template <typename BiasT, typename DsT>
cudaError_t dispatch_bwd_mma(const BwdParams& p, cudaStream_t s) {
  switch ((p.D + 15) / 16) {
#define VAST_BWD_CASE(N) \
  case N:                \
    return launch_bwd_mma<16 * N, BiasT, DsT>(p, s);
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

template <typename BiasT, typename DsT>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dq_fp32_kernel(const BwdParams p) {
  const int D = p.D, lq = p.lq, lk = p.lk, kend = p.kend;
  extern __shared__ float smem[];
  float* qs = smem;                          // [64][D]
  float* dos = qs + kF32BwdRows * D;         // [64][D]
  float* ks = dos + kF32BwdRows * D;         // [32][D + 1]
  float* vs = ks + kBlockK * (D + 1);        // [32][D + 1]

  const int q0 = blockIdx.x * kF32BwdRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* qg = bwd_plane<const float>(p, bQ, p.in[bQ], b, h);
  const float* kg = bwd_plane<const float>(p, bK, p.in[bK], b, h);
  const float* vg = bwd_plane<const float>(p, bV, p.in[bV], b, h);
  const float* og = bwd_plane<const float>(p, bO, p.in[bO], b, h);
  const float* dog = bwd_plane<const float>(p, bDO, p.in[bDO], b, h);
  const long long q_rs = p.st[bQ][2], k_rs = p.st[bK][2], v_rs = p.st[bV][2];
  const long long o_rs = p.st[bO][2], do_rs = p.st[bDO][2];
  const long long stat0 = ((long long)b * p.H + h) * lq;

  for (int i = tid; i < kF32BwdRows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D, q = q0 + r;
    qs[i] = q < lq ? qg[q * q_rs + d] : 0.f;
    dos[i] = q < lq ? dog[q * do_rs + d] : 0.f;
  }
  __syncthreads();
  const int wr = warp * kRowsPerWarp;
  const float* qw = qs + wr * D;
  const float* dow = dos + wr * D;
  float delta[kRowsPerWarp], lse[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int q = q0 + wr + r;
    float acc = 0.f;
    if (q < lq)
      for (int d = lane; d < D; d += 32) acc += dow[r * D + d] * og[q * o_rs + d];
    delta[r] = warp_sum(acc);
    if (lane == 0 && q < lq) p.delta[stat0 + q] = delta[r];
  }
  const BiasT* bias_bh = nullptr;
  long long bias_rs = 0;
  if constexpr (kHasBias<BiasT>) {
    bias_bh = bwd_plane<const BiasT>(p, bBias, p.bias, b, h);
    bias_rs = p.st[bBias][2];
  }
  DsT* dbias_bh = nullptr;
  long long dbias_rs = 0;
  if constexpr (kHasBias<DsT>) {
    dbias_bh = bwd_plane<DsT>(p, bDBias, p.dbias, b, h);
    dbias_rs = p.st[bDBias][2];
  }
  auto score = [&](const float* kr, int r, int key) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(qw[r * D + d], kr[d], s);
    float x = s * p.scale;
    const int q = q0 + wr + r;
    if constexpr (kHasBias<BiasT>) {
      if (key < kend && q < lq) x += to_float(bias_bh[(long long)q * bias_rs + key]);
    }
    return key < kend ? x : -INFINITY;
  };

  if (p.lse_given) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int q = q0 + wr + r;
      lse[r] = q < lq ? p.lse[stat0 + q] : INFINITY;
    }
  } else {
    // sweep 1: row max and sum
    float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
    }
    for (int k0 = 0; k0 < kend; k0 += kBlockK) {
      __syncthreads();
      for (int i = tid; i < kBlockK * D; i += blockDim.x) {
        const int j = i / D, d = i - j * D, key = k0 + j;
        ks[j * (D + 1) + d] = key < kend ? kg[key * k_rs + d] : 0.f;
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
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      lse[r] = row_lse(m[r], l[r]);
      const int q = q0 + wr + r;
      if (lane == 0 && q < lq) p.lse[stat0 + q] = lse[r];
    }
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
      ks[j * (D + 1) + d] = valid ? kg[key * k_rs + d] : 0.f;
      vs[j * (D + 1) + d] = valid ? vg[key * v_rs + d] : 0.f;
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
      if constexpr (kHasBias<DsT>) {
        if (q < lq && key < lk)
          to_out(dbias_bh + (long long)q * dbias_rs + key, ds[r]);
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
  float* dqg = bwd_plane<float>(p, bDQ, p.grad[0], b, h);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int q = q0 + wr + r;
    if (q >= lq) continue;
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dqg[q * p.st[bDQ][2] + d] = dq[r][c] * p.scale;
    }
  }
}

template <typename BiasT>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dkv_fp32_kernel(const BwdParams p) {
  const int D = p.D, lq = p.lq, lk = p.lk, kend = p.kend;
  extern __shared__ float smem[];
  float* ks = smem;                          // [64][D]
  float* vs = ks + kF32BwdRows * D;          // [64][D]
  float* qs = vs + kF32BwdRows * D;          // [32][D + 1]
  float* dos = qs + kBlockK * (D + 1);       // [32][D + 1]
  float* lse_s = dos + kBlockK * (D + 1);    // [32]
  float* delta_s = lse_s + kBlockK;          // [32]

  const int k0 = blockIdx.x * kF32BwdRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* qg = bwd_plane<const float>(p, bQ, p.in[bQ], b, h);
  const float* kg = bwd_plane<const float>(p, bK, p.in[bK], b, h);
  const float* vg = bwd_plane<const float>(p, bV, p.in[bV], b, h);
  const float* dog = bwd_plane<const float>(p, bDO, p.in[bDO], b, h);
  const long long q_rs = p.st[bQ][2], k_rs = p.st[bK][2], v_rs = p.st[bV][2];
  const long long do_rs = p.st[bDO][2];
  const long long stat0 = ((long long)b * p.H + h) * lq;
  for (int i = tid; i < kF32BwdRows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D, key = k0 + r;
    const bool valid = key < kend;
    ks[i] = valid ? kg[key * k_rs + d] : 0.f;
    vs[i] = valid ? vg[key * v_rs + d] : 0.f;
  }
  const int wr = warp * kRowsPerWarp;
  const BiasT* bias_bh = nullptr;
  long long bias_rs = 0;
  if constexpr (kHasBias<BiasT>) {
    bias_bh = bwd_plane<const BiasT>(p, bBias, p.bias, b, h);
    bias_rs = p.st[bBias][2];
  }

  float dk[kRowsPerWarp][kDimsPerLane], dv[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) dk[r][c] = dv[r][c] = 0.f;
  for (int q0 = 0; q0 < lq; q0 += kBlockK) {
    __syncthreads();
    for (int i = tid; i < kBlockK * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D, q = q0 + j;
      const bool valid = q < lq;
      qs[j * (D + 1) + d] = valid ? qg[q * q_rs + d] : 0.f;
      dos[j * (D + 1) + d] = valid ? dog[q * do_rs + d] : 0.f;
    }
    for (int i = tid; i < kBlockK; i += blockDim.x) {
      const int q = q0 + i;
      lse_s[i] = q < lq ? p.lse[stat0 + q] : INFINITY;
      delta_s[i] = q < lq ? p.delta[stat0 + q] : 0.f;
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
      if (key < kend && q < lq) {
        x = s * p.scale;
        if constexpr (kHasBias<BiasT>)
          x += to_float(bias_bh[(long long)q * bias_rs + key]);
        x = expf(x - lse_s[lane]);
      }
      pr[r] = x;
      ds[r] = x * (dpv - delta_s[lane]);
    }
    const int in = min(kBlockK, lq - q0);
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
  float* dkg = bwd_plane<float>(p, bDK, p.grad[1], b, h);
  float* dvg = bwd_plane<float>(p, bDV, p.grad[2], b, h);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int key = k0 + wr + r;
    if (key >= lk) continue;
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dkg[key * p.st[bDK][2] + d] = dk[r][c] * p.scale;
        dvg[key * p.st[bDV][2] + d] = dv[r][c];
      }
    }
  }
}

template <typename BiasT, typename DsT>
cudaError_t launch_bwd_fp32(const BwdParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)kF32BwdRows * p.D +
                                       2 * (size_t)kBlockK * (p.D + 1) +
                                       2 * (size_t)kBlockK);
  return launch_bwd_pair(p, attention_bwd_dq_fp32_kernel<BiasT, DsT>,
                         attention_bwd_dkv_fp32_kernel<BiasT>, kF32BwdRows,
                         kWarps * 32, smem, stream);
}

#if VAST_PART_ON(0)
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
#endif

// The backward's (bias type, ds type) pairs: none; a bias in the input
// type with ds in it (the token-major entry); an fp32 bias with or without
// ds (the head-major entry)
#if VAST_PART_ON(3)
cudaError_t run_bwd(const BwdParams& p, int dtype, int bias_dtype,
                    cudaStream_t s) {
  if (p.D < 1 || p.D > kMaxD || p.lq < 1 || p.lk < 1 || p.kend < 1 ||
      p.kend > p.lk || p.B < 1 || p.H < 1 || p.B > 65535 || p.H > 65535 ||
      (p.dbias && !p.bias))
    return cudaErrorInvalidValue;
  const bool ds = p.dbias != nullptr;
  if (dtype == kF32) {
    if (!p.bias) return launch_bwd_fp32<NoBias, NoBias>(p, s);
    if (bias_dtype == kF32)
      return ds ? launch_bwd_fp32<float, float>(p, s)
                : launch_bwd_fp32<float, NoBias>(p, s);
  } else if (dtype == kBf16) {
    using bf16 = __nv_bfloat16;
    if (!p.bias) return dispatch_bwd_mma<NoBias, NoBias>(p, s);
    if (bias_dtype == kBf16 && ds) return dispatch_bwd_mma<bf16, bf16>(p, s);
    if (bias_dtype == kF32)
      return ds ? dispatch_bwd_mma<float, float>(p, s)
                : dispatch_bwd_mma<float, NoBias>(p, s);
  }
  return cudaErrorInvalidValue;
}
#endif

// The Params of a token-major qkv (B, L, 3*H*D) whose head h has q, k and
// v at elements h * head + j * part (j = 0, 1, 2) of each row, and of the
// output (B, L, H*D). Fused per-head [q|k|v]: head 3D, part D; the
// section-major [Q_all|K_all|V_all]: head D, part H*D.
Params tmajor_params(const void* qkv, void* out, int dtype, int L, int H,
                     int D, int kend, float scale, long long head,
                     long long part) {
  const long long es = dtype == kF32 ? 4 : 2, row = 3LL * H * D;
  Params p = {};
  for (int o = kQ; o <= kV; ++o) {
    p.in[o] = static_cast<const char*>(qkv) + o * part * es;
    p.st[o][0] = L * row;
    p.st[o][1] = head;
    p.st[o][2] = row;
  }
  p.st[kO][0] = (long long)L * H * D;
  p.st[kO][1] = D;
  p.st[kO][2] = (long long)H * D;
  p.out = out;
  p.lq = L;
  p.kend = kend;
  p.d = D;
  p.heads = H;
  p.scale = scale;
  return p;
}

// The Params of the token-major forward entries (their arguments,
// described at vast_tmajor_attention_fwd): the fused per-head layout, the
// bias (B or 1, H, L, L) with batch stride bias_batch_stride
Params tmajor_fwd_params(const void* qkv, const void* bias, void* out,
                         float* lse, int dtype, int L, int H, int D, int kend,
                         long long bias_batch_stride, float scale) {
  Params p = tmajor_params(qkv, out, dtype, L, H, D, kend, scale, 3LL * D, D);
  p.st[kBias][0] = bias_batch_stride;
  p.st[kBias][1] = (long long)L * L;
  p.st[kBias][2] = L;
  p.bias = bias;
  p.lse = lse;
  return p;
}

// ---------------------------------------------------------------------
// The copy engine (TMA): attention_dma's counterpart
// ---------------------------------------------------------------------
//
// Replaces scripts/bench_tmajor_variants.py attention_dma (:78, inline
// body :87, pallas_call :102). There each (group of 4 batch rows, head)
// grid step leaves qkv in HBM and copies one head's misaligned [q|k|v]
// strip (Lp x 3*88) into VMEM with make_async_copy and a DMA semaphore
// (:90-94), then computes softmax(q . k^T masked to lk_true) . v, unscaled
// (_softmax_av :62). The TPU's DMA engine refused those lane offsets and
// the kernel ran only in interpret mode; Hopper's copy engine takes any
// 16-byte-aligned strip: head h's q, k and v start at 2 * (3h + j) * 88
// bytes of a 8448-byte row (bf16), each 176 bytes long.
//
// Here the fused qkv is a 4-D tensor for the copy engine, (d, section
// 3h + j, row, batch) innermost first, and one box is one section of
// kTmaRows rows, kLd wide: the columns past D read as zeros, so a box lands
// as the padded tile the mma body reads, and rows past L read as zeros
// too. One thread issues the boxes of a tile; they complete on an mbarrier
// that was told the tile's bytes (expect_tx), the counterpart of the DMA
// semaphore. No thread loads q, k or v itself. The block is the cp.async
// forward's (a query tile of 128 rows of one (batch row, head), keys in
// tiles of 64 through two buffers with an online softmax, so any L fits);
// while tile i is computed, tile i + 1 is in flight. Bound: bytes, as the
// forward (qkv read once, the output written once).
// fp32 (off the probe's path): the CUDA-core body, each k/v tile through
// one barrier and waited for at once; its k rows lie D apart (the box),
// not D + 1, so the lanes' reads of 32 keys share banks.

constexpr int kTmaRows = kMmaBlockK;   // rows of one bf16 box (<= 256)
static_assert(kMmaBlockQ % kTmaRows == 0, "q tile of whole boxes");
static_assert(kBlockQ % kBlockK == 0, "fp32 q tile of whole boxes");

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// the copy engine writes shared memory at 128-byte aligned addresses
__device__ __forceinline__ unsigned char* align_128(unsigned char* ptr) {
  return ptr + ((128u - (smem_u32(ptr) & 127u)) & 127u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// two barriers of one arrival each, ready for the copy engine
__device__ __forceinline__ void mbar_init_pair(uint64_t* bar) {
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// arrive, and expect `bytes` from the copy engine in the current phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred ready;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 ready, [%1], %2;\n"
        "selp.u32 %0, 1, 0, ready;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// the box of `map` at coordinates (c0, c1, c2, c3), innermost first, into
// shared memory at dst; its bytes complete on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The bf16 loader of the copy engine (the interface of CpAsyncTiles): the
// first tile and q land on bar[0], then tile `it` on bar[it & 1], the
// phase of parity (it >> 1) & 1. Buffer `stage` is refilled only after the
// __syncthreads that ends its previous tile's computation.
template <int DP>
struct TmaTiles {
  static constexpr int kLd = MmaSmem<DP>::kLd;
  static constexpr unsigned kBoxBytes =
      kTmaRows * kLd * sizeof(__nv_bfloat16);
  const CUtensorMap* map;
  uint64_t* bar;
  int h, b;

  __device__ __forceinline__ void kv(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                     int k0, uint64_t* at) const {
    tma_load_4d(ks, map, at, 0, 3 * h + 1, k0, b);
    tma_load_4d(vs, map, at, 0, 3 * h + 2, k0, b);
  }
  __device__ __forceinline__ void first(__nv_bfloat16* qs, __nv_bfloat16* ks,
                                        __nv_bfloat16* vs, int q0) const {
    if (threadIdx.x != 0) return;
    mbar_arrive_expect_tx(bar, (kMmaBlockQ / kTmaRows + 2) * kBoxBytes);
    for (int r = 0; r < kMmaBlockQ; r += kTmaRows)
      tma_load_4d(qs + r * kLd, map, bar, 0, 3 * h, q0 + r, b);
    kv(ks, vs, 0, bar);
  }
  __device__ __forceinline__ void next(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                       int k0, int stage) const {
    if (threadIdx.x != 0) return;
    mbar_arrive_expect_tx(bar + stage, 2 * kBoxBytes);
    kv(ks, vs, k0, bar + stage);
  }
  __device__ __forceinline__ void wait(int it, bool /*more*/) const {
    mbar_wait(bar + (it & 1), (it >> 1) & 1);
  }
};

// The fp32 loader of the copy engine (the interface of PlainF32Tiles): q
// on bar[0], each k/v tile on bar[1], both waited for at once.
struct TmaF32Tiles {
  const CUtensorMap* map;
  uint64_t* bar;
  int h, b, d;

  __device__ __forceinline__ int k_ld() const { return d; }
  __device__ __forceinline__ void q(float* qs, int q0) const {
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar, kBlockQ * d * sizeof(float));
      for (int r = 0; r < kBlockQ; r += kBlockK)
        tma_load_4d(qs + r * d, map, bar, 0, 3 * h, q0 + r, b);
    }
    mbar_wait(bar, 0);
  }
  __device__ __forceinline__ void kv(float* ks, float* vs, int k0,
                                     int it) const {
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar + 1, 2 * kBlockK * d * sizeof(float));
      tma_load_4d(ks, map, bar + 1, 0, 3 * h + 1, k0, b);
      tma_load_4d(vs, map, bar + 1, 0, 3 * h + 2, k0, b);
    }
    mbar_wait(bar + 1, it & 1);
  }
};

template <int DP>
__global__ void __launch_bounds__(kMmaWarps * 32, kMmaBlocksPerSm)
attention_fwd_tma_kernel(const Params p,
                         const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(128) unsigned char tma_smem[];
  unsigned char* smem = align_128(tma_smem);
  auto* bar = reinterpret_cast<uint64_t*>(smem + MmaSmem<DP>::kBytes);
  mbar_init_pair(bar);
  const TmaTiles<DP> tiles{&map, bar, (int)blockIdx.y, (int)blockIdx.z};
  attention_fwd_mma<DP, NoBias>(p, tiles, smem);
}

#if VAST_PART_ON(2)
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_tma_fp32_kernel(const Params p,
                              const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(128) unsigned char tma_smem[];
  unsigned char* smem = align_128(tma_smem);
  auto* bar = reinterpret_cast<uint64_t*>(
      smem + sizeof(float) * (kBlockQ + 2 * kBlockK) * p.d);
  mbar_init_pair(bar);
  const TmaF32Tiles tiles{&map, bar, (int)blockIdx.y, (int)blockIdx.z, p.d};
  attention_fwd_fp32<NoBias>(p, tiles, reinterpret_cast<float*>(smem));
}
#endif

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, asked of the driver through the runtime, so that
// the library links the CUDA runtime alone; null if the driver has none
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(f)
               : nullptr;
  }();
  return fn;
}

// The copy engine's map of a fused qkv (B, L, 3*H*D): (d, section, row,
// batch), boxes of box_d x 1 x box_rows x 1 (box_d > D reads zeros)
cudaError_t encode_qkv_map(CUtensorMap* map, const void* qkv, int dtype,
                           int B, int L, int H, int D, int box_d,
                           int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t es = dtype == kF32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, 3ull * H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {D * es, 3ull * H * D * es,
                                 3ull * H * D * es * L};
  const cuuint32_t box[4] = {(cuuint32_t)box_d, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, dtype == kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(qkv), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DP>
cudaError_t launch_tma(const Params& p, const void* qkv, int B, int H,
                       cudaStream_t stream) {
  CUtensorMap map;
  cudaError_t err = encode_qkv_map(&map, qkv, kBf16, B, p.lq, H, p.d,
                                   MmaSmem<DP>::kLd, kTmaRows);
  auto kern = attention_fwd_tma_kernel<DP>;
  const size_t smem = MmaSmem<DP>::kBytes + 2 * sizeof(uint64_t) + 128;
  if (err == cudaSuccess) err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.lq + kMmaBlockQ - 1) / kMmaBlockQ, H, B);
  kern<<<grid, kMmaWarps * 32, smem, stream>>>(p, map);
  return cudaGetLastError();
}

#if VAST_PART_ON(2)
cudaError_t launch_tma_fp32(const Params& p, const void* qkv, int B, int H,
                            cudaStream_t stream) {
  CUtensorMap map;
  cudaError_t err = encode_qkv_map(&map, qkv, kF32, B, p.lq, H, p.d, p.d,
                                   kBlockK);
  const size_t smem =
      sizeof(float) * (kBlockQ + 2 * kBlockK) * p.d + 2 * sizeof(uint64_t) +
      128;
  if (err == cudaSuccess) err = allow_smem(attention_fwd_tma_fp32_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.lq + kBlockQ - 1) / kBlockQ, H, B);
  attention_fwd_tma_fp32_kernel<<<grid, kWarps * 32, smem, stream>>>(p, map);
  return cudaGetLastError();
}
#endif

#if VAST_PART_ON(2)
cudaError_t dispatch_tma(const Params& p, const void* qkv, int B, int H,
                         cudaStream_t s) {
  switch ((p.d + 15) / 16) {
#define VAST_TMA_CASE(N) \
  case N:                \
    return launch_tma<16 * N>(p, qkv, B, H, s);
    VAST_TMA_CASE(1) VAST_TMA_CASE(2) VAST_TMA_CASE(3)
    VAST_TMA_CASE(4) VAST_TMA_CASE(5) VAST_TMA_CASE(6)
    VAST_TMA_CASE(7) VAST_TMA_CASE(8)
#undef VAST_TMA_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
#endif

// ---------------------------------------------------------------------
// The forward for Hopper: wgmma and the copy engine
// ---------------------------------------------------------------------
//
// Replaces, for bf16 operands the copy engine can read, the forward kernels
// of vast_tpu/ops/flash_attention.py: the head-major _single_kernel (:52)
// and _single_kernel_nolse (:87) at Lk <= 4096, _looped_kernel (:94) and
// _looped_kernel_nolse (:137) above (through vast_flash_attention_fwd_sm90),
// and the token-major _tmajor_fwd_kernel (:762) and _tmajor_fwd_kernel_bias
// (:789) (through vast_tmajor_attention_fwd_sm90, the fused qkv read as
// three strided views): one body for all six (the lse is one more store).
// Each entry's rule is at the entry below. The operands it refuses, and
// fp32, take attention_fwd_mma / attention_fwd_fp32 through
// vast_flash_attention_fwd and vast_tmajor_attention_fwd. The contract is
// theirs (top of file).
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): CLIP-L/14-336's
// attention (64 x 16 heads x 577^2 x 64) lies at the ridge, 0.0903 ms by
// bytes (q, k, v read once, o written once) against 0.088 ms by
// operations; AST's (8 x 12 x 257^2), EVA01-g's (64 x 16 x 257^2 x 88) and
// BEATs' (8 x 12 x 256^2 x 64, whose bf16 bias is half of the bytes) are
// bound by bytes; the reranks (4 x 12 heads, 320 x 2312 and 640 x 4873) by
// operations. At D 64 a score's exp2 on the special-function units (16 a
// clock an SM) takes as long as its 256 tensor-core operations, so the
// softmax is as long as the two products, and whatever else a thread
// issues per score adds to it.
// What the design does about it: both products run on wgmma, q, k and v
// read by the tensor cores straight from shared memory and p from
// registers, so no thread loads an operand fragment; every tile comes
// through the copy engine, issued by one producer thread, so the consumers
// spend no instruction on addresses; the scale folded into the exp2's
// fma, so a score costs one fma, one max and one exp2 besides the sum and
// the bf16 pack; one block an SM, two consumer warpgroups of 64 query rows
// whose products and softmaxes interleave on the SM (they share nothing
// but the tiles), setmaxnreg moving the producer's registers to them (24
// and 240 a thread; ptxas fits their code in the 168 of the launch with
// no spill), so that the 64 x 128 scores, p and the output stay in
// registers; persistent blocks, so that a block's next work tile is
// loaded while it finishes this one: CLIP's work tiles have only 5 key
// tiles each, and a block that started cold paid the first loads' latency
// on each of them.
//
// Layout. Each of q, k, v is a 4-D tensor for the copy engine: d, then
// batch, head and row ordered by their strides, so CLIP's packed views,
// the token-major views (head stride 3D, row stride 3HD: EVA's 264 and
// 4224 elements, k and v 176 and 352 bytes on) and contiguous tensors are
// read as they lie. A box is 64 columns (128 bytes) by a tile's rows in
// 128-byte swizzle, the layout wgmma reads: columns past D read as zeros,
// and so do rows past Lq (q) or past kend (k, v); D > 64 is two boxes,
// each a [rows][64] tile of its own. Key tiles of kSm90BlockK go through a
// ring of stages, each with a full barrier (the copy engine's bytes) and
// an empty one (every consumer thread). The last tile's keys at and past
// kend are masked to -inf in registers; rows past Lq are not stored.
//
// Three properties of the token-major shapes, each a lever measured on
// the H100 in turns against a build without it (PERF.md, its findings);
// all four kept:
// * L 257 (EVA01-g's 256 patches and the class token) against 128-row
//   work tiles and 128-key tiles: 384 x 384 for 257 x 257, 2.2x the useful
//   work. A last key tile of <= 16 keys (the 257th) runs as wgmma N 16 and
//   one 16-key step of p . v, its softmax over 8 scores a thread, not 64
//   (9% less device time at EVA, 17-21% at AST's 257), and runs first
//   (7.5% at EVA), so that the last tile of a work tile is a wide one,
//   whose softmax and p . v run while the copy engine brings the next work
//   tile's q (released after the last q . k^T); run last, the N-16 tile
//   left that load bare and gained 1% at EVA. Work tiles of 64 rows a warpgroup, with a ring each, would not
//   fit: the two rings of k and v at D 128 need 384 KB. Tried and kept
//   out: the third work tile's second warpgroup, which owns no row,
//   issuing no product and only keeping the barriers' counts ran 4-10%
//   slower at EVA (it waits on the next q's barrier beside the busy one).
// * D 88 run as 128: q . k^T stops at 96 deep (6 k-steps, not 8) where D
//   allows and there is no bias (2-4% at EVA), as the backward's does;
//   the columns past D are zeros, so the output is the same bit for bit. p . v keeps whole 64-column boxes of v (N 128 at D
//   88): the swizzle atom of an MN-major operand is 64 columns wide.
// * BEATs' bf16 bias (12.6 MB of the 25 MB the kernel must move) is read
//   by the copy engine (1.6x less device time than scalar loads): each
//   key tile's 128 rows x 128 keys, two boxes of 64 keys in 128-byte
//   swizzle, land in the stage with k and v on the same full barrier (208
//   KB of shared memory at DP 64), and the consumers read
//   bf16 pairs from them without bank conflicts (the pair of row r, keys
//   8j + 2t, lies in 16-byte chunk j ^ (r % 8)). Rows and keys past L read
//   as zeros and are masked as the scores are. The head-major entry's bias
//   (fp32 or broadcast) and a bias at D > 64 are read by scalar loads
//   through their strides.
// Tried and slower on the H100: ping-pong between the consumer
// warpgroups, and this tile's softmax under the last tile's p . v (with
// the first and last tiles peeled, so that ptxas serializes no wgmma).
// Later levers, not here: a split over keys for the reranks' few blocks,
// cluster multicast of k/v.

constexpr int kSm90Consumers = 2;                 // warpgroups of 64 rows
constexpr int kSm90BlockQ = 64 * kSm90Consumers;  // query rows of a block
constexpr int kSm90BlockK = 128;                  // keys of a tile
constexpr int kSm90Threads = 128 * (kSm90Consumers + 1);   // + producer
constexpr int kSm90Box = 64;                      // columns of a box
constexpr int kSm90RowBytes = kSm90Box * 2;       // one swizzled row
constexpr int kSm90ProducerRegs = 24, kSm90ConsumerRegs = 240;
static_assert(kSm90ProducerRegs + kSm90Consumers * kSm90ConsumerRegs ==
                  (kSm90Consumers + 1) * 168,
              "the 64K registers of an SM, 168 a thread at launch");
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.69314718055994531f;

// The bias type of the token-major bf16 bias that the copy engine brings
// into each stage (BiasT's other values: NoBias, or a type read through the
// operand's strides)
struct BoxBias {};

template <typename BiasT>
constexpr bool kBoxBias = std::is_same<BiasT, BoxBias>::value;

// A block's shared memory, each tile 1024-byte aligned (whole swizzle
// atoms of 8 rows x 128 bytes): q, then each stage's k, v and (BoxBias)
// bias, then the barriers (full and empty per stage, then q's full and
// empty). A tile of R rows is DP / 64 column blocks of R x 128 bytes; a
// stage's bias is kSm90BlockK / 64 boxes of kSm90BlockQ rows x 64 keys.
template <int DP, typename BiasT>
struct Sm90Smem {
  static constexpr int kBlocks = DP / kSm90Box;
  static constexpr int kStages = 3;   // the copy engine up to 2 tiles ahead
  static constexpr unsigned kQBytes = kSm90BlockQ * DP * 2;
  static constexpr unsigned kKvBytes = kSm90BlockK * DP * 2;   // k or v
  static constexpr unsigned kBiasBytes =
      kBoxBias<BiasT> ? kSm90BlockQ * kSm90BlockK * 2 : 0;
  static constexpr unsigned kStageBytes = 2 * kKvBytes + kBiasBytes;
  static constexpr unsigned kBarOffset = kQBytes + kStages * kStageBytes;
  static constexpr size_t kBytes = kBarOffset + (2 * kStages + 2) * 8 + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory on sm_90");
};

// where the batch, head and row axes of an operand lie among its map's
// dimensions 1-3
struct Sm90Slot {
  int b, h, r;
};

__device__ __forceinline__ unsigned char* align_1024(unsigned char* ptr) {
  return ptr + ((1024u - (smem_u32(ptr) & 1023u)) & 1023u);
}

// mbar_wait, but a wait still unmet after about 10 s of the SM's clock
// (a lost arrival: a fault of this file) traps, so that the launch fails
// instead of holding the card
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar,
                                                  unsigned parity) {
  const long long t0 = clock64();
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred ready;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 ready, [%1], %2;\n"
        "selp.u32 %0, 1, 0, ready;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// the box of `map` at column d0 and (batch b, head h, row r), each at its
// slot; its bytes complete on `bar`
__device__ __forceinline__ void tma_load_at(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, Sm90Slot s, int d0,
                                            int b, int h, int r) {
  tma_load_4d(dst, map, bar, d0, s.b == 1 ? b : s.h == 1 ? h : r,
              s.b == 2 ? b : s.h == 2 ? h : r,
              s.b == 3 ? b : s.h == 3 ? h : r);
}

// A wgmma operand in shared memory in 128-byte swizzle (the copy engine's,
// from a 1024-byte aligned tile): sbo, the bytes between groups of 8 rows
// of 128 bytes; lbo, between 64-column blocks along M or N of an MN-major
// operand (a K-major one ignores it).
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile, unsigned lbo,
                                               unsigned sbo) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFFu) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFFu) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFFu) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N of the warpgroup's committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// the compiler moves no read or write of d across this point (an
// accumulator is written by a wgmma until its wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d[0..63] (+)= a . b over 16 of the reduction: a 64 x 16 tile and b a
// 16 x 128 tile, both in shared memory and K-major (descriptors a and
// b); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a,
                                                    uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[0..31] (+)= a . b over 16 keys: a 64 x 16 from registers (the layout
// of an m64nNk16 accumulator's 16 columns), b a 16 x 64 tile in shared
// memory, MN-major (its 64 columns contiguous: the transpose bit);
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d[0..7] (+)= a . b over 16 of the reduction: a 64 x 16 tile and b a
// 16 x 16 tile (16 keys), both in shared memory and K-major; scale_d 0
// overwrites d
__device__ __forceinline__ void wgmma_m64n16k16_ss(float (&d)[8], uint64_t a,
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The online softmax of one key tile's scores s (a wgmma accumulator of N
// = 8 NJ keys: see sm90_consumer) for the thread's rows, times f in log2
// units (f > 0: the scale folded into the exponent, max and mask commuting
// with it; else 1, the scale and bias already applied): keys >= kend
// masked (the last tile's: they read as zeros, or are keys past lk_true),
// the running max m and this lane's part of the sum l updated, the
// output's rescale factors returned in alpha, and p left in s in fp32. One
// fma and one exp2 a score.
template <int NJ>
__device__ __forceinline__ void sm90_softmax(float (&s)[4 * NJ],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int kend,
                                             int k0, int t, float f) {
  if (k0 + 8 * NJ > kend) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (k0 + 8 * j + 2 * t + (i & 1) >= kend) s[4 * j + i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};     // over the quad sharing a row
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float ne[2], sum[2] = {0.f, 0.f};         // ne: minus the reference
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r] * f);
    ne[r] = -exp_ref(mn);
    alpha[r] = ex2(m[r] + ne[r]);
    m[r] = mn;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[4 * j + i] = ex2(fmaf(s[4 * j + i], f, ne[i >> 1]));
      sum[i >> 1] += s[4 * j + i];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// p (fp32, in s) in bf16 pairs as the A fragments of p . v: two 8-key
// column groups of the accumulator make one 16-key step
template <int NJ>
__device__ __forceinline__ void pack_p(const float (&s)[4 * NJ],
                                       uint32_t (&pa)[NJ / 2][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    pa[j / 2][(j & 1) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
    pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

// Whether the last key tile, of <= 16 keys, runs as wgmma N 16, and so
// first: producer and consumers take the key tiles in the same order
__device__ __forceinline__ bool sm90_tail16(int kend, int n_tiles) {
  return kend - (n_tiles - 1) * kSm90BlockK <= 16;
}

// the key tile taken i-th of n_tiles: the N-16 tail first, then the
// others in order
__device__ __forceinline__ int sm90_key_tile(int i, int n_tiles,
                                             bool tail16) {
  return !tail16 ? i : i == 0 ? n_tiles - 1 : i - 1;
}

// One consumer warpgroup `wg`: its 64 query rows of one work tile (query
// rows q0.., head h, batch row b) over every key tile. Accumulator layout
// of an m64nNk16 wgmma (PTX ISA), for the thread of warp w, lane l (g = l
// / 4, t = l % 4) of the warpgroup: d[4j + i] holds row 16w + g (+8 for i
// >= 2), column 8j + 2t (+1 for odd i); so the scores of keys
// 16kk..16kk+15, packed to bf16 pairs, are the A fragment of p . v's
// 16-key step kk as they lie. Per key tile: s = q . k^T over KD 16-column
// steps, its softmax, o += p . v, then the stage is released; q is
// released after the last q . k^T. A last tile of <= 16 keys runs N 16,
// before the others (the online softmax takes the tiles in any order).
// The ring's stages go on from tile
// `ring` (the key tiles of the block's earlier work tiles); q's barrier is
// in phase `qphase`.
template <int DP, int KD, typename BiasT>
__device__ __forceinline__ void sm90_consumer(
    const Params& p, const unsigned char* qs, const unsigned char* kv,
    uint64_t* full, uint64_t* empty, uint64_t* qfull, uint64_t* qempty,
    int wg, int q0, int h, int b, int n_tiles, int ring, unsigned qphase) {
  using S = Sm90Smem<DP, BiasT>;
  constexpr int kBlocks = S::kBlocks;
  constexpr int kSteps = kSm90BlockK / 16;      // 16-key steps of p . v
  static_assert(KD * 16 <= DP, "q . k^T over at most DP columns");
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl = 64 * wg + 16 * warp + g;       // the row in the work tile
  const int row0 = q0 + rl, row1 = row0 + 8;
  const int lq = p.lq, D = p.d, kend = p.kend;
  const float scale2 = p.scale * kLog2e;        // scores in log2 units
  // the scale folds into the exponent without a bias, at a positive scale
  const bool fold = !kHasBias<BiasT> && scale2 > 0.f;
  const BiasT* bias_bh = nullptr;
  long long bias_rs = 0;
  if constexpr (kHasBias<BiasT> && !kBoxBias<BiasT>) {
    bias_bh = plane<const BiasT>(p.bias, p.st[kBias][0], p.st[kBias][1], b, h);
    bias_rs = p.st[kBias][2];
  }
  mbar_wait_or_trap(qfull, qphase);

  float o[kBlocks][32], s[64];
#pragma unroll
  for (int c = 0; c < kBlocks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  uint32_t pa[kSteps][4];                  // p in bf16, A of p . v
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  const unsigned char* qw = qs + 64 * wg * kSm90RowBytes;   // the 64 rows

  // sc = q . k^T of stage st over its first N keys (sc: 4 N / 8 values) in
  // KD steps; within a 128-byte row a step moves the descriptors 32 bytes
  // (the swizzle acts on the address bits, so the atoms' rows stay where
  // they are)
  auto scores = [&](auto& sc, int st) {
    const unsigned char* ks = kv + st * S::kStageBytes;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      const uint64_t da =
          wgmma_desc(qw + c * kSm90BlockQ * kSm90RowBytes + off, 16, 1024);
      const uint64_t db =
          wgmma_desc(ks + c * kSm90BlockK * kSm90RowBytes + off, 16, 1024);
      if constexpr (sizeof(sc) == 64 * sizeof(float))
        wgmma_m64n128k16_ss(sc, da, db, kk > 0);
      else
        wgmma_m64n16k16_ss(sc, da, db, kk > 0);
    }
    wgmma_commit();
  };
  // o += p . v of stage st, p in bf16 A fragments pk of one 16-key step
  // each, v's [key][64] tiles MN-major; a step is two whole swizzle atoms
  // (16 rows of 128 bytes) further
  auto values = [&](const auto& pk, int st) {
    constexpr int steps = sizeof(pk) / sizeof(pk[0]);
    const unsigned char* vs = kv + st * S::kStageBytes + S::kKvBytes;
#pragma unroll
    for (int kk = 0; kk < steps; ++kk) {
#pragma unroll
      for (int c = 0; c < kBlocks; ++c)
        wgmma_m64n64k16_rs(
            o[c], pk[kk],
            wgmma_desc(vs + (c * kSm90BlockK + 16 * kk) * kSm90RowBytes,
                       kSm90BlockK * kSm90RowBytes, 1024),
            1);
    }
    wgmma_commit();
  };
  // the scores of the tile from k0 (stage st) into log2 units: times the
  // scale and plus the bias unless the scale folds into the softmax's
  // exponent; returns the factor left for it
  auto to_log2 = [&](auto& sc, int k0, int st) -> float {
    constexpr int nj = sizeof(sc) / sizeof(float) / 4;
    if (fold) return scale2;
#pragma unroll
    for (int i = 0; i < 4 * nj; ++i) sc[i] *= scale2;
    if constexpr (kBoxBias<BiasT>) {
      // the pair of row r, keys 8j + 2t of box j / 8 in chunk (j % 8) ^ (r
      // % 8) of its 128 bytes; r % 8 == g for both of the thread's rows
      const unsigned char* box = kv + st * S::kStageBytes + 2 * S::kKvBytes +
                                 rl * kSm90RowBytes + 4 * t;
#pragma unroll
      for (int j = 0; j < nj; ++j) {
        const unsigned char* at = box + (j / 8) * kSm90BlockQ * kSm90RowBytes +
                                  (((j & 7) ^ g) << 4);
        const float2 b0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(at));
        const float2 b1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(at + 8 * kSm90RowBytes));
        sc[4 * j] = fmaf(b0.x, kLog2e, sc[4 * j]);
        sc[4 * j + 1] = fmaf(b0.y, kLog2e, sc[4 * j + 1]);
        sc[4 * j + 2] = fmaf(b1.x, kLog2e, sc[4 * j + 2]);
        sc[4 * j + 3] = fmaf(b1.y, kLog2e, sc[4 * j + 3]);
      }
    } else if constexpr (kHasBias<BiasT>) {
#pragma unroll
      for (int j = 0; j < nj; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + 8 * j + 2 * t + (i & 1);
          const int row = i < 2 ? row0 : row1;
          if (key < kend && row < lq)
            sc[4 * j + i] +=
                to_float(bias_bh[(long long)row * bias_rs + key]) * kLog2e;
        }
    }
    return 1.f;
  };
  auto rescale = [&]() {
#pragma unroll
    for (int c = 0; c < kBlocks; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[c][4 * j] *= alpha[0];
        o[c][4 * j + 1] *= alpha[0];
        o[c][4 * j + 2] *= alpha[1];
        o[c][4 * j + 3] *= alpha[1];
      }
  };
  auto wait_values = [&](int st) {
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kBlocks; ++c) fence_regs(o[c]);
    mbar_arrive(empty + st);        // stage st may be refilled
  };

  // key tile kt as the i-th of the work tile's, its stage the ring's next
  auto wide_tile = [&](int kt, int i) {
    const int st = (ring + i) % S::kStages;
    mbar_wait_or_trap(full + st, ((ring + i) / S::kStages) & 1);
    __syncwarp();                   // the warp converged for wgmma
    wgmma_fence();
    scores(s, st);
    wgmma_wait<0>();
    fence_regs(s);
    if (i == n_tiles - 1) mbar_arrive(qempty);    // the next q may come
    const int k0 = kt * kSm90BlockK;
    sm90_softmax<16>(s, m, l, alpha, kend, k0, t, to_log2(s, k0, st));
    rescale();
    pack_p<16>(s, pa);
    wgmma_fence();
    values(pa, st);
    wait_values(st);
  };
  // the same for a tile of <= 16 keys: N 16, one step of p . v
  auto tail_tile = [&](int kt, int i) {
    const int st = (ring + i) % S::kStages;
    float s16[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s16[j] = 0.f;
    mbar_wait_or_trap(full + st, ((ring + i) / S::kStages) & 1);
    __syncwarp();
    wgmma_fence();
    scores(s16, st);
    wgmma_wait<0>();
    fence_regs(s16);
    if (i == n_tiles - 1) mbar_arrive(qempty);
    const int k0 = kt * kSm90BlockK;
    sm90_softmax<2>(s16, m, l, alpha, kend, k0, t, to_log2(s16, k0, st));
    rescale();
    uint32_t pa16[1][4];
    pack_p<2>(s16, pa16);
    wgmma_fence();
    values(pa16, st);
    wait_values(st);
  };

  const bool tail16 = sm90_tail16(kend, n_tiles);
  if (tail16) tail_tile(n_tiles - 1, 0);
  for (int kt = 0; kt < n_tiles - tail16; ++kt) wide_tile(kt, kt + tail16);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  // a row with no finite score has l == 0 and gives zeros
  const float inv0 = l[0] > 0.f ? 1.f / l[0] : 0.f;
  const float inv1 = l[1] > 0.f ? 1.f / l[1] : 0.f;
  if (p.lse && t == 0) {
    float* lse_bh = p.lse + ((long long)b * p.heads + h) * lq;
    if (row0 < lq) lse_bh[row0] = row_lse(m[0] * kLn2, l[0]);
    if (row1 < lq) lse_bh[row1] = row_lse(m[1] * kLn2, l[1]);
  }
  auto* og = plane<__nv_bfloat16>(p.out, p.st[kO][0], p.st[kO][1], b, h);
  const long long o_rs = p.st[kO][2];
#pragma unroll
  for (int c = 0; c < kBlocks; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = c * kSm90Box + 8 * j + 2 * t;   // D is even: d + 1 < D too
      if (d >= D) continue;
      if (row0 < lq)
        *reinterpret_cast<__nv_bfloat162*>(og + row0 * o_rs + d) =
            __floats2bfloat162_rn(o[c][4 * j] * inv0, o[c][4 * j + 1] * inv0);
      if (row1 < lq)
        *reinterpret_cast<__nv_bfloat162*>(og + row1 * o_rs + d) =
            __floats2bfloat162_rn(o[c][4 * j + 2] * inv1,
                                  o[c][4 * j + 3] * inv1);
    }
}

// Persistent: a block per SM takes work tiles w = blockIdx.x, + gridDim.x,
// ... (query tile fastest, then head, then batch row: w's query tile is w
// % n_qtiles), so that the copy engine brings the next work tile's q and
// first key tiles while the consumers finish this one's last tile and
// store its output. Warpgroups 0 .. kSm90Consumers - 1 consume; the last
// one produces, one thread issuing every copy: each work tile's q once the
// consumers have released the last one, then its key tiles' k and v (and
// with BoxBias the bias's boxes of the block's rows, through bmap) into the
// ring's stages, which run on across work tiles, as the consumers release
// them.
template <int DP, int KD, typename BiasT>
__global__ void __launch_bounds__(kSm90Threads, 1)
attention_fwd_sm90_kernel(const Params p,
                          const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap bmap,
                          const Sm90Slot sq, const Sm90Slot sk,
                          const Sm90Slot sv, int n_qtiles, int n_work) {
  using S = Sm90Smem<DP, BiasT>;
  extern __shared__ __align__(1024) unsigned char sm90_smem[];
  unsigned char* qs = align_1024(sm90_smem);
  unsigned char* kv = qs + S::kQBytes;  // stage s at s kStageBytes: k, v, bias
  auto* full = reinterpret_cast<uint64_t*>(qs + S::kBarOffset);
  uint64_t* empty = full + S::kStages;
  uint64_t* qfull = empty + S::kStages;
  uint64_t* qempty = qfull + 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128 * kSm90Consumers);
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, 128 * kSm90Consumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_tiles = (p.kend + kSm90BlockK - 1) / kSm90BlockK;
  const int wg = threadIdx.x / 128;
  if (wg == kSm90Consumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kSm90ProducerRegs));
    if (threadIdx.x != 128 * kSm90Consumers) return;
    const bool tail16 = sm90_tail16(p.kend, n_tiles);
    int ring = 0;
    for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
      const int q0 = w % n_qtiles * kSm90BlockQ, h = w / n_qtiles % p.heads,
                b = w / n_qtiles / p.heads;
      if (n > 0) mbar_wait_or_trap(qempty, (n - 1) & 1);
      mbar_arrive_expect_tx(qfull, S::kQBytes);
      for (int c = 0; c < S::kBlocks; ++c)
        tma_load_at(qs + c * kSm90BlockQ * kSm90RowBytes, &qmap, qfull, sq,
                    c * kSm90Box, b, h, q0);
      for (int i = 0; i < n_tiles; ++i, ++ring) {
        const int k0 = kSm90BlockK * sm90_key_tile(i, n_tiles, tail16);
        const int st = ring % S::kStages;
        mbar_wait_or_trap(empty + st, ((ring / S::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full + st, S::kStageBytes);
        unsigned char* ks = kv + st * S::kStageBytes;
        for (int c = 0; c < S::kBlocks; ++c) {
          const int at = c * kSm90BlockK * kSm90RowBytes;
          tma_load_at(ks + at, &kmap, full + st, sk, c * kSm90Box, b, h,
                      k0);
          tma_load_at(ks + S::kKvBytes + at, &vmap, full + st, sv,
                      c * kSm90Box, b, h, k0);
        }
        if constexpr (kBoxBias<BiasT>) {
          // (key, row, head, batch); a shared plane is batch 0
          const int bb = p.st[kBias][0] ? b : 0;
          for (int c = 0; c < kSm90BlockK / kSm90Box; ++c)
            tma_load_4d(ks + 2 * S::kKvBytes +
                            c * kSm90BlockQ * kSm90RowBytes,
                        &bmap, full + st, k0 + c * kSm90Box, q0, h, bb);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kSm90ConsumerRegs));
    for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
      const int q0 = w % n_qtiles * kSm90BlockQ, h = w / n_qtiles % p.heads,
                b = w / n_qtiles / p.heads;
      sm90_consumer<DP, KD, BiasT>(p, qs, kv, full, empty, qfull, qempty, wg,
                                   q0, h, b, n_tiles, n * n_tiles, n & 1);
    }
  }
}

// The copy engine's map of a head-major bf16 operand (batch, head, row, d)
// with element strides st (batch, head, row; d contiguous): dimensions d,
// then the other three in the order of their strides, boxes of 64 columns
// by box_rows rows (zeros past D and past `rows`) in 128-byte swizzle;
// *slot receives where batch, head and row lie among dimensions 1-3.
cudaError_t encode_hmajor_map(CUtensorMap* map, Sm90Slot* slot,
                              const void* base, const long long st[3], int B,
                              int H, int rows, int D, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t extent[3] = {(cuuint64_t)B, (cuuint64_t)H,
                                (cuuint64_t)rows};
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && st[order[j - 1]] > st[order[j]]; --j) {
      const int x = order[j];
      order[j] = order[j - 1];
      order[j - 1] = x;
    }
  cuuint64_t dims[4] = {(cuuint64_t)D}, strides[3];
  cuuint32_t box[4] = {kSm90Box};
  int at[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = extent[order[i]];
    strides[i] = (cuuint64_t)st[order[i]] * sizeof(__nv_bfloat16);
    box[i + 1] = order[i] == 2 ? box_rows : 1;
    at[order[i]] = i + 1;
  }
  *slot = Sm90Slot{at[0], at[1], at[2]};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The copy engine's map of the token-major bias (B or 1, H, L, L) bf16,
// L = p.lq, batch stride p.st[kBias][0] (0: one plane that every batch row
// reads, as batch 0): dimensions key, row, head, batch, boxes of 64 keys by
// kSm90BlockQ rows in 128-byte swizzle (zeros past L)
cudaError_t encode_bias_map(CUtensorMap* map, const Params& p, int B, int H) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t L = p.lq, bs = p.st[kBias][0];
  const cuuint64_t dims[4] = {L, L, (cuuint64_t)H, bs ? (cuuint64_t)B : 1};
  const cuuint64_t strides[3] = {L * 2, L * L * 2, (bs ? bs : H * L * L) * 2};
  const cuuint32_t box[4] = {kSm90Box, kSm90BlockQ, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p.bias),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a persistent grid of min(n_work, SMs) blocks
cudaError_t persistent_blocks(long long n_work, int* blocks) {
  int device, n_sm;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if (n_work > INT_MAX) return cudaErrorInvalidValue;
  *blocks = (int)(n_work < n_sm ? n_work : n_sm);
  return cudaSuccess;
}

template <int DP, int KD, typename BiasT>
cudaError_t launch_sm90(const Params& p, int B, int H, cudaStream_t stream) {
  CUtensorMap maps[3], bmap = {};
  Sm90Slot slots[3];
  const int rows[3] = {p.lq, p.kend, p.kend};
  const int box_rows[3] = {kSm90BlockQ, kSm90BlockK, kSm90BlockK};
  for (int o = kQ; o <= kV; ++o) {
    const cudaError_t err = encode_hmajor_map(
        &maps[o], &slots[o], p.in[o], p.st[o], B, H, rows[o], p.d,
        box_rows[o]);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaSuccess;
  if constexpr (kBoxBias<BiasT>) err = encode_bias_map(&bmap, p, B, H);
  auto kern = attention_fwd_sm90_kernel<DP, KD, BiasT>;
  const size_t smem = Sm90Smem<DP, BiasT>::kBytes;
  if (err == cudaSuccess) err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  // a persistent block an SM (the registers of all 384 threads fill it)
  const int n_qtiles = (p.lq + kSm90BlockQ - 1) / kSm90BlockQ;
  const long long n_work = (long long)n_qtiles * H * B;
  int blocks;
  if ((err = persistent_blocks(n_work, &blocks)) != cudaSuccess) return err;
  kern<<<blocks, kSm90Threads, smem, stream>>>(
      p, maps[kQ], maps[kK], maps[kV], bmap, slots[kQ], slots[kK], slots[kV],
      n_qtiles, (int)n_work);
  return cudaGetLastError();
}

// D 64 and below on one 64-column box; above, two boxes, q . k^T stopping
// at 96 where D allows and there is no bias
template <typename BiasT>
cudaError_t dispatch_sm90(const Params& p, int B, int H, cudaStream_t s) {
  if (p.d <= 64) return launch_sm90<64, 4, BiasT>(p, B, H, s);
  if constexpr (!kHasBias<BiasT>) {
    if (p.d <= 96) return launch_sm90<128, 6, BiasT>(p, B, H, s);
  }
  return launch_sm90<128, 8, BiasT>(p, B, H, s);
}

// The copy engine reads q, k and v, and the epilogue writes bf16 pairs:
// bf16, D a multiple of 8 (16 bytes) up to 128, every stride of q, k and
// v a positive multiple of 8 elements, their bases 16-byte aligned; the
// output's strides even and its base 4-byte aligned; and the launch's
// sizes: Lq, kend, B and H from 1, B and H below 65536.
bool sm90_takes(const Params& p, int dtype, int B, int H) {
  if (dtype != kBf16 || p.d < 8 || p.d > kMaxD || p.d % 8 || p.lq < 1 ||
      p.kend < 1 || B < 1 || H < 1 || B > 65535 || H > 65535)
    return false;
  for (int o = kQ; o <= kV; ++o) {
    if (reinterpret_cast<uintptr_t>(p.in[o]) % 16) return false;
    for (int j = 0; j < 3; ++j)
      if (p.st[o][j] <= 0 || p.st[o][j] % 8) return false;
  }
  for (int j = 0; j < 3; ++j)
    if (p.st[kO][j] % 2) return false;
  return reinterpret_cast<uintptr_t>(p.out) % 4 == 0;
}

#if VAST_PART_ON(1)
cudaError_t run_sm90(const Params& p, int dtype, int bias_dtype, int B, int H,
                     cudaStream_t s) {
  if (!sm90_takes(p, dtype, B, H)) return cudaErrorInvalidValue;
  if (!p.bias) return dispatch_sm90<NoBias>(p, B, H, s);
  if (bias_dtype == kBf16) return dispatch_sm90<__nv_bfloat16>(p, B, H, s);
  if (bias_dtype == kF32) return dispatch_sm90<float>(p, B, H, s);
  return cudaErrorInvalidValue;
}
#endif

// The token-major entry's: run_sm90's rule, and a bias (qkv's type, (B or
// 1, H, L, L)) that the copy engine reads too: L and the batch stride
// multiples of 8 elements, the base 16-byte aligned. At D <= 64 the bias
// comes through the copy engine, above by the scalar
// loads of the head-major entry (the stages would not fit).
#if VAST_PART_ON(1)
cudaError_t run_tmajor_sm90(const Params& p, int dtype, int B, int H,
                            cudaStream_t s) {
  if (!sm90_takes(p, dtype, B, H) ||
      (p.bias && (p.lq % 8 || p.st[kBias][0] % 8 ||
                  reinterpret_cast<uintptr_t>(p.bias) % 16)))
    return cudaErrorInvalidValue;
  if (p.bias && p.d <= 64)
    return launch_sm90<64, 4, BoxBias>(p, B, H, s);
  return run_sm90(p, dtype, dtype, B, H, s);
}
#endif

// The Params of the head-major entries (their arguments, described there)
Params hmajor_params(const void* q, const void* k, const void* v,
                     const void* bias, void* out, float* lse, int H, int Lq,
                     int D, int kend, const long long* strides, float scale) {
  Params p = {};
  p.in[kQ] = q;
  p.in[kK] = k;
  p.in[kV] = v;
  memcpy(p.st, strides, sizeof(p.st));
  p.out = out;
  p.bias = bias;
  p.lse = lse;
  p.lq = Lq;
  p.kend = kend;
  p.d = D;
  p.heads = H;
  p.scale = scale;
  return p;
}


// ---------------------------------------------------------------------
// The backward for Hopper: wgmma and the copy engine
// ---------------------------------------------------------------------
//
// Replaces, for bf16 operands the copy engine can read (sm90_bwd_takes,
// below), the backward kernels of vast_tpu/ops/flash_attention.py:
// _tmajor_bwd_kernel (:795) and _tmajor_bwd_kernel_bias (:841) through
// vast_tmajor_attention_bwd_sm90; flash_attention_bwd's fused
// _bwd_fused_kernel_nods / _bwd_fused_kernel (:363 / :321) and its tiled
// _bwd_dkv_kernel (:372) and _bwd_dq_kernel_nods / _bwd_dq_kernel (:451 /
// :413) through vast_flash_attention_bwd_sm90. attention_bwd_dq_sm90_kernel
// is the dQ half of all of them (with ds as dbias, delta and, on the
// token-major entry called without the forward's lse, the lse),
// attention_bwd_dkv_sm90_kernel the dK/dV
// half. The contract is the backward's ("Backward" above); fp32 and the
// views the copy engine cannot read keep the mma.sync and CUDA-core bodies
// through vast_tmajor_attention_bwd and vast_flash_attention_bwd.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): the five Lq x
// Lk x D products of the backward against q, k, v, o and do read once and
// dq, dk and dv written once. EVA01-g's token-major backward (64 x 16
// heads x 257^2 x 88) and AST's (8 x 12 x 257^2 x 64) are bound by bytes;
// CLIP-L/14-336's (64 x 16 x 577^2 x 64) and the 640 x 4873 rerank shape by
// operations. This body does seven products (eight with the token-major
// entry's lse sweep, when it is called without the forward's lse): s and
// dp are formed in both kernels, so that neither
// needs atomics and the gradients are deterministic.
// What the design does about it: every product runs on wgmma with its
// shared-memory operands read by the tensor cores as the copy engine laid
// them (128-byte swizzle), and p and ds go from the accumulators to the A
// operands of the next products in registers, so no thread loads an operand
// fragment; one producer thread issues every copy into a ring of stages, so
// loads run under the products; one persistent block an SM, two consumer
// warpgroups of 64 owned rows whose products and elementwise work
// interleave, setmaxnreg giving them the producer's registers (24 and 240).
// * dQ: a work tile is 2 x 64 query rows of one (batch, head): its q, do and
//   o come once (their own full and empty barriers), key tiles of 64 (k, v)
//   stream through the ring. delta = rowsum(do . o) is summed from those
//   q-side tiles in shared memory. s = q . k^T and dp = do . v^T take both
//   operands from shared memory (K-major); p = exp2(s scale log2e - lse
//   log2e) and ds = p (dp - delta) are formed in registers, ds written as
//   dbias where asked; dq += ds . k takes ds from registers and k MN-major
//   (the transpose bit). The token-major entry called without the
//   forward's lse (lse_given 0) first sweeps the key tiles once more (k
//   alone) for the row max and sum, hence the lse, which it writes with
//   delta for the dK/dV kernel; with it, it reads it as the head-major
//   entry does.
// * dK/dV: a work tile is 2 x 64 keys: its k and v come once, query tiles of
//   64 (q, do, and their 64 lse and 64 delta values through 1-D maps, on the
//   same barrier; each box from a 16-byte boundary, kStatBox below) stream
//   through the ring. s^T = k . q^T and dp^T = v . do^T
//   come from shared memory, p^T and ds^T are formed in registers (lse and
//   delta are indexed by the accumulator's column), and dv += p^T . do and
//   dk += ds^T . q take them from registers, do and q MN-major. dk and dv
//   accumulate in registers over every query tile.
// Ragged ends: streamed tiles of 64 (L 257: 5 tiles, 320 rows for 257,
// 1.25x; 577: 10 tiles, 1.11x); rows past the end read as zeros and are
// masked in registers, as are keys past kend that are real data (the
// layout probe's 257 of 272). Owned tiles of 2 x 64 rows: at L
// 257 the third work tile of a head holds one row, and its second
// warpgroup, which owns none, issues no product (it keeps the barriers'
// count).
// D: the products over D issue ceil(D / 16) k-steps, at most 96 for D <=
// 96 without a bias (EVA's 88: 6 steps, 9% over 88). The products whose N
// is D (dq, dk, dv) run whole 64-column boxes, since the MN-major operand's
// 128-byte swizzle atom is 64 columns wide: 128 at D 88 (45% over 88), so
// EVA's backward does 1.23x the tensor work of D 88 (1.45x with 128
// throughout). The copy engine zero-fills the columns past D in shared
// memory; nothing is padded in device memory.
// Tried and kept out, on the H100 (PERF.md): a 16-wide last tile (wgmma's
// N 16) for the one-row tails of 257 and 577 gained little, for a build a
// third longer, since a tile's time is the latency of its two product
// groups and their waits more than their width; one group a tile (tile
// i's dq, or dv and dk, products with tile i + 1's s and dp) ran slower at
// every path shape: ptxas serialized the wgmmas (C7520) and spilled in the
// DP 128 dK/dV kernels.
// Not here, later levers: one fused kernel with an atomic dq (five
// products, not deterministic), owned tiles of 64 rows at L 257,
// overlapping a tile's elementwise work with the last tile's products.

constexpr int kBwdSm90Owned = 64 * kSm90Consumers;  // rows a block owns
constexpr int kBwdSm90Inner = 64;                   // rows of a streamed tile
constexpr int kBwdSm90Stages = 3;   // the copy engine up to 2 tiles ahead

// dQ's shared memory, each tile 1024-byte aligned: the work tile's q, do
// and o, then each stage's k and v, then the barriers (full and empty per
// stage, then the work tile's full and empty). A tile of R rows is DP / 64
// boxes of R x 128 bytes.
template <int DP>
struct BwdDqSmem {
  static constexpr int kBlocks = DP / kSm90Box;
  static constexpr unsigned kOwnedBytes = kBwdSm90Owned * DP * 2;   // q, do or o
  static constexpr unsigned kTileBytes = kBwdSm90Inner * DP * 2;    // k or v
  static constexpr unsigned kStageBytes = 2 * kTileBytes;
  static constexpr unsigned kBarOffset =
      3 * kOwnedBytes + kBwdSm90Stages * kStageBytes;
  static constexpr size_t kBytes =
      kBarOffset + (2 * kBwdSm90Stages + 2) * 8 + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory on sm_90");
};

// The copy engine faults on a box that starts off a 16-byte boundary, and
// a query tile's lse and delta start at element (b H + h) Lq + q0: so its
// box starts at that element rounded down to a multiple of 4 and holds
// kStatBox values, and the tile's 64 lie 0-3 values in.
constexpr int kStatBox = kBwdSm90Inner + 4;

// dK/dV's: the work tile's k and v, then each stage's q, do, and the query
// tile's lse and delta boxes (kStatBox fp32 each, delta kStatStride bytes
// after lse, both in a 1024-byte pad), then the barriers as dQ's.
template <int DP>
struct BwdDkvSmem {
  static constexpr int kBlocks = DP / kSm90Box;
  static constexpr unsigned kOwnedBytes = kBwdSm90Owned * DP * 2;   // k or v
  static constexpr unsigned kTileBytes = kBwdSm90Inner * DP * 2;    // q or do
  static constexpr unsigned kStatBytes = kStatBox * 4;     // lse or delta
  static constexpr unsigned kStatStride = 512;
  static constexpr unsigned kStageBytes = 2 * kTileBytes + 1024;
  static constexpr unsigned kBarOffset =
      2 * kOwnedBytes + kBwdSm90Stages * kStageBytes;
  static constexpr size_t kBytes =
      kBarOffset + (2 * kBwdSm90Stages + 2) * 8 + 1024;
  static_assert(kStatStride + kStatBytes <= 1024,
                "lse and delta in a stage's pad");
  static_assert(kBytes <= 232448, "a block's shared memory on sm_90");
};

// The copy engine's maps of one backward kernel: the work tile's operands
// (own: q, do and o for dQ; k and v for dK/dV; boxes of kBwdSm90Owned rows),
// the streamed ones (str: k and v for dQ; q and do for dK/dV; boxes of
// kBwdSm90Inner rows), each with its slots, and dK/dV's 1-D maps of lse and
// delta (stat; boxes of kStatBox values).
struct BwdMaps {
  CUtensorMap own[3], str[2], stat[2];
  Sm90Slot own_slot[3], str_slot[2];
};

// the box at `c0` of a 1-D map; its bytes complete on `bar`
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// d[0..31] (+)= a . b over 16 of the reduction: a 64 x 16 tile and b a
// 16 x 64 tile, both in shared memory and K-major; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a,
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// acc = a . b^T over the first 16 KD columns (of D): a the warpgroup's 64
// rows of a tile whose boxes lie a_rows rows apart, b a streamed tile of
// kBwdSm90Inner rows, both K-major as the copy engine laid them; a 16-column
// step moves both descriptors 32 bytes (as sm90_consumer's scores). Not
// committed.
template <int KD>
__device__ __forceinline__ void bwd_sm90_abt(float (&acc)[32],
                                             const unsigned char* a,
                                             int a_rows,
                                             const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 32;
    wgmma_m64n64k16_ss(
        acc, wgmma_desc(a + c * a_rows * kSm90RowBytes + off, 16, 1024),
        wgmma_desc(b + c * kBwdSm90Inner * kSm90RowBytes + off, 16, 1024),
        kk > 0);
  }
}

// acc[c] += x . y over the kBwdSm90Inner rows of a streamed tile y: x (64
// x kBwdSm90Inner) in registers as A fragments, y's boxes MN-major (the
// transpose bit), one 64-column box c of the result at a time. Not
// committed.
template <int kBlocks>
__device__ __forceinline__ void bwd_sm90_xy(float (&acc)[kBlocks][32],
                                            const uint32_t (&x)[4][4],
                                            const unsigned char* y) {
#pragma unroll
  for (int kk = 0; kk < kBwdSm90Inner / 16; ++kk)
#pragma unroll
    for (int c = 0; c < kBlocks; ++c)
      wgmma_m64n64k16_rs(
          acc[c], x[kk],
          wgmma_desc(y + (c * kBwdSm90Inner + 16 * kk) * kSm90RowBytes,
                     kBwdSm90Inner * kSm90RowBytes, 1024),
          1);
}

// The A fragments (bf16 pairs) of columns 16kk..16kk+15 of an m64n64k16
// accumulator x, for the products that reduce over those columns (as
// pack_p does for the forward's p)
__device__ __forceinline__ void bwd_sm90_pack(const float (&x)[32],
                                              uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j / 2][(j & 1) * 2] = pack_bf16(x[4 * j], x[4 * j + 1]);
    a[j / 2][(j & 1) * 2 + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

// rows row0 and row0 + 8 of an accumulator of kBlocks 64-column boxes (the
// thread's fragment), times mul, as bf16 pairs into a plane with row stride
// rs; rows >= rend and columns >= D (a multiple of 8) are not stored
template <int kBlocks>
__device__ __forceinline__ void bwd_sm90_store(__nv_bfloat16* dst,
                                               long long rs,
                                               const float (&acc)[kBlocks][32],
                                               int row0, int rend, int D,
                                               float mul, int t) {
#pragma unroll
  for (int c = 0; c < kBlocks; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = c * kSm90Box + 8 * j + 2 * t;
      if (d >= D) continue;
      if (row0 < rend)
        *reinterpret_cast<__nv_bfloat162*>(dst + row0 * rs + d) =
            __floats2bfloat162_rn(acc[c][4 * j] * mul,
                                  acc[c][4 * j + 1] * mul);
      if (row0 + 8 < rend)
        *reinterpret_cast<__nv_bfloat162*>(dst + (row0 + 8) * rs + d) =
            __floats2bfloat162_rn(acc[c][4 * j + 2] * mul,
                                  acc[c][4 * j + 3] * mul);
    }
}

// the dot product of two 16-byte chunks of bf16 in fp32
__device__ __forceinline__ float dot_bf16x8(uint4 a, uint4 b) {
  const uint32_t xa[4] = {a.x, a.y, a.z, a.w}, xb[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xa[i]));
    const float2 fb =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xb[i]));
    s = fmaf(fa.x, fb.x, s);
    s = fmaf(fa.y, fb.y, s);
  }
  return s;
}

// One dQ consumer warpgroup `wg`: its 64 query rows of one work tile (rows
// q0.., head h, batch row b). Accumulator layout as sm90_consumer's: the
// thread's rows are r0 = 64 wg + 16 warp + g and r0 + 8, its columns (keys)
// 8j + 2t (+1). The ring's stages go on from tile `ring`; the work tile's
// barrier is in phase `ophase`.
template <int DP, int KD, typename BiasT, typename DsT>
__device__ __forceinline__ void bwd_dq_consumer(
    const BwdParams& p, const unsigned char* qs, const unsigned char* dos,
    const unsigned char* os, const unsigned char* ring, uint64_t* full,
    uint64_t* empty, uint64_t* ofull, uint64_t* oempty, int wg, int q0,
    int h, int b, int n_k, int ring0, unsigned ophase) {
  using S = BwdDqSmem<DP>;
  constexpr int kBlocks = S::kBlocks;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * warp + g;
  const int row0 = q0 + r0, row1 = row0 + 8;
  const int lq = p.lq, lk = p.lk, kend = p.kend;
  const bool active = q0 + 64 * wg < lq;   // the warpgroup owns a row
  const float scale2 = p.scale * kLog2e;
  const long long stat0 = ((long long)b * p.H + h) * lq;
  const BiasT* bias_bh = nullptr;
  long long bias_rs = 0;
  if constexpr (kHasBias<BiasT>) {
    bias_bh = bwd_plane<const BiasT>(p, bBias, p.bias, b, h);
    bias_rs = p.st[bBias][2];
  }
  DsT* dbias_bh = nullptr;
  long long dbias_rs = 0;
  if constexpr (kHasBias<DsT>) {
    dbias_bh = bwd_plane<DsT>(p, bDBias, p.dbias, b, h);
    dbias_rs = p.st[bDBias][2];
  }
  const unsigned char* qw = qs + 64 * wg * kSm90RowBytes;
  const unsigned char* dow = dos + 64 * wg * kSm90RowBytes;
  mbar_wait_or_trap(ofull, ophase);

  // delta of rows r0 and r0 + 8 from do and o in shared memory: the quad's
  // four threads take 16-byte chunks (t + g + 4i) % 8 of each row's 128
  // bytes in each box (the swizzle only permutes a row's chunks, the same
  // way in do and o; g spreads the quads over the banks)
  float delta[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < kBlocks; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int off = (c * kBwdSm90Owned + r0 + 8 * r) * kSm90RowBytes +
                        ((t + g + 4 * i) & 7) * 16;
        acc += dot_bf16x8(*reinterpret_cast<const uint4*>(dos + off),
                          *reinterpret_cast<const uint4*>(os + off));
      }
    acc += __shfl_xor_sync(kFull, acc, 1);
    acc += __shfl_xor_sync(kFull, acc, 2);
    delta[r] = acc;
  }
  if (t == 0) {
    if (row0 < lq) p.delta[stat0 + row0] = delta[0];
    if (row1 < lq) p.delta[stat0 + row1] = delta[1];
  }

  float s[32], dp[32];
  const int n_pass = p.lse_given ? 1 : 2;
  if (p.lse_given) {
    lse2[0] = row0 < lq ? p.lse[stat0 + row0] * kLog2e : INFINITY;
    lse2[1] = row1 < lq ? p.lse[stat0 + row1] * kLog2e : INFINITY;
  } else {
    // sweep 1, k alone: each row's max m and sum l of exp2 in log2 units
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int it = 0; it < n_k; ++it) {
      const int ri = ring0 + it, st = ri % kBwdSm90Stages;
      mbar_wait_or_trap(full + st, (ri / kBwdSm90Stages) & 1);
      if (active) {
        __syncwarp();
        wgmma_fence();
        bwd_sm90_abt<KD>(s, qw, kBwdSm90Owned,
                         ring + st * S::kStageBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        const int k0 = it * kBwdSm90Inner;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = k0 + 8 * j + 2 * t + (i & 1);
            const int row = i < 2 ? row0 : row1;
            float x = s[4 * j + i] * scale2;
            if constexpr (kHasBias<BiasT>) {
              if (key < kend && row < lq)
                x = fmaf(to_float(bias_bh[(long long)row * bias_rs + key]),
                         kLog2e, x);
            }
            x = key < kend ? x : -INFINITY;
            s[4 * j + i] = x;
            mx[i >> 1] = fmaxf(mx[i >> 1], x);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
          const float mn = fmaxf(m[r], mx[r]);
          const float ne = -exp_ref(mn);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            sum += ex2(s[4 * j + 2 * r] + ne) + ex2(s[4 * j + 2 * r + 1] + ne);
          l[r] = l[r] * ex2(m[r] + ne) + sum;
          m[r] = mn;
        }
      }
      mbar_arrive(empty + st);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
      // in log2 units from the natural lse, as the dK/dV kernel forms it
      const float lse = row_lse(m[r] * kLn2, l[r]);
      if (t == 0 && (r ? row1 : row0) < lq)
        p.lse[stat0 + (r ? row1 : row0)] = lse;
      lse2[r] = lse * kLog2e;
    }
  }

  // sweep 2: p, dp = do . v^T, ds (and dbias), dq += ds . k
  float dq[kBlocks][32];
#pragma unroll
  for (int c = 0; c < kBlocks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[c][i] = 0.f;
  const int ring2 = ring0 + (n_pass - 1) * n_k;
  for (int it = 0; it < n_k; ++it) {
    const int ri = ring2 + it, st = ri % kBwdSm90Stages;
    mbar_wait_or_trap(full + st, (ri / kBwdSm90Stages) & 1);
    const unsigned char* ks = ring + st * S::kStageBytes;
    if (active) {
      __syncwarp();
      wgmma_fence();
      bwd_sm90_abt<KD>(s, qw, kBwdSm90Owned, ks);
      bwd_sm90_abt<KD>(dp, dow, kBwdSm90Owned, ks + S::kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (it == n_k - 1) mbar_arrive(oempty);    // the next q, do, o may come
      const int k0 = it * kBwdSm90Inner;
      const bool edge = k0 + kBwdSm90Inner > kend;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + 8 * j + 2 * t + (i & 1);
          const int r = i >> 1, row = r ? row1 : row0;
          float x = fmaf(s[4 * j + i], scale2, -lse2[r]);
          if constexpr (kHasBias<BiasT>) {
            if (key < kend && row < lq)
              x = fmaf(to_float(bias_bh[(long long)row * bias_rs + key]),
                       kLog2e, x);
          }
          float pr = ex2(x);
          if (edge && key >= kend) pr = 0.f;
          const float ds = pr * (dp[4 * j + i] - delta[r]);
          if constexpr (kHasBias<DsT>) {
            if (row < lq && key < lk)
              to_out(dbias_bh + (long long)row * dbias_rs + key, ds);
          }
          s[4 * j + i] = ds;
        }
      uint32_t da[4][4];
      bwd_sm90_pack(s, da);
      wgmma_fence();
      bwd_sm90_xy<kBlocks>(dq, da, ks);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kBlocks; ++c) fence_regs(dq[c]);
    } else if (it == n_k - 1) {
      mbar_arrive(oempty);
    }
    mbar_arrive(empty + st);                     // stage st may be refilled
  }
  if (active)
    bwd_sm90_store<kBlocks>(bwd_plane<__nv_bfloat16>(p, bDQ, p.grad[0], b, h),
                            p.st[bDQ][2], dq, row0, lq, p.D, p.scale, t);
}

// One dK/dV consumer warpgroup `wg`: its 64 keys of one work tile (keys
// k0.., head h, batch row b). The accumulators are transposed: the
// thread's rows are keys key0 = k0 + 64 wg + 16 warp + g and key0 + 8, its
// columns queries 8j + 2t (+1) of the streamed tile, whose lse and delta
// come with it.
template <int DP, int KD, typename BiasT>
__device__ __forceinline__ void bwd_dkv_consumer(
    const BwdParams& p, const unsigned char* ks, const unsigned char* vs,
    const unsigned char* ring, uint64_t* full, uint64_t* empty,
    uint64_t* ofull, uint64_t* oempty, int wg, int k0, int h, int b,
    int n_q, int ring0, unsigned ophase) {
  using S = BwdDkvSmem<DP>;
  constexpr int kBlocks = S::kBlocks;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + 64 * wg + 16 * warp + g, key1 = key0 + 8;
  const int lq = p.lq, lk = p.lk, kend = p.kend;
  const int stat0 = (b * p.H + h) * lq;    // the plane's first lse and delta
  // keys in [kend, lk) get dk = dv = 0 (their p is 0), so they are stored
  const bool active = k0 + 64 * wg < lk;
  const bool key_edge = k0 + 64 * wg + 64 > kend;
  const float scale2 = p.scale * kLog2e;
  const BiasT* bias_bh = nullptr;
  long long bias_rs = 0;
  if constexpr (kHasBias<BiasT>) {
    bias_bh = bwd_plane<const BiasT>(p, bBias, p.bias, b, h);
    bias_rs = p.st[bBias][2];
  }
  const unsigned char* kw = ks + 64 * wg * kSm90RowBytes;
  const unsigned char* vw = vs + 64 * wg * kSm90RowBytes;
  float dk[kBlocks][32], dv[kBlocks][32];
#pragma unroll
  for (int c = 0; c < kBlocks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.f;
  mbar_wait_or_trap(ofull, ophase);
  for (int it = 0; it < n_q; ++it) {
    const int ri = ring0 + it, st = ri % kBwdSm90Stages;
    mbar_wait_or_trap(full + st, (ri / kBwdSm90Stages) & 1);
    const unsigned char* qt = ring + st * S::kStageBytes;
    const unsigned char* dot = qt + S::kTileBytes;
    // the tile's lse and delta, (stat0 + q0) % 4 values into their boxes
    const int q0 = it * kBwdSm90Inner, at = (stat0 + q0) & 3;
    const float* lse_s =
        reinterpret_cast<const float*>(qt + 2 * S::kTileBytes) + at;
    const float* delta_s = reinterpret_cast<const float*>(
        qt + 2 * S::kTileBytes + S::kStatStride) + at;
    if (active) {
      float sT[32], dpT[32];
      __syncwarp();
      wgmma_fence();
      bwd_sm90_abt<KD>(sT, kw, kBwdSm90Owned, qt);
      bwd_sm90_abt<KD>(dpT, vw, kBwdSm90Owned, dot);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sT);
      fence_regs(dpT);
      if (it == n_q - 1) mbar_arrive(oempty);    // the next k, v may come
      const bool edge = key_edge || q0 + kBwdSm90Inner > lq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float lse[2] = {lse_s[c] * kLog2e, lse_s[c + 1] * kLog2e};
        const float dl[2] = {delta_s[c], delta_s[c + 1]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + c + (i & 1);
          const int key = i < 2 ? key0 : key1;
          float x = fmaf(sT[4 * j + i], scale2, -lse[i & 1]);
          if constexpr (kHasBias<BiasT>) {
            if (key < kend && q < lq)
              x = fmaf(to_float(bias_bh[(long long)q * bias_rs + key]),
                       kLog2e, x);
          }
          float pr = ex2(x);
          // the columns past lq read another head's lse (or zeros)
          if (edge && (key >= kend || q >= lq)) pr = 0.f;
          dpT[4 * j + i] = pr * (dpT[4 * j + i] - dl[i & 1]);
          sT[4 * j + i] = pr;
        }
      }
      uint32_t pa[4][4], da[4][4];
      bwd_sm90_pack(sT, pa);
      bwd_sm90_pack(dpT, da);
      wgmma_fence();
      bwd_sm90_xy<kBlocks>(dv, pa, dot);
      bwd_sm90_xy<kBlocks>(dk, da, qt);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kBlocks; ++c) {
        fence_regs(dk[c]);
        fence_regs(dv[c]);
      }
    } else if (it == n_q - 1) {
      mbar_arrive(oempty);
    }
    mbar_arrive(empty + st);                     // stage st may be refilled
  }
  if (active) {
    bwd_sm90_store<kBlocks>(bwd_plane<__nv_bfloat16>(p, bDK, p.grad[1], b, h),
                            p.st[bDK][2], dk, key0, lk, p.D, p.scale, t);
    bwd_sm90_store<kBlocks>(bwd_plane<__nv_bfloat16>(p, bDV, p.grad[2], b, h),
                            p.st[bDV][2], dv, key0, lk, p.D, 1.f, t);
  }
}

// the barriers of a backward block at `bar`: full and empty per stage, then
// the work tile's full and empty (one arrival for a full barrier, the
// producer's with its bytes; every consumer thread for an empty one)
__device__ __forceinline__ void bwd_sm90_init(uint64_t* bar) {
  if (threadIdx.x == 0) {
    for (int s = 0; s <= kBwdSm90Stages; ++s) {   // the stages, the work tile
      const int at = s < kBwdSm90Stages ? s : 2 * kBwdSm90Stages;
      const int n = s < kBwdSm90Stages ? kBwdSm90Stages : 1;
      mbar_init(bar + at, 1);
      mbar_init(bar + at + n, 128 * kSm90Consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// (query or key tile, head, batch row) of work tile w, tiles fastest
struct BwdWork {
  int r0, h, b;
};

__device__ __forceinline__ BwdWork bwd_work(int w, int n_tiles, int H) {
  return BwdWork{w % n_tiles * kBwdSm90Owned, w / n_tiles % H,
                 w / n_tiles / H};
}

// Persistent, as attention_fwd_sm90_kernel: a block per SM takes work tiles
// w = blockIdx.x, + gridDim.x, ...; warpgroups 0 .. kSm90Consumers - 1
// consume, the last one's first thread issues every copy: a work tile's q,
// do and o once the consumers have released the last ones, then its key
// tiles (k alone in the lse sweep, k and v after) into the ring's stages,
// which run on across work tiles.
template <int DP, int KD, typename BiasT, typename DsT>
__global__ void __launch_bounds__(kSm90Threads, 1)
attention_bwd_dq_sm90_kernel(const BwdParams p,
                             const __grid_constant__ BwdMaps m, int n_qtiles,
                             int n_work) {
  using S = BwdDqSmem<DP>;
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  unsigned char* qs = align_1024(bwd_smem);
  unsigned char* dos = qs + S::kOwnedBytes;
  unsigned char* os = dos + S::kOwnedBytes;
  unsigned char* ring = os + S::kOwnedBytes;
  auto* full = reinterpret_cast<uint64_t*>(qs + S::kBarOffset);
  uint64_t* empty = full + kBwdSm90Stages;
  uint64_t* ofull = empty + kBwdSm90Stages;
  uint64_t* oempty = ofull + 1;
  bwd_sm90_init(full);
  const int n_k = (p.kend + kBwdSm90Inner - 1) / kBwdSm90Inner;
  const int n_pass = p.lse_given ? 1 : 2;
  const int wg = threadIdx.x / 128;
  if (wg == kSm90Consumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kSm90ProducerRegs));
    if (threadIdx.x != 128 * kSm90Consumers) return;
    int ri = 0;
    for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
      const BwdWork wk = bwd_work(w, n_qtiles, p.H);
      if (n > 0) mbar_wait_or_trap(oempty, (n - 1) & 1);
      mbar_arrive_expect_tx(ofull, 3 * S::kOwnedBytes);
      for (int c = 0; c < S::kBlocks; ++c) {
        const int at = c * kBwdSm90Owned * kSm90RowBytes;
        tma_load_at(qs + at, &m.own[0], ofull, m.own_slot[0], c * kSm90Box,
                    wk.b, wk.h, wk.r0);
        tma_load_at(dos + at, &m.own[1], ofull, m.own_slot[1], c * kSm90Box,
                    wk.b, wk.h, wk.r0);
        tma_load_at(os + at, &m.own[2], ofull, m.own_slot[2], c * kSm90Box,
                    wk.b, wk.h, wk.r0);
      }
      for (int pass = 2 - n_pass; pass < 2; ++pass)
        for (int it = 0; it < n_k; ++it, ++ri) {
          const int st = ri % kBwdSm90Stages;
          mbar_wait_or_trap(empty + st, ((ri / kBwdSm90Stages) & 1) ^ 1);
          // pass 0 (the lse sweep) brings k alone
          mbar_arrive_expect_tx(full + st,
                                pass ? S::kStageBytes : S::kTileBytes);
          unsigned char* ks = ring + st * S::kStageBytes;
          for (int c = 0; c < S::kBlocks; ++c) {
            const int at = c * kBwdSm90Inner * kSm90RowBytes;
            tma_load_at(ks + at, &m.str[0], full + st, m.str_slot[0],
                        c * kSm90Box, wk.b, wk.h, it * kBwdSm90Inner);
            if (pass)
              tma_load_at(ks + S::kTileBytes + at, &m.str[1], full + st,
                          m.str_slot[1], c * kSm90Box, wk.b, wk.h,
                          it * kBwdSm90Inner);
          }
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kSm90ConsumerRegs));
    for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
      const BwdWork wk = bwd_work(w, n_qtiles, p.H);
      bwd_dq_consumer<DP, KD, BiasT, DsT>(p, qs, dos, os, ring, full, empty,
                                          ofull, oempty, wg, wk.r0, wk.h,
                                          wk.b, n_k, n * n_k * n_pass, n & 1);
    }
  }
}

// Persistent as the dQ kernel: a work tile's k and v once the consumers
// have released the last ones, then its query tiles' q, do, lse and delta
// into the ring's stages.
template <int DP, int KD, typename BiasT>
__global__ void __launch_bounds__(kSm90Threads, 1)
attention_bwd_dkv_sm90_kernel(const BwdParams p,
                              const __grid_constant__ BwdMaps m,
                              int n_ktiles, int n_work) {
  using S = BwdDkvSmem<DP>;
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  unsigned char* ks = align_1024(bwd_smem);
  unsigned char* vs = ks + S::kOwnedBytes;
  unsigned char* ring = vs + S::kOwnedBytes;
  auto* full = reinterpret_cast<uint64_t*>(ks + S::kBarOffset);
  uint64_t* empty = full + kBwdSm90Stages;
  uint64_t* ofull = empty + kBwdSm90Stages;
  uint64_t* oempty = ofull + 1;
  bwd_sm90_init(full);
  const int n_q = (p.lq + kBwdSm90Inner - 1) / kBwdSm90Inner;
  const int wg = threadIdx.x / 128;
  if (wg == kSm90Consumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kSm90ProducerRegs));
    if (threadIdx.x != 128 * kSm90Consumers) return;
    int ri = 0;
    for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
      const BwdWork wk = bwd_work(w, n_ktiles, p.H);
      if (n > 0) mbar_wait_or_trap(oempty, (n - 1) & 1);
      mbar_arrive_expect_tx(ofull, 2 * S::kOwnedBytes);
      for (int c = 0; c < S::kBlocks; ++c) {
        const int at = c * kBwdSm90Owned * kSm90RowBytes;
        tma_load_at(ks + at, &m.own[0], ofull, m.own_slot[0], c * kSm90Box,
                    wk.b, wk.h, wk.r0);
        tma_load_at(vs + at, &m.own[1], ofull, m.own_slot[1], c * kSm90Box,
                    wk.b, wk.h, wk.r0);
      }
      const int stat0 = (wk.b * p.H + wk.h) * p.lq;
      for (int it = 0; it < n_q; ++it, ++ri) {
        const int st = ri % kBwdSm90Stages;
        mbar_wait_or_trap(empty + st, ((ri / kBwdSm90Stages) & 1) ^ 1);
        mbar_arrive_expect_tx(full + st,
                              2 * S::kTileBytes + 2 * S::kStatBytes);
        unsigned char* qt = ring + st * S::kStageBytes;
        for (int c = 0; c < S::kBlocks; ++c) {
          const int at = c * kBwdSm90Inner * kSm90RowBytes;
          tma_load_at(qt + at, &m.str[0], full + st, m.str_slot[0],
                      c * kSm90Box, wk.b, wk.h, it * kBwdSm90Inner);
          tma_load_at(qt + S::kTileBytes + at, &m.str[1], full + st,
                      m.str_slot[1], c * kSm90Box, wk.b, wk.h,
                      it * kBwdSm90Inner);
        }
        // from the tile's first value rounded down to 16 bytes
        unsigned char* stat = qt + 2 * S::kTileBytes;
        const int at = (stat0 + it * kBwdSm90Inner) & ~3;
        tma_load_1d(stat, &m.stat[0], full + st, at);
        tma_load_1d(stat + S::kStatStride, &m.stat[1], full + st, at);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kSm90ConsumerRegs));
    for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
      const BwdWork wk = bwd_work(w, n_ktiles, p.H);
      bwd_dkv_consumer<DP, KD, BiasT>(p, ks, vs, ring, full, empty, ofull,
                                      oempty, wg, wk.r0, wk.h, wk.b, n_q,
                                      n * n_q, n & 1);
    }
  }
}

// The copy engine's 1-D map of n fp32 values (lse or delta), boxes of
// kStatBox values (zeros past n)
cudaError_t encode_stat_map(CUtensorMap* map, const float* base, long long n) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * sizeof(float)};  // unread
  const cuuint32_t box[1] = {kStatBox}, unit[1] = {1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// dQ over the query tiles, then dK/dV over the key tiles; returns the
// first error
template <int DP, int KD, typename BiasT, typename DsT>
cudaError_t launch_bwd_sm90(const BwdParams& p, cudaStream_t stream) {
  // dQ: q, do and o owned (rows lq), k and v streamed (zeros past kend)
  BwdMaps mq, mk;
  cudaError_t err = cudaSuccess;
  const int own_q[3] = {bQ, bDO, bO}, kv[2] = {bK, bV};
  for (int i = 0; i < 3 && err == cudaSuccess; ++i)
    err = encode_hmajor_map(&mq.own[i], &mq.own_slot[i], p.in[own_q[i]],
                            p.st[own_q[i]], p.B, p.H, p.lq, p.D,
                            kBwdSm90Owned);
  for (int i = 0; i < 2 && err == cudaSuccess; ++i)
    err = encode_hmajor_map(&mq.str[i], &mq.str_slot[i], p.in[kv[i]],
                            p.st[kv[i]], p.B, p.H, p.kend, p.D,
                            kBwdSm90Inner);
  // dK/dV: k and v owned, q and do streamed with their lse and delta
  const int str_k[2] = {bQ, bDO};
  for (int i = 0; i < 2 && err == cudaSuccess; ++i)
    err = encode_hmajor_map(&mk.own[i], &mk.own_slot[i], p.in[kv[i]],
                            p.st[kv[i]], p.B, p.H, p.kend, p.D,
                            kBwdSm90Owned);
  for (int i = 0; i < 2 && err == cudaSuccess; ++i)
    err = encode_hmajor_map(&mk.str[i], &mk.str_slot[i], p.in[str_k[i]],
                            p.st[str_k[i]], p.B, p.H, p.lq, p.D,
                            kBwdSm90Inner);
  const long long n_stat = (long long)p.B * p.H * p.lq;
  if (err == cudaSuccess) err = encode_stat_map(&mk.stat[0], p.lse, n_stat);
  if (err == cudaSuccess) err = encode_stat_map(&mk.stat[1], p.delta, n_stat);
  if (err != cudaSuccess) return err;

  auto dq_kern = attention_bwd_dq_sm90_kernel<DP, KD, BiasT, DsT>;
  auto dkv_kern = attention_bwd_dkv_sm90_kernel<DP, KD, BiasT>;
  if ((err = allow_smem(dq_kern, BwdDqSmem<DP>::kBytes)) != cudaSuccess ||
      (err = allow_smem(dkv_kern, BwdDkvSmem<DP>::kBytes)) != cudaSuccess)
    return err;
  const int n_qtiles = (p.lq + kBwdSm90Owned - 1) / kBwdSm90Owned;
  const int n_ktiles = (p.lk + kBwdSm90Owned - 1) / kBwdSm90Owned;
  const long long n_work_q = (long long)n_qtiles * p.H * p.B;
  const long long n_work_k = (long long)n_ktiles * p.H * p.B;
  int blocks;
  if ((err = persistent_blocks(n_work_q, &blocks)) != cudaSuccess) return err;
  dq_kern<<<blocks, kSm90Threads, BwdDqSmem<DP>::kBytes, stream>>>(
      p, mq, n_qtiles, (int)n_work_q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = persistent_blocks(n_work_k, &blocks)) != cudaSuccess) return err;
  dkv_kern<<<blocks, kSm90Threads, BwdDkvSmem<DP>::kBytes, stream>>>(
      p, mk, n_ktiles, (int)n_work_k);
  return cudaGetLastError();
}

// D 64 and below on one 64-column box; above, two boxes, the products over
// D stopping at 96 where D allows and there is no bias (EVA's D 88).
// Built with -DVAST_BWD_KD96=0, D 88 runs its products 128 deep as the
// bias case does: the A/B of vast_tpu_torch/scripts/bench_bwd.py.
#ifndef VAST_BWD_KD96
#define VAST_BWD_KD96 1
#endif
template <typename BiasT, typename DsT>
cudaError_t dispatch_bwd_sm90(const BwdParams& p, cudaStream_t s) {
  if (p.D <= 64) return launch_bwd_sm90<64, 4, BiasT, DsT>(p, s);
  if constexpr (!kHasBias<BiasT> && VAST_BWD_KD96) {
    if (p.D <= 96) return launch_bwd_sm90<128, 6, BiasT, DsT>(p, s);
  }
  return launch_bwd_sm90<128, 8, BiasT, DsT>(p, s);
}

// The copy engine reads q, k, v, o and do, the epilogues write bf16 pairs
// and the 1-D maps read lse and delta: bf16, D a multiple of 8 up to 128,
// every stride of q, k, v, o and do a positive multiple of 8 elements and
// their bases 16-byte aligned, dq, dk and dv with even strides and 4-byte
// aligned bases, lse and delta 16-byte aligned, B x H x Lq below 2^31.
bool sm90_bwd_takes(const BwdParams& p, int dtype) {
  if (dtype != kBf16 || p.D < 8 || p.D > kMaxD || p.D % 8) return false;
  for (int o = bQ; o <= bDO; ++o) {
    if (reinterpret_cast<uintptr_t>(p.in[o]) % 16) return false;
    for (int j = 0; j < 3; ++j)
      if (p.st[o][j] <= 0 || p.st[o][j] % 8) return false;
  }
  for (int o = bDQ; o <= bDV; ++o) {
    if (reinterpret_cast<uintptr_t>(p.grad[o - bDQ]) % 4) return false;
    for (int j = 0; j < 3; ++j)
      if (p.st[o][j] % 2) return false;
  }
  return reinterpret_cast<uintptr_t>(p.lse) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p.delta) % 16 == 0 &&
         (long long)p.B * p.H * p.lq < INT_MAX;
}

// run_bwd's checks and (bias type, ds type) pairs, on the Hopper body
#if VAST_PART_ON(4)
cudaError_t run_bwd_sm90(const BwdParams& p, int dtype, int bias_dtype,
                         cudaStream_t s) {
  if (!sm90_bwd_takes(p, dtype) || p.lq < 1 || p.lk < 1 || p.kend < 1 ||
      p.kend > p.lk || p.B < 1 || p.H < 1 || p.B > 65535 || p.H > 65535 ||
      (p.dbias && !p.bias))
    return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const bool ds = p.dbias != nullptr;
  if (!p.bias) return dispatch_bwd_sm90<NoBias, NoBias>(p, s);
  if (bias_dtype == kBf16 && ds) return dispatch_bwd_sm90<bf16, bf16>(p, s);
  if (bias_dtype == kF32)
    return ds ? dispatch_bwd_sm90<float, float>(p, s)
              : dispatch_bwd_sm90<float, NoBias>(p, s);
  return cudaErrorInvalidValue;
}
#endif

// The BwdParams of the token-major entries (their arguments, described at
// vast_tmajor_attention_bwd): q, k and v of the fused qkv, dq, dk and dv of
// dqkv at the same offsets and strides
BwdParams tmajor_bwd_params(const void* qkv, const void* o, const void* dout,
                            const void* bias, void* dqkv, void* dbias,
                            float* lse, float* delta, int lse_given,
                            int dtype, int B, int L, int H, int D, int kend,
                            long long bias_batch_stride, float scale) {
  const long long es = dtype == kF32 ? 4 : 2, row3 = 3LL * H * D,
                  row1 = (long long)H * D;
  BwdParams p = {};
  for (int j = 0; j < 3; ++j) {
    p.in[bQ + j] = static_cast<const char*>(qkv) + j * D * es;
    p.grad[j] = static_cast<char*>(dqkv) + j * D * es;
    for (int op : {bQ + j, bDQ + j}) {
      p.st[op][0] = L * row3;
      p.st[op][1] = 3LL * D;
      p.st[op][2] = row3;
    }
  }
  p.in[bO] = o;
  p.in[bDO] = dout;
  for (int op : {bO, bDO}) {
    p.st[op][0] = L * row1;
    p.st[op][1] = D;
    p.st[op][2] = row1;
  }
  p.st[bBias][0] = bias_batch_stride;
  p.st[bDBias][0] = (long long)H * L * L;
  for (int op : {bBias, bDBias}) {
    p.st[op][1] = (long long)L * L;
    p.st[op][2] = L;
  }
  p.bias = bias;
  p.dbias = dbias;
  p.lse = lse;
  p.delta = delta;
  p.B = B;
  p.H = H;
  p.lq = p.lk = L;
  p.D = D;
  p.kend = kend;
  p.scale = scale;
  p.lse_given = lse_given != 0;
  return p;
}

// The BwdParams of the head-major entries (their arguments, described at
// vast_flash_attention_bwd)
BwdParams hmajor_bwd_params(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* bias,
                            void* dq, void* dk, void* dv, void* dbias,
                            const float* lse, float* delta, int B, int H,
                            int Lq, int Lk, int D, int kend,
                            const long long* strides, float scale) {
  BwdParams p = {};
  const void* in[5] = {q, k, v, o, dout};
  void* grad[3] = {dq, dk, dv};
  memcpy(p.in, in, sizeof(p.in));
  memcpy(p.grad, grad, sizeof(p.grad));
  memcpy(p.st, strides, sizeof(p.st));
  p.bias = bias;
  p.dbias = dbias;
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.B = B;
  p.H = H;
  p.lq = Lq;
  p.lk = Lk;
  p.D = D;
  p.kend = kend;
  p.scale = scale;
  p.lse_given = true;
  return p;
}

// ---------------------------------------------------------------------
// The layout probe's attention_dma for Hopper: a resident strip
// ---------------------------------------------------------------------
//
// Replaces scripts/bench_tmajor_variants.py attention_dma (:78, inline
// body :87, pallas_call :102) for bf16 qkv that the copy engine can read
// and a kend whose keys fit in shared memory (strip_takes), through
// vast_tmajor_dma_attention_fwd_sm90. There each (group of 4 batch rows,
// head) grid step copies one head's whole [q|k|v] strip into VMEM and
// computes that head's softmax(q . k^T masked to lk_true) . v, unscaled,
// from there. Here a work unit is one (batch row, head), since four do not
// fit in 227 KB: the head's K and V stay resident in shared memory while
// every query tile of the head runs over them. fp32, longer keys and the
// views the copy engine cannot read keep attention_fwd_tma_kernel through
// vast_tmajor_dma_attention_fwd, so the probe's dma row means "the strips
// come by the copy engine" on every route.
//
// What bounds it on an H100: bytes, as the forward ("The forward for
// Hopper" above): q, the first kend keys of k and v read once, the output
// written once; the time is set by each warpgroup's serial chain of
// products and softmax steps.
// What the design does about it:
// * As the shared body: a persistent block an SM takes work units in
//   turn; one producer thread issues every copy, two consumer warpgroups
//   run wgmma (q . k^T over KD k-steps, 96 deep at D 88; p . v from
//   registers), setmaxnreg gives them the producer's registers (24 and
//   240); the online softmax runs over key tiles of 128, a narrow last key
//   tile first.
// * K and V come once per work unit in key tiles, each on a full barrier
//   of its own, as boxes of 16 key rows by 64 columns in 128-byte swizzle
//   (rows past kend and columns past D read as zeros), into regions of
//   DP / 64 column blocks of `rows` x 128 bytes each. rows is 128 a key
//   tile but the last, which takes 16, 64 or 128 rows as its keys need
//   (wgmma N 16, 64 or 128): 257 keys take 272 rows, not 384. That room
//   caps kend at 320 keys at DP 128 and 768 at DP 64 (kMaxRows).
// * q streams: each warpgroup has two buffers of a 64-row query tile, each
//   with a full and an empty barrier; warpgroup 0 takes the head's query
//   tiles 0, 2, 4, ..., warpgroup 1 tiles 1, 3, ....
// * The lone last query tile: where a head has an odd number of query
//   tiles, the last of at most 16 rows (L 257: one row), and more than one
//   key tile, the two warpgroups split that tile's key tiles (warpgroup 0
//   the first half in the order taken, warpgroup 1 the rest), so that
//   neither runs a whole extra tile's chain (at L 257, 8 and 7 key-tile
//   steps a head where the shared body's ring runs 9 and 9). Warpgroup 1
//   writes its partial (m, l, o) into its q buffer of that tile and
//   arrives on a named barrier; warpgroup 0 merges it into its own, stores
//   the rows and frees that buffer. The host decides the split from L and
//   kend (strip_split): an instantiation of its own, so that a launch
//   carries no test it never takes.
// * Overlap: a key tile is refilled for the next work unit as soon as both
//   warpgroups have passed it in their last query tile of the head (an
//   empty barrier a key tile); a q buffer as soon as its warpgroup has run
//   that tile's last q . k^T. So the next head's first q tiles and its K
//   and V come in while this head's last tiles run.

constexpr int kStripQ = 64;          // rows of a query tile (a warpgroup's)
constexpr int kStripSlots = 2;       // q buffers of a warpgroup
constexpr int kStripBoxK = 16;       // key rows of a k or v box
constexpr int kStripMaxTiles = 6;    // resident key tiles, at most
constexpr int kStripSplitRows = 16;  // rows of a last query tile split

// the rows a resident key tile of `keys` keys takes: wgmma's N
__host__ __device__ constexpr int strip_width(int keys) {
  return keys <= 16 ? 16 : keys <= 64 ? 64 : kSm90BlockK;
}

// the rows of the resident K (or V) of kend keys: 128 a key tile but the
// last, whose strip_width
__host__ __device__ __forceinline__ int strip_rows(int kend) {
  const int n = (kend + kSm90BlockK - 1) / kSm90BlockK;
  return (n - 1) * kSm90BlockK + strip_width(kend - (n - 1) * kSm90BlockK);
}

// A block's shared memory, each tile 1024-byte aligned: the q buffers
// (warpgroup w's buffer s at (w kStripSlots + s) kQTileBytes), K and V of
// `rows` rows each, then the barriers: each key tile's full and empty,
// then each q buffer's full and empty. A split tile's partials (m and l of
// its 16 rows, then o as [16][DP], fp32) take a q buffer's place.
template <int DP>
struct StripSmem {
  static constexpr int kBlocks = DP / kSm90Box;
  static constexpr int kMaxRows = DP == kSm90Box ? 768 : 320;
  static constexpr unsigned kQTileBytes = kStripQ * DP * 2;
  static constexpr unsigned kQBytes =
      kSm90Consumers * kStripSlots * kQTileBytes;
  static constexpr int kBars =
      2 * kStripMaxTiles + 2 * kSm90Consumers * kStripSlots;
  __host__ __device__ static constexpr size_t kv_bytes(int rows) {
    return (size_t)rows * DP * 2;
  }
  __host__ __device__ static constexpr size_t bar_offset(int rows) {
    return kQBytes + 2 * kv_bytes(rows);
  }
  __host__ __device__ static constexpr size_t bytes(int rows) {
    return bar_offset(rows) + kBars * 8 + 1024;
  }
};
static_assert(StripSmem<64>::bytes(StripSmem<64>::kMaxRows) <= 232448 &&
                  StripSmem<128>::bytes(StripSmem<128>::kMaxRows) <= 232448,
              "a block's shared memory on sm_90");
static_assert(768 <= kStripMaxTiles * kSm90BlockK, "a barrier a key tile");
static_assert(kStripSplitRows * (128 + 2) * 4 <= StripSmem<128>::kQTileBytes &&
                  kStripSplitRows * (64 + 2) * 4 <= StripSmem<64>::kQTileBytes,
              "a split tile's partials in a q buffer");

// Whether the lone last query tile's key tiles are split between the two
// warpgroups: an odd number of query tiles, the last of at most
// kStripSplitRows rows, and more than one key tile
bool strip_split(int lq, int kend) {
  const int n_q = (lq + kStripQ - 1) / kStripQ;
  return n_q % 2 == 1 && lq - (n_q - 1) * kStripQ <= kStripSplitRows &&
         kend > kSm90BlockK;
}

// the query tiles warpgroup wg takes of a head of n_q: its own, wg, wg +
// 2, ... below n_q (below n_q - 1 with the split), then the split tile,
// which both take
template <bool kSplit>
__device__ __forceinline__ int strip_q_count(int wg, int n_q) {
  return ((kSplit ? n_q - 1 : n_q) - wg + 1) / 2 + kSplit;
}

// the query tile at index i of warpgroup wg's
template <bool kSplit>
__device__ __forceinline__ int strip_q_tile(int wg, int i, int n_q) {
  return kSplit && i == strip_q_count<kSplit>(wg, n_q) - 1 ? n_q - 1
                                                           : wg + 2 * i;
}

// the threads of both consumer warpgroups at named barrier `id`:
// warpgroup 1 arrives (its partials written), warpgroup 0 waits for them
__device__ __forceinline__ void strip_bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n"
               :: "r"(id), "n"(128 * kSm90Consumers) : "memory");
}

__device__ __forceinline__ void strip_bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n"
               :: "r"(id), "n"(128 * kSm90Consumers) : "memory");
}

// generic accesses to shared memory before the copy engine's later writes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One consumer warpgroup's query tile (q in its buffer qw) over the key
// tiles taken at positions [pa, pb) of n_kt (sm90_key_tile's order, the
// narrow last tile first), each waited for on its full barrier in phase
// `parity`: o, m (log2 units) and this lane's part of l, as sm90_consumer
// keeps them. q's buffer is released (qempty, unless null) after the last
// q . k^T; each key tile (release) after its p . v. Accumulator layouts as
// in sm90_consumer.
template <int DP, int KD>
__device__ __forceinline__ void strip_tile(
    const unsigned char* qw, const unsigned char* ks, const unsigned char* vs,
    int rows, uint64_t* full, uint64_t* empty, uint64_t* qempty, int pa,
    int pb, int n_kt, bool narrow, int kend, float f, unsigned parity,
    bool release, float (&o)[DP / kSm90Box][32], float (&m)[2],
    float (&l)[2]) {
  constexpr int kBlocks = DP / kSm90Box;
  static_assert(KD * 16 <= DP, "q . k^T over at most DP columns");
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int c = 0; c < kBlocks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  // key tile kt, the last of the tile's when last_q, as wgmma N 8 NJ
  auto step = [&](auto nj_c, int kt, bool last_q) {
    constexpr int NJ = decltype(nj_c)::value;
    const int k0 = kt * kSm90BlockK;
    float s[4 * NJ];
#pragma unroll
    for (int i = 0; i < 4 * NJ; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      const uint64_t da =
          wgmma_desc(qw + c * kStripQ * kSm90RowBytes + off, 16, 1024);
      const uint64_t db =
          wgmma_desc(ks + (c * rows + k0) * kSm90RowBytes + off, 16, 1024);
      if constexpr (NJ == 16)
        wgmma_m64n128k16_ss(s, da, db, kk > 0);
      else if constexpr (NJ == 8)
        wgmma_m64n64k16_ss(s, da, db, kk > 0);
      else
        wgmma_m64n16k16_ss(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (last_q && qempty) mbar_arrive(qempty);   // the next q may come
    float alpha[2];
    sm90_softmax<NJ>(s, m, l, alpha, kend, k0, t, f);
#pragma unroll
    for (int c = 0; c < kBlocks; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[c][4 * j] *= alpha[0];
        o[c][4 * j + 1] *= alpha[0];
        o[c][4 * j + 2] *= alpha[1];
        o[c][4 * j + 3] *= alpha[1];
      }
    uint32_t pk[NJ / 2][4];
    pack_p<NJ>(s, pk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk)
#pragma unroll
      for (int c = 0; c < kBlocks; ++c)
        wgmma_m64n64k16_rs(
            o[c], pk[kk],
            wgmma_desc(vs + (c * rows + k0 + 16 * kk) * kSm90RowBytes,
                       rows * kSm90RowBytes, 1024),
            1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kBlocks; ++c) fence_regs(o[c]);
    if (release) mbar_arrive(empty + kt);     // refill for the next head
  };
  for (int i = pa; i < pb; ++i) {
    const int kt = sm90_key_tile(i, n_kt, narrow);
    const int width = min(kSm90BlockK, rows - kt * kSm90BlockK);
    mbar_wait_or_trap(full + kt, parity);
    __syncwarp();                   // the warp converged for wgmma
    if (width == kSm90BlockK)
      step(std::integral_constant<int, 16>{}, kt, i == pb - 1);
    else if (width == 64)
      step(std::integral_constant<int, 8>{}, kt, i == pb - 1);
    else
      step(std::integral_constant<int, 2>{}, kt, i == pb - 1);
  }
}

// Persistent: a block per SM takes work units w = blockIdx.x, + gridDim.x,
// ... (head fastest, then batch row). Warpgroups 0 and 1 consume; the last
// one produces, one thread issuing every copy: for each work unit the two
// warpgroups' first q tiles, then the head's K and V key tiles in the
// order the consumers take them, each once both warpgroups have released
// it for the last head, then the other q tiles, each into its
// warpgroup's next buffer once released.
template <int DP, int KD, bool kSplit>
__global__ void __launch_bounds__(kSm90Threads, 1)
attention_fwd_strip_sm90_kernel(const Params p,
                                const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap,
                                const Sm90Slot sq, const Sm90Slot sk,
                                const Sm90Slot sv, int n_work) {
  using S = StripSmem<DP>;
  extern __shared__ __align__(1024) unsigned char strip_smem[];
  unsigned char* qs = align_1024(strip_smem);
  const int rows = strip_rows(p.kend);
  unsigned char* ks = qs + S::kQBytes;
  unsigned char* vs = ks + S::kv_bytes(rows);
  auto* full = reinterpret_cast<uint64_t*>(qs + S::bar_offset(rows));
  uint64_t* empty = full + kStripMaxTiles;
  uint64_t* qfull = empty + kStripMaxTiles;   // warpgroup w's buffer s at
  uint64_t* qempty = qfull + kSm90Consumers * kStripSlots;  // w slots + s
  const int n_kt = (p.kend + kSm90BlockK - 1) / kSm90BlockK;
  const int n_q = (p.lq + kStripQ - 1) / kStripQ;
  const bool narrow = rows - (n_kt - 1) * kSm90BlockK < kSm90BlockK;
  if (threadIdx.x == 0) {
    for (int i = 0; i < n_kt; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 128 * kSm90Consumers);
    }
    for (int i = 0; i < kSm90Consumers * kStripSlots; ++i) {
      mbar_init(qfull + i, 1);
      mbar_init(qempty + i, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const int cnt0 = strip_q_count<kSplit>(0, n_q),
            cnt1 = strip_q_count<kSplit>(1, n_q);
  if (wg == kSm90Consumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kSm90ProducerRegs));
    if (threadIdx.x != 128 * kSm90Consumers) return;
    for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
      const int h = w % p.heads, b = w / p.heads;
      // q tile i of warpgroup g into its next buffer
      auto load_q = [&](int g, int i) {
        const int seq = n * (g ? cnt1 : cnt0) + i;
        const int at = g * kStripSlots + seq % kStripSlots;
        mbar_wait_or_trap(qempty + at, ((seq / kStripSlots) & 1) ^ 1);
        mbar_arrive_expect_tx(qfull + at, S::kQTileBytes);
        unsigned char* dst = qs + at * S::kQTileBytes;
        const int q0 = kStripQ * strip_q_tile<kSplit>(g, i, n_q);
        for (int c = 0; c < S::kBlocks; ++c)
          tma_load_at(dst + c * kStripQ * kSm90RowBytes, &qmap, qfull + at,
                      sq, c * kSm90Box, b, h, q0);
      };
      for (int i = 0; i < cnt0; ++i) {        // cnt0 >= cnt1
        load_q(0, i);
        if (i < cnt1) load_q(1, i);
        if (i > 0) continue;
        for (int pos = 0; pos < n_kt; ++pos) {
          const int kt = sm90_key_tile(pos, n_kt, narrow);
          const int k0 = kt * kSm90BlockK;
          const int width = min(kSm90BlockK, rows - k0);
          mbar_wait_or_trap(empty + kt, (n & 1) ^ 1);
          mbar_arrive_expect_tx(full + kt, 2u * width * DP * 2);
          for (int c = 0; c < S::kBlocks; ++c)
            for (int r = 0; r < width; r += kStripBoxK) {
              const int at = (c * rows + k0 + r) * kSm90RowBytes;
              tma_load_at(ks + at, &kmap, full + kt, sk, c * kSm90Box, b, h,
                          k0 + r);
              tma_load_at(vs + at, &vmap, full + kt, sv, c * kSm90Box, b, h,
                          k0 + r);
            }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kSm90ConsumerRegs));
  constexpr int kBlocks = S::kBlocks;
  const int cnt = wg ? cnt1 : cnt0;
  const int half = (n_kt + 1) / 2;   // the split tile's key tiles of wg 0
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float f = p.scale * kLog2e;  // the scale folded into the exponent
  for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
    const int h = w % p.heads, b = w / p.heads;
    const unsigned parity = n & 1;
    // a key tile this warpgroup no longer reads in this head, released
    // after its arrival in this head (so that the release counts for it)
    auto release = [&](int kt) {
      mbar_wait_or_trap(full + kt, parity);
      mbar_arrive(empty + kt);
    };
    if (cnt == 0)                    // warpgroup 1 of a one-tile head
      for (int kt = 0; kt < n_kt; ++kt) release(kt);
    for (int i = 0; i < cnt; ++i) {
      const int seq = n * cnt + i;
      const int at = wg * kStripSlots + seq % kStripSlots;
      const bool last = i == cnt - 1, split = kSplit && last;
      const int pa = split && wg == 1 ? half : 0;
      const int pb = split && wg == 0 ? half : n_kt;
      if (split)                     // the key tiles the other one takes
        for (int pos = 0; pos < n_kt; ++pos)
          if (pos < pa || pos >= pb) release(sm90_key_tile(pos, n_kt, narrow));
      mbar_wait_or_trap(qfull + at, (seq / kStripSlots) & 1);
      float o[kBlocks][32], m[2], l[2];
      strip_tile<DP, KD>(qs + at * S::kQTileBytes, ks, vs, rows, full, empty,
                         split && wg == 1 ? nullptr : qempty + at, pa, pb,
                         n_kt, narrow, p.kend, f, parity, last, o, m, l);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(kFull, l[r], 1);
        l[r] += __shfl_xor_sync(kFull, l[r], 2);
      }
      if (split) {
        // warpgroup 1's buffer of this tile holds its partials; its rows
        // (at most 16) lie in warp 0 of each warpgroup
        const int seq1 = n * cnt1 + cnt1 - 1;
        const int at1 = kStripSlots + seq1 % kStripSlots;
        float* part = reinterpret_cast<float*>(qs + at1 * S::kQTileBytes);
        float* po = part + 2 * kStripSplitRows;
        if (wg == 1) {
          if (warp == 0) {
            if (t == 0) {
              part[g] = m[0];
              part[g + 8] = m[1];
              part[kStripSplitRows + g] = l[0];
              part[kStripSplitRows + g + 8] = l[1];
            }
#pragma unroll
            for (int c = 0; c < kBlocks; ++c)
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int d = c * kSm90Box + 8 * j + 2 * t;
                *reinterpret_cast<float2*>(po + g * DP + d) =
                    make_float2(o[c][4 * j], o[c][4 * j + 1]);
                *reinterpret_cast<float2*>(po + (g + 8) * DP + d) =
                    make_float2(o[c][4 * j + 2], o[c][4 * j + 3]);
              }
          }
          fence_proxy_async();
          strip_bar_arrive(1 + seq1 % kStripSlots);
          continue;                  // warpgroup 0 stores the rows
        }
        strip_bar_sync(1 + seq1 % kStripSlots);
        if (warp == 0) {
          float a0[2], a1[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float m1 = part[g + 8 * r],
                        l1 = part[kStripSplitRows + g + 8 * r];
            const float mn = fmaxf(m[r], m1), ne = -exp_ref(mn);
            a0[r] = ex2(m[r] + ne);
            a1[r] = ex2(m1 + ne);
            l[r] = l[r] * a0[r] + l1 * a1[r];
          }
#pragma unroll
          for (int c = 0; c < kBlocks; ++c)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int d = c * kSm90Box + 8 * j + 2 * t;
              const float2 x0 = *reinterpret_cast<const float2*>(po + g * DP + d);
              const float2 x1 =
                  *reinterpret_cast<const float2*>(po + (g + 8) * DP + d);
              o[c][4 * j] = o[c][4 * j] * a0[0] + x0.x * a1[0];
              o[c][4 * j + 1] = o[c][4 * j + 1] * a0[0] + x0.y * a1[0];
              o[c][4 * j + 2] = o[c][4 * j + 2] * a0[1] + x1.x * a1[1];
              o[c][4 * j + 3] = o[c][4 * j + 3] * a0[1] + x1.y * a1[1];
            }
        }
        fence_proxy_async();
        mbar_arrive(qempty + at1);   // warpgroup 1's buffer may be refilled
      }
      // a row with no finite score has l == 0 and gives zeros
      const float inv0 = l[0] > 0.f ? 1.f / l[0] : 0.f;
      const float inv1 = l[1] > 0.f ? 1.f / l[1] : 0.f;
      const int row0 = kStripQ * strip_q_tile<kSplit>(wg, i, n_q) +
                       16 * warp + g, row1 = row0 + 8;
      auto* og = plane<__nv_bfloat16>(p.out, p.st[kO][0], p.st[kO][1], b, h);
      const long long o_rs = p.st[kO][2];
#pragma unroll
      for (int c = 0; c < kBlocks; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = c * kSm90Box + 8 * j + 2 * t;   // D even: d + 1 < D
          if (d >= p.d) continue;
          if (row0 < p.lq)
            *reinterpret_cast<__nv_bfloat162*>(og + row0 * o_rs + d) =
                __floats2bfloat162_rn(o[c][4 * j] * inv0,
                                      o[c][4 * j + 1] * inv0);
          if (row1 < p.lq)
            *reinterpret_cast<__nv_bfloat162*>(og + row1 * o_rs + d) =
                __floats2bfloat162_rn(o[c][4 * j + 2] * inv1,
                                      o[c][4 * j + 3] * inv1);
        }
    }
  }
}

template <int DP, int KD, bool kSplit>
cudaError_t launch_strip(const Params& p, int B, int H, cudaStream_t stream) {
  CUtensorMap maps[3];
  Sm90Slot slots[3];
  const int rows[3] = {p.lq, p.kend, p.kend};
  const int box_rows[3] = {kStripQ, kStripBoxK, kStripBoxK};
  for (int o = kQ; o <= kV; ++o) {
    const cudaError_t err = encode_hmajor_map(
        &maps[o], &slots[o], p.in[o], p.st[o], B, H, rows[o], p.d,
        box_rows[o]);
    if (err != cudaSuccess) return err;
  }
  auto kern = attention_fwd_strip_sm90_kernel<DP, KD, kSplit>;
  const size_t smem = StripSmem<DP>::bytes(strip_rows(p.kend));
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  // a persistent block an SM (the registers of all 384 threads fill it)
  int blocks;
  if ((err = persistent_blocks((long long)B * H, &blocks)) != cudaSuccess)
    return err;
  kern<<<blocks, kSm90Threads, smem, stream>>>(
      p, maps[kQ], maps[kK], maps[kV], slots[kQ], slots[kK], slots[kV], B * H);
  return cudaGetLastError();
}

// D 64 and below on one 64-column box; above, two boxes, q . k^T stopping
// at 96 where D allows (dispatch_sm90's widths)
template <bool kSplit>
cudaError_t dispatch_strip(const Params& p, int B, int H, cudaStream_t s) {
  if (p.d <= 64) return launch_strip<64, 4, kSplit>(p, B, H, s);
  if (p.d <= 96) return launch_strip<128, 6, kSplit>(p, B, H, s);
  return launch_strip<128, 8, kSplit>(p, B, H, s);
}

// The resident strip's rule (mirrored by the probe's _strip_ok): the
// Hopper body's (sm90_takes) and a kend whose resident rows fit: 320 keys
// at D above 64, 768 at and below
bool strip_takes(const Params& p, int dtype, int B, int H) {
  return sm90_takes(p, dtype, B, H) && p.kend <= p.lq &&
         strip_rows(p.kend) <= (p.d <= kSm90Box ? StripSmem<64>::kMaxRows
                                                : StripSmem<128>::kMaxRows);
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype codes: 0 = float32,
// 1 = bfloat16. A null bias means no bias. Each returns the cudaError_t of
// its launch.

// Token-major fused self-attention (self_attention_tmajor): qkv (B, L,
// H*3*D), each head's [q|k|v] contiguous; out (B, L, H*D); bias (B or 1,
// H, L, L) in qkv's type, batch stride 0 when shared. ``lse`` (null: not
// written) receives each row's logsumexp, (B, H, L) fp32 contiguous, as
// the head-major entries write it (the backward reads it).
#if VAST_PART_ON(0)
extern "C" int vast_tmajor_attention_fwd(const void* qkv, const void* bias,
                                         void* out, float* lse, int dtype,
                                         int B, int L, int H, int D, int kend,
                                         long long bias_batch_stride,
                                         float scale, void* stream) {
  if (kend > L || (dtype != kF32 && dtype != kBf16))
    return (int)cudaErrorInvalidValue;
  return (int)run(tmajor_fwd_params(qkv, bias, out, lse, dtype, L, H, D, kend,
                                    bias_batch_stride, scale),
                  dtype, dtype, B, H, static_cast<cudaStream_t>(stream));
}
#endif

// The same function, the same arguments, on the Hopper body (wgmma and the
// copy engine; see "The forward for Hopper" above). Returns
// cudaErrorInvalidValue, and launches nothing, for operands that body does
// not take (run_tmajor_sm90): any dtype but bf16, D not a multiple of 8 or
// above 128, qkv not 16-byte aligned, a bias whose L or batch stride is not
// a multiple of 8 elements or whose base is not 16-byte aligned;
// cudaErrorNotSupported where CUDA offers no tensor maps.
#if VAST_PART_ON(1)
extern "C" int vast_tmajor_attention_fwd_sm90(
    const void* qkv, const void* bias, void* out, float* lse, int dtype,
    int B, int L, int H, int D, int kend, long long bias_batch_stride,
    float scale, void* stream) {
  if (kend > L) return (int)cudaErrorInvalidValue;
  return (int)run_tmajor_sm90(
      tmajor_fwd_params(qkv, bias, out, lse, dtype, L, H, D, kend,
                        bias_batch_stride, scale),
      dtype, B, H, static_cast<cudaStream_t>(stream));
}
#endif

// The token-major layout probe (scripts/bench_tmajor_variants.py), its two
// Pallas kernels. Both: qkv (B, L, 3*H*D), out (B, L, H*D) in qkv's type,
// scale 1, keys >= kend masked (kend = L: none), every query row computed.

// Row 10, attention_dma (:78): the fused per-head [q|k|v] layout, each
// head's strips brought into shared memory by the copy engine (see "The
// copy engine" above) for the mma.sync / CUDA-core body: fp32, and bf16
// that the resident strip (vast_tmajor_dma_attention_fwd_sm90, below) does
// not take. Returns cudaErrorInvalidValue, and launches
// nothing, where the copy engine cannot read the strips: D * esize or the
// row stride not a multiple of 16 bytes, qkv not 16-byte aligned, or D >
// 128; cudaErrorNotSupported where the driver has no tensor maps.
#if VAST_PART_ON(2)
extern "C" int vast_tmajor_dma_attention_fwd(const void* qkv, void* out,
                                             int dtype, int B, int L, int H,
                                             int D, int kend, void* stream) {
  if (dtype != kF32 && dtype != kBf16) return (int)cudaErrorInvalidValue;
  const long long es = dtype == kF32 ? 4 : 2;
  if (D < 1 || D > kMaxD || (D * es) % 16 || (3LL * H * D * es) % 16 ||
      reinterpret_cast<uintptr_t>(qkv) % 16 || L < 1 || kend < 1 ||
      kend > L || B < 1 || H < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p =
      tmajor_params(qkv, out, dtype, L, H, D, kend, 1.f, 3LL * D, D);
  const auto s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == kF32 ? launch_tma_fp32(p, qkv, B, H, s)
                             : dispatch_tma(p, qkv, B, H, s));
}
#endif

// Row 10 on Hopper: the same function, the same arguments, on the resident
// strip (attention_fwd_strip_sm90_kernel: wgmma, the copy engine, each
// head's K and V resident in shared memory; see "The layout probe's
// attention_dma for Hopper" above). Returns cudaErrorInvalidValue, and
// launches nothing, for what that body does not take (strip_takes): any
// dtype but bf16, D not a multiple of 8 or above 128, qkv not 16-byte
// aligned, kend above L or above the resident room (320 keys at D above
// 64, 768 at and below); cudaErrorNotSupported where CUDA offers no
// tensor maps.
#if VAST_PART_ON(2)
extern "C" int vast_tmajor_dma_attention_fwd_sm90(const void* qkv, void* out,
                                                  int dtype, int B, int L,
                                                  int H, int D, int kend,
                                                  void* stream) {
  const Params p =
      tmajor_params(qkv, out, dtype, L, H, D, kend, 1.f, 3LL * D, D);
  if (!strip_takes(p, dtype, B, H)) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return (int)(strip_split(L, kend) ? dispatch_strip<true>(p, B, H, s)
                                    : dispatch_strip<false>(p, B, H, s));
}
#endif

// Row 11, _sect_kernel (:118): the section-major layout [Q_all | K_all |
// V_all], head i's q at i*D, k at H*D + i*D, v at 2*H*D + i*D, read by the
// strided mma.sync / CUDA-core forward (rows 1, 2, 5 and 6's body for
// operands the copy engine cannot read) at those offsets: fp32, and bf16
// that vast_tmajor_sect_attention_fwd_sm90 (below) does not take. Its own
// entry, so that its launches count apart.
#if VAST_PART_ON(0)
extern "C" int vast_tmajor_sect_attention_fwd(const void* qkv, void* out,
                                              int dtype, int B, int L, int H,
                                              int D, int kend, void* stream) {
  if (kend > L || (dtype != kF32 && dtype != kBf16))
    return (int)cudaErrorInvalidValue;
  const Params p = tmajor_params(qkv, out, dtype, L, H, D, kend, 1.f, D,
                                 (long long)H * D);
  return (int)run(p, dtype, dtype, B, H, static_cast<cudaStream_t>(stream));
}
#endif

// Row 11 on Hopper: the same function, the same arguments, on the shared
// Hopper forward body (attention_fwd_sm90_kernel, the instantiation cur's
// EVA launches take: q . k^T 96 deep at D 88) through tensor maps of the
// section-major views: head stride D, so a map's column dimension ends at
// D and the columns of a box past it read as zeros, not the next head's.
// Returns cudaErrorInvalidValue, and launches nothing, for what that body
// does not take (run_sm90): any dtype but bf16, D not a multiple of 8 or
// above 128, qkv not 16-byte aligned, kend above L; cudaErrorNotSupported
// where CUDA offers no tensor maps.
#if VAST_PART_ON(1)
extern "C" int vast_tmajor_sect_attention_fwd_sm90(const void* qkv,
                                                   void* out, int dtype,
                                                   int B, int L, int H, int D,
                                                   int kend, void* stream) {
  if (kend > L) return (int)cudaErrorInvalidValue;
  return (int)run_sm90(tmajor_params(qkv, out, dtype, L, H, D, kend, 1.f, D,
                                     (long long)H * D),
                       dtype, dtype, B, H, static_cast<cudaStream_t>(stream));
}
#endif

// Head-major attention (flash_attention): q (B, H, Lq, D), k and v (B, H,
// Lk, D), out (B, H, Lq, D) and bias (B, H, Lq, Lk), each through
// ``strides``: 15 element strides, (batch, head, row) of q, k, v, out and
// bias in that order (the last axis of each is contiguous; 0 broadcasts).
// Keys >= kend are masked. ``lse`` (null: not written) receives the
// logsumexp of each row's scores, (B, H, Lq) fp32 contiguous, +inf for a
// row with no finite score.
#if VAST_PART_ON(0)
extern "C" int vast_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, const void* bias,
                                        void* out, float* lse, int dtype,
                                        int bias_dtype, int B, int H, int Lq,
                                        int D, int kend,
                                        const long long* strides, float scale,
                                        void* stream) {
  return (int)run(hmajor_params(q, k, v, bias, out, lse, H, Lq, D, kend,
                                strides, scale),
                  dtype, bias_dtype, B, H, static_cast<cudaStream_t>(stream));
}
#endif

// The same function, the same arguments, on the Hopper body (wgmma and the
// copy engine; see "The forward for Hopper" above). Returns
// cudaErrorInvalidValue, and launches nothing, for operands that body does
// not take: any dtype but bf16, D not a multiple of 8 or above 128, a
// stride of q, k or v that is 0 or not a multiple of 8 elements, a base of
// q, k or v not 16-byte aligned, an odd stride of out or an out not
// 4-byte aligned; cudaErrorNotSupported where the driver has no tensor
// maps.
#if VAST_PART_ON(1)
extern "C" int vast_flash_attention_fwd_sm90(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    float* lse, int dtype, int bias_dtype, int B, int H, int Lq, int D,
    int kend, const long long* strides, float scale, void* stream) {
  return (int)run_sm90(hmajor_params(q, k, v, bias, out, lse, H, Lq, D, kend,
                                     strides, scale),
                       dtype, bias_dtype, B, H,
                       static_cast<cudaStream_t>(stream));
}
#endif

// Backward of the token-major attention (self_attention_tmajor_bwd): from
// qkv, o (the forward's output) and dout (its cotangent), all (B, L, ...)
// as above, writes dqkv in qkv's fused per-head [dq | dk | dv] layout and
// type and, with a bias, dbias = ds, (B, H, L, L) in the bias's type
// (qkv's). lse is (B, H, L) fp32: the forward's, read, where lse_given
// is non-zero; else scratch, written by the dQ kernel after a sweep of the
// keys for each row's max and sum. delta is (B, H, L) fp32 scratch. Keys
// >= kend are masked and get dk = dv = 0; dbias is not written past the
// last key tile that holds a key < kend (tiles of 32 keys here, of 64 on
// the Hopper body), so the caller zero-fills it when kend < L. Two
// launches (dQ, then dK/dV); returns the first error.
#if VAST_PART_ON(3)
extern "C" int vast_tmajor_attention_bwd(const void* qkv, const void* o,
                                         const void* dout, const void* bias,
                                         void* dqkv, void* dbias, float* lse,
                                         float* delta, int lse_given,
                                         int dtype, int B, int L, int H,
                                         int D, int kend,
                                         long long bias_batch_stride,
                                         float scale, void* stream) {
  if ((bias == nullptr) != (dbias == nullptr) ||
      (dtype != kF32 && dtype != kBf16))
    return (int)cudaErrorInvalidValue;
  return (int)run_bwd(
      tmajor_bwd_params(qkv, o, dout, bias, dqkv, dbias, lse, delta,
                        lse_given, dtype, B, L, H, D, kend, bias_batch_stride,
                        scale),
      dtype, dtype, static_cast<cudaStream_t>(stream));
}
#endif

// The same function, the same arguments, on the Hopper body (wgmma and the
// copy engine; see "The backward for Hopper" above). Returns
// cudaErrorInvalidValue, and launches nothing, for operands that body does
// not take (sm90_bwd_takes): any dtype but bf16, D not a multiple of 8 or
// above 128, qkv, o or dout not 16-byte aligned or with a row stride that
// is not a multiple of 8 elements, lse or delta not 16-byte aligned;
// cudaErrorNotSupported where the driver has no tensor maps.
#if VAST_PART_ON(4)
extern "C" int vast_tmajor_attention_bwd_sm90(
    const void* qkv, const void* o, const void* dout, const void* bias,
    void* dqkv, void* dbias, float* lse, float* delta, int lse_given,
    int dtype, int B, int L, int H, int D, int kend,
    long long bias_batch_stride, float scale, void* stream) {
  if ((bias == nullptr) != (dbias == nullptr) || dtype != kBf16)
    return (int)cudaErrorInvalidValue;
  return (int)run_bwd_sm90(
      tmajor_bwd_params(qkv, o, dout, bias, dqkv, dbias, lse, delta,
                        lse_given, dtype, B, L, H, D, kend, bias_batch_stride,
                        scale),
      dtype, dtype, static_cast<cudaStream_t>(stream));
}
#endif

// Backward of the head-major attention (flash_attention_bwd): q, o, dout
// and dq (B, H, Lq, D), k, v, dk and dv (B, H, Lk, D), bias (broadcast
// to (B, H, Lq, Lk), fp32) and dbias (B, H, Lq, Lk) fp32, each through
// ``strides``: 30 element strides, (batch, head, row) of q, k, v, o, dout,
// dq, dk, dv, bias and dbias in that order (the last axis of each
// contiguous; 0 broadcasts a bias). ``lse`` is the forward's (B, H, Lq)
// fp32; ``delta`` (B, H, Lq) fp32 scratch. A null dbias: ds is not
// written; else it is written up to the last key tile that holds a key <
// kend (tiles as at vast_tmajor_attention_bwd), so the caller zero-fills
// dbias when kend < Lk. Keys >= kend get dk = dv = 0. Two launches (dQ, then
// dK/dV); returns the first error.
#if VAST_PART_ON(3)
extern "C" int vast_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* bias, void* dq, void* dk, void* dv,
    void* dbias, const float* lse, float* delta, int dtype, int B, int H,
    int Lq, int Lk, int D, int kend, const long long* strides, float scale,
    void* stream) {
  return (int)run_bwd(
      hmajor_bwd_params(q, k, v, o, dout, bias, dq, dk, dv, dbias, lse,
                        delta, B, H, Lq, Lk, D, kend, strides, scale),
      dtype, kF32, static_cast<cudaStream_t>(stream));
}
#endif

// The same function, the same arguments, on the Hopper body. Returns
// cudaErrorInvalidValue, and launches nothing, for operands that body does
// not take (sm90_bwd_takes): any dtype but bf16, D not a multiple of 8 or
// above 128, a stride of q, k, v, o or dout that is 0 or not a multiple of
// 8 elements or a base of theirs not 16-byte aligned, an odd stride of dq,
// dk or dv or a base of theirs not 4-byte aligned, lse or delta not 16-byte
// aligned; cudaErrorNotSupported where the driver has no tensor maps.
#if VAST_PART_ON(4)
extern "C" int vast_flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* bias, void* dq, void* dk, void* dv,
    void* dbias, const float* lse, float* delta, int dtype, int B, int H,
    int Lq, int Lk, int D, int kend, const long long* strides, float scale,
    void* stream) {
  return (int)run_bwd_sm90(
      hmajor_bwd_params(q, k, v, o, dout, bias, dq, dk, dv, dbias, lse,
                        delta, B, H, Lq, Lk, D, kend, strides, scale),
      dtype, kF32, static_cast<cudaStream_t>(stream));
}
#endif

// ---------------------------------------------------------------------
// Window attention for Hopper: Swin's and Video Swin's window blocks
// ---------------------------------------------------------------------
//
// Replaces no TPU kernel. vast_tpu's window blocks (models/swin.py:113-123,
// models/videoswin.py:114-122) tile the region mask over every window of
// the batch, add it to the (1, H, n, n) bias table and hand the general
// flash_attention that (B nW, H, n, n) fp32 sum; the port did the same
// until these kernels, and its backward wrote ds at that size for autograd
// to sum over the windows: at Video Swin-B's 16 x 56 x 56 grid, 9.8 GB of
// bias and 19.5 GB of ds written (and read back) a training step, most of
// the tower's attention time. Here the table and the region labels are
// read per window, and ds is summed into the table's gradient inside the
// kernels: no tensor of the windows' scores' size exists, forward or
// backward.
//
// Contract (vast_window_attention_fwd_sm90 / _bwd_sm90 below). q, k, v (W,
// H, n, D) bf16 through (window, head, row) element strides (the views of
// the packed qkv), W = clips x n_win windows, each clip's n_win windows in
// order. Per (window w, head h): s = (q . k^T) * scale + table[h] in fp32,
// and -inf where the query's and the key's region labels (labels[w %
// n_win], a shifted block's mask as an equivalence: two tokens attend
// where their labels are equal) differ, as the -1e30 of the sum did;
// softmax in fp32, p . v accumulated in fp32, the output in bf16, and on
// request the lse. The backward: dq, dk, dv, and dtable = the sum over the
// W windows of ds = p (do . v^T - delta), (H, n, n) fp32, each window's ds
// in fp32 (as the general backward wrote it).
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): at n 392, D 32
// the work is n / 2 = 196 FLOP a byte of q, k, v and o, under the ridge
// (~295), so the floor is bytes (benchmark/counts/window_attention.py):
// each of q, k, v and o once, the table (H, n, n) and the labels once;
// the first stage's forward (1,024 windows x 4 heads) 0.13 ms, its
// backward 0.25 ms; 3.1 ms over the 24 blocks of a training step. At D 32
// the exp2 of a score (16 a clock an SM) takes as long as its 128 tensor
// operations, and the bias and label reads and the mask compare add to
// the per-score work the tensor cores do not do.
// What the design does about it:
// * the forward, dQ and dK/dV kernels are the general Hopper bodies'
//   (attention_fwd_sm90_kernel, attention_bwd_dq/dkv_sm90_kernel: wgmma
//   fed by the copy engine, a producer thread, two consumer warpgroups of
//   64 rows, persistent blocks), with the products over D at KD = D / 16
//   k-steps (2 at D 32, not 4); the scores' bias comes from the (H, n, n)
//   table through the copy engine, each stage holding the table's tile of
//   its rows and keys beside k and v (fp32, 128-byte swizzle, read by the
//   consumers without bank conflicts: scalar loads of the table, as the
//   general bodies read a broadcast bias, left every tile waiting on L2 and
//   ran 3.2 ms at the first stage's forward against 0.13 ms); the work
//   runs head by head, the windows of one head adjacent, so that the tiles
//   the copy engine brings are L2 hits; the mask is the window's n labels;
//   a warpgroup that owns no row of a work tile issues no product (the
//   fourth 128-row tile of 392 holds 8 rows); the forward's 8-key tail
//   (392 = 3 x 128 + 8) runs as wgmma N 16 first, as the general
//   forward's;
// * ds is not written by them. window_attention_bwd_dtable_sm90_kernel
//   recomputes it by (head, 64-row tile, 64-key tile, chunk of windows):
//   each consumer warpgroup holds its tile's bias in registers and sums
//   ds over its chunk's windows in registers (two products, q . k^T and
//   do . v^T, a window), so the table is read once per chunk and nothing
//   of the windows' size is written; each warpgroup has its own ring of
//   stages and its own producer thread. The chunks are sized in the
//   wrapper so that every stage fills the SMs four times over (the first
//   stage's 4 heads x 49 tiles in 6 chunks, the last's 32 x 49 in one);
// * window_attention_bwd_dtable_reduce_kernel adds the chunks' partial
//   sums in chunk order: deterministic, no atomics (skipped for one
//   chunk, whose sums are the gradient).
// Measured on the H100 at the first stage (8 clips, shifted; PERF.md's
// kernel table): the forward 1.11 ms, the backward 3.32 (dQ 1.15, dK/dV
// 1.25, the table's partial sums 0.91), against 3.43 and 13.2 of the
// general op on the materialised sum. Found with builds that switched
// parts off: a branch a pair in the backward kernels (pairs past n or
// across regions skipped) cost them 1.5 ms of 5.0, so p is formed for
// every pair and kept by a select; the table's tiles take 0.56 ms of the
// forward's 1.29 (0.73 without them), but next to nothing of dQ and
// dK/dV (3.62 ms without them against 3.67, in a build that still
// branched), which wait on their serial chain of products and
// exponentials. Tried and slower: (a) items of (head, 64-row slab,
// chunk of windows) whose slab of the table stays in shared memory for
// the chunk, each consumer warpgroup on windows of its own (then forward
// 1.39 ms, backward 5.51 against 1.33 and 5.04): k and v read 7 times a
// window, not 4, and each window's q fetched behind its warpgroup's last
// tile; (b) pairs of blocks (clusters of two) on two windows that share
// each stage's table tile through the copy engine's multicast, half the
// table's bytes from L2 (forward 1.56 ms, dQ 2.02, dK/dV 2.23: the pair
// runs in lockstep). Later levers, not here: two windows a work tile in
// one block sharing its table tile, ds summed in the dQ kernel rather
// than recomputed, N 32 products of p . v and dq at D 32.

// Part 5 (VAST_PART): the window entries and everything they alone use
#if VAST_PART_ON(5)
namespace {

// the window op's operands, and the rows of WinParams::st
enum WinOperand { wQ, wK, wV, wO, wDO, wDQ, wDK, wDV, kWinOperands };

struct WinParams {
  const void* in[5];      // q, k, v, o, do (the forward reads q, k, v)
  void* out;              // the forward's output (strides st[wO])
  void* grad[3];          // dq, dk, dv
  long long st[kWinOperands][3];  // element strides (window, head, row)
  const float* table;     // (H, n, n) fp32, contiguous
  const int* labels;      // (n_win, n) region labels; null: no mask
  float* lse;             // (W, H, n) fp32: the forward's; null: not written
  float* delta;           // (W, H, n) fp32 scratch of the backward
  float* partial;         // (chunks, H, n, n) fp32: ds summed by chunk
  float* dtable;          // (H, n, n) fp32; null: not computed
  int W, H, n, D, n_win, per_chunk, chunks;
  float scale;
};

// window w's labels (null without a mask) and a row's label (-1 past n)
__device__ __forceinline__ const int* win_labels(const WinParams& p, int w) {
  return p.labels ? p.labels + (long long)(w % p.n_win) * p.n : nullptr;
}

__device__ __forceinline__ int win_label(const int* lab, int row, int n) {
  return lab && row < n ? __ldg(lab + row) : -1;
}

// the labels of tokens c and c + 1 (c even; n a multiple of 4, so both lie
// in the window or neither), -1 each past n or without a mask
__device__ __forceinline__ int2 win_label_pair(const int* lab, int c, int n) {
  return lab && c < n ? __ldg(reinterpret_cast<const int2*>(lab + c))
                      : make_int2(-1, -1);
}

// A tile of the table in shared memory, as the copy engine lays it: boxes
// of 32 keys (128 bytes of fp32) by `rows` rows in 128-byte swizzle (zeros
// past n). The bias of (row r, key c), and of keys c and c + 1 (c even).
constexpr int kWinBiasKeys = 32;

__device__ __forceinline__ const float* win_bias_ptr(const unsigned char* tile,
                                                     int rows, int r, int c) {
  return reinterpret_cast<const float*>(
      tile + ((c >> 5) * rows + r) * kSm90RowBytes +
      ((((c & 31) >> 2) ^ (r & 7)) << 4) + 4 * (c & 3));
}

__device__ __forceinline__ float2 win_bias_pair(const unsigned char* tile,
                                                int rows, int r, int c) {
  return *reinterpret_cast<const float2*>(win_bias_ptr(tile, rows, r, c));
}

// The table's boxes of 32 keys that hold keys of the window from key k0 on
// (of at most `most`): the copy engine brings no box that lies past n
__device__ __forceinline__ int win_boxes(int n, int k0, int most) {
  return min(most, (n - k0 + kWinBiasKeys - 1) / kWinBiasKeys);
}

// The forward's shared memory: q, then each stage's k, v and table tile
// (the work tile's 128 rows by the key tile's 128 keys), then the
// barriers (full and empty per stage, then q's full and empty)
struct WinFwdSmem {
  static constexpr int kStages = 2;
  static constexpr unsigned kQBytes = kSm90BlockQ * kSm90RowBytes;
  static constexpr unsigned kKvBytes = kSm90BlockK * kSm90RowBytes;
  static constexpr unsigned kBiasBytes = kSm90BlockQ * kSm90BlockK * 4;
  static constexpr unsigned kStageBytes = 2 * kKvBytes + kBiasBytes;
  static constexpr unsigned kBarOffset = kQBytes + kStages * kStageBytes;
  static constexpr size_t kBytes = kBarOffset + (2 * kStages + 2) * 8 + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory on sm_90");
};

// dQ's: BwdDqSmem<64>'s with the table tile (128 rows by 64 keys) after
// each stage's k and v
struct WinDqSmem {
  static constexpr unsigned kOwnedBytes = kBwdSm90Owned * kSm90RowBytes;
  static constexpr unsigned kTileBytes = kBwdSm90Inner * kSm90RowBytes;
  static constexpr unsigned kBiasBytes = kBwdSm90Owned * kBwdSm90Inner * 4;
  static constexpr unsigned kStageBytes = 2 * kTileBytes + kBiasBytes;
  static constexpr unsigned kBarOffset =
      3 * kOwnedBytes + kBwdSm90Stages * kStageBytes;
  static constexpr size_t kBytes =
      kBarOffset + (2 * kBwdSm90Stages + 2) * 8 + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory on sm_90");
};

// dK/dV's: BwdDkvSmem<64>'s with the table tile (64 rows by 128 keys)
// after each stage's q, do, lse and delta
struct WinDkvSmem {
  static constexpr unsigned kOwnedBytes = kBwdSm90Owned * kSm90RowBytes;
  static constexpr unsigned kTileBytes = kBwdSm90Inner * kSm90RowBytes;
  static constexpr unsigned kStatBytes = kStatBox * 4;
  static constexpr unsigned kStatStride = 512;
  static constexpr unsigned kBiasOffset = 2 * kTileBytes + 1024;
  static constexpr unsigned kBiasBytes = kBwdSm90Inner * kBwdSm90Owned * 4;
  static constexpr unsigned kStageBytes = kBiasOffset + kBiasBytes;
  static constexpr unsigned kBarOffset =
      2 * kOwnedBytes + kBwdSm90Stages * kStageBytes;
  static constexpr size_t kBytes =
      kBarOffset + (2 * kBwdSm90Stages + 2) * 8 + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory on sm_90");
};

// One forward consumer warpgroup: sm90_consumer's at DP 64 (one 64-column
// box), the scores' bias from table[h] and the mask from window w's labels
template <int KD>
__device__ __forceinline__ void win_fwd_consumer(
    const WinParams& p, const unsigned char* qs, const unsigned char* kv,
    uint64_t* full, uint64_t* empty, uint64_t* qfull, uint64_t* qempty,
    int wg, int q0, int h, int w, int n_tiles, int ring, unsigned qphase) {
  using S = WinFwdSmem;
  constexpr int kSteps = kSm90BlockK / 16;      // 16-key steps of p . v
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n = p.n, D = p.D;
  const int rl = 64 * wg + 16 * warp + g;       // the row in the work tile
  const int row0 = q0 + rl, row1 = row0 + 8;
  const bool active = q0 + 64 * wg < n;         // the warpgroup owns a row
  const float scale2 = p.scale * kLog2e;
  const int* lab = win_labels(p, w);
  const int lr[2] = {win_label(lab, row0, n), win_label(lab, row1, n)};
  mbar_wait_or_trap(qfull, qphase);

  float o[32], s[64];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  uint32_t pa[kSteps][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  const unsigned char* qw = qs + 64 * wg * kSm90RowBytes;

  auto scores = [&](auto& sc, int st) {
    const unsigned char* ks = kv + st * S::kStageBytes;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const uint64_t da = wgmma_desc(qw + kk * 32, 16, 1024);
      const uint64_t db = wgmma_desc(ks + kk * 32, 16, 1024);
      if constexpr (sizeof(sc) == 64 * sizeof(float))
        wgmma_m64n128k16_ss(sc, da, db, kk > 0);
      else
        wgmma_m64n16k16_ss(sc, da, db, kk > 0);
    }
    wgmma_commit();
  };
  auto values = [&](const auto& pk, int st) {
    constexpr int steps = sizeof(pk) / sizeof(pk[0]);
    const unsigned char* vs = kv + st * S::kStageBytes + S::kKvBytes;
#pragma unroll
    for (int kk = 0; kk < steps; ++kk)
      wgmma_m64n64k16_rs(
          o, pk[kk],
          wgmma_desc(vs + 16 * kk * kSm90RowBytes,
                     kSm90BlockK * kSm90RowBytes, 1024),
          1);
    wgmma_commit();
  };
  // the scores of the tile from k0 (stage st) into log2 units: times the
  // scale, plus the table's bias from the stage, -inf where the labels
  // differ
  auto to_log2 = [&](auto& sc, int k0, int st) {
    constexpr int nj = sizeof(sc) / sizeof(float) / 4;
    const unsigned char* bt = kv + st * S::kStageBytes + 2 * S::kKvBytes;
#pragma unroll
    for (int j = 0; j < nj; ++j) {
      const int2 lk = win_label_pair(lab, k0 + 8 * j + 2 * t, n);
      const float2 b[2] = {win_bias_pair(bt, kSm90BlockQ, rl, 8 * j + 2 * t),
                           win_bias_pair(bt, kSm90BlockQ, rl + 8,
                                         8 * j + 2 * t)};
      // keys past n: the copy engine's zeros, masked by the softmax;
      // rows past n are not stored
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const float x = fmaf((i & 1) ? b[r].y : b[r].x, kLog2e,
                             sc[4 * j + i] * scale2);
        sc[4 * j + i] = ((i & 1) ? lk.y : lk.x) == lr[r] ? x : -INFINITY;
      }
    }
  };
  auto rescale = [&]() {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
  };
  // key tile kt as the i-th of the work tile's, its stage the ring's next
  auto wide_tile = [&](int kt, int i) {
    const int st = (ring + i) % S::kStages;
    mbar_wait_or_trap(full + st, ((ring + i) / S::kStages) & 1);
    if (active) {
      __syncwarp();
      wgmma_fence();
      scores(s, st);
      wgmma_wait<0>();
      fence_regs(s);
    }
    if (i == n_tiles - 1) mbar_arrive(qempty);    // the next q may come
    if (active) {
      const int k0 = kt * kSm90BlockK;
      to_log2(s, k0, st);
      sm90_softmax<16>(s, m, l, alpha, n, k0, t, 1.f);
      rescale();
      pack_p<16>(s, pa);
      wgmma_fence();
      values(pa, st);
      wgmma_wait<0>();
      fence_regs(o);
    }
    mbar_arrive(empty + st);                      // stage st may be refilled
  };
  auto tail_tile = [&](int kt, int i) {
    const int st = (ring + i) % S::kStages;
    float s16[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s16[j] = 0.f;
    mbar_wait_or_trap(full + st, ((ring + i) / S::kStages) & 1);
    if (active) {
      __syncwarp();
      wgmma_fence();
      scores(s16, st);
      wgmma_wait<0>();
      fence_regs(s16);
    }
    if (i == n_tiles - 1) mbar_arrive(qempty);
    if (active) {
      const int k0 = kt * kSm90BlockK;
      to_log2(s16, k0, st);
      sm90_softmax<2>(s16, m, l, alpha, n, k0, t, 1.f);
      rescale();
      uint32_t pa16[1][4];
      pack_p<2>(s16, pa16);
      wgmma_fence();
      values(pa16, st);
      wgmma_wait<0>();
      fence_regs(o);
    }
    mbar_arrive(empty + st);
  };

  const bool tail16 = sm90_tail16(n, n_tiles);
  if (tail16) tail_tile(n_tiles - 1, 0);
  for (int kt = 0; kt < n_tiles - tail16; ++kt) wide_tile(kt, kt + tail16);
  if (!active) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  const float inv0 = l[0] > 0.f ? 1.f / l[0] : 0.f;
  const float inv1 = l[1] > 0.f ? 1.f / l[1] : 0.f;
  if (p.lse && t == 0) {
    float* lse_wh = p.lse + ((long long)w * p.H + h) * n;
    if (row0 < n) lse_wh[row0] = row_lse(m[0] * kLn2, l[0]);
    if (row1 < n) lse_wh[row1] = row_lse(m[1] * kLn2, l[1]);
  }
  auto* og = plane<__nv_bfloat16>(p.out, p.st[wO][0], p.st[wO][1], w, h);
  const long long o_rs = p.st[wO][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = 8 * j + 2 * t;                  // D is even: d + 1 < D too
    if (d >= D) continue;
    if (row0 < n)
      *reinterpret_cast<__nv_bfloat162*>(og + row0 * o_rs + d) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (row1 < n)
      *reinterpret_cast<__nv_bfloat162*>(og + row1 * o_rs + d) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

// (query or key tile, window, head) of work tile u: the tiles of a window
// adjacent, then the windows of one head in order. The tile of u is
// rotated by its window, so that a block, whose work tiles lie gridDim.x
// apart, does not take the last (8 of 392 rows) tile of every window
// when gridDim.x is a multiple of the tiles (132 of 4). With win_boxes
// this took 10% off the forward and 7% off dQ with dK/dV at the first
// stage.
struct WinWork {
  int r0, w, h;
};

__device__ __forceinline__ WinWork win_work(int u, int n_tiles, int rows,
                                            int W) {
  const int wh = u / n_tiles;
  return WinWork{(u % n_tiles + wh) % n_tiles * rows, wh % W, wh / W};
}

// Persistent, as attention_fwd_sm90_kernel: a block per SM takes work
// tiles u = blockIdx.x, + gridDim.x, ...; the producer's first thread
// brings each work tile's 128 query rows, then per key tile its k, v and
// the table's tile of those rows and keys (through tmap).
template <int KD>
__global__ void __launch_bounds__(kSm90Threads, 1)
window_attention_fwd_sm90_kernel(const WinParams p,
                                 const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 const __grid_constant__ CUtensorMap tmap,
                                 const Sm90Slot sq, const Sm90Slot sk,
                                 const Sm90Slot sv, int n_qtiles,
                                 int n_work) {
  using S = WinFwdSmem;
  extern __shared__ __align__(1024) unsigned char win_smem[];
  unsigned char* qs = align_1024(win_smem);
  unsigned char* kv = qs + S::kQBytes;
  auto* full = reinterpret_cast<uint64_t*>(qs + S::kBarOffset);
  uint64_t* empty = full + S::kStages;
  uint64_t* qfull = empty + S::kStages;
  uint64_t* qempty = qfull + 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128 * kSm90Consumers);
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, 128 * kSm90Consumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_tiles = (p.n + kSm90BlockK - 1) / kSm90BlockK;
  const int wg = threadIdx.x / 128;
  if (wg == kSm90Consumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kSm90ProducerRegs));
    if (threadIdx.x != 128 * kSm90Consumers) return;
    const bool tail16 = sm90_tail16(p.n, n_tiles);
    int ring = 0;
    for (int u = blockIdx.x, c = 0; u < n_work; u += gridDim.x, ++c) {
      const WinWork wk = win_work(u, n_qtiles, kSm90BlockQ, p.W);
      if (c > 0) mbar_wait_or_trap(qempty, (c - 1) & 1);
      mbar_arrive_expect_tx(qfull, S::kQBytes);
      tma_load_at(qs, &qmap, qfull, sq, 0, wk.w, wk.h, wk.r0);
      for (int i = 0; i < n_tiles; ++i, ++ring) {
        const int k0 = kSm90BlockK * sm90_key_tile(i, n_tiles, tail16);
        const int st = ring % S::kStages;
        mbar_wait_or_trap(empty + st, ((ring / S::kStages) & 1) ^ 1);
        const int boxes = win_boxes(p.n, k0, kSm90BlockK / kWinBiasKeys);
        mbar_arrive_expect_tx(
            full + st, 2 * S::kKvBytes + boxes * kSm90BlockQ * kSm90RowBytes);
        unsigned char* ks = kv + st * S::kStageBytes;
        tma_load_at(ks, &kmap, full + st, sk, 0, wk.w, wk.h, k0);
        tma_load_at(ks + S::kKvBytes, &vmap, full + st, sv, 0, wk.w, wk.h,
                    k0);
        for (int c = 0; c < boxes; ++c)
          tma_load_4d(ks + 2 * S::kKvBytes + c * kSm90BlockQ * kSm90RowBytes,
                      &tmap, full + st, k0 + c * kWinBiasKeys, wk.r0, wk.h,
                      0);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kSm90ConsumerRegs));
    for (int u = blockIdx.x, c = 0; u < n_work; u += gridDim.x, ++c) {
      const WinWork wk = win_work(u, n_qtiles, kSm90BlockQ, p.W);
      win_fwd_consumer<KD>(p, qs, kv, full, empty, qfull, qempty, wg, wk.r0,
                           wk.h, wk.w, n_tiles, c * n_tiles, c & 1);
    }
  }
}

// One dQ consumer warpgroup: bwd_dq_consumer's at DP 64 given the lse, the
// bias from table[h] and the mask from window w's labels, no ds written
template <int KD>
__device__ __forceinline__ void win_dq_consumer(
    const WinParams& p, const unsigned char* qs, const unsigned char* dos,
    const unsigned char* os, const unsigned char* ring, uint64_t* full,
    uint64_t* empty, uint64_t* ofull, uint64_t* oempty, int wg, int q0,
    int h, int w, int n_k, int ring0, unsigned ophase) {
  using S = WinDqSmem;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * warp + g;
  const int row0 = q0 + r0, row1 = row0 + 8;
  const int n = p.n;
  const bool active = q0 + 64 * wg < n;
  const float scale2 = p.scale * kLog2e;
  const long long stat0 = ((long long)w * p.H + h) * n;
  const int* lab = win_labels(p, w);
  const int lr[2] = {win_label(lab, row0, n), win_label(lab, row1, n)};
  const unsigned char* qw = qs + 64 * wg * kSm90RowBytes;
  const unsigned char* dow = dos + 64 * wg * kSm90RowBytes;
  mbar_wait_or_trap(ofull, ophase);

  // delta of rows r0 and r0 + 8 from do and o in shared memory, as
  // bwd_dq_consumer sums it
  float delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int off = (r0 + 8 * r) * kSm90RowBytes +
                      ((t + g + 4 * i) & 7) * 16;
      acc += dot_bf16x8(*reinterpret_cast<const uint4*>(dos + off),
                        *reinterpret_cast<const uint4*>(os + off));
    }
    acc += __shfl_xor_sync(kFull, acc, 1);
    acc += __shfl_xor_sync(kFull, acc, 2);
    delta[r] = acc;
  }
  if (t == 0) {
    if (row0 < n) p.delta[stat0 + row0] = delta[0];
    if (row1 < n) p.delta[stat0 + row1] = delta[1];
  }
  const float lse2[2] = {row0 < n ? p.lse[stat0 + row0] * kLog2e : INFINITY,
                         row1 < n ? p.lse[stat0 + row1] * kLog2e : INFINITY};

  float s[32], dp[32], dq[1][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[0][i] = 0.f;
  for (int it = 0; it < n_k; ++it) {
    const int ri = ring0 + it, st = ri % kBwdSm90Stages;
    mbar_wait_or_trap(full + st, (ri / kBwdSm90Stages) & 1);
    const unsigned char* ks = ring + st * S::kStageBytes;
    if (active) {
      __syncwarp();
      wgmma_fence();
      bwd_sm90_abt<KD>(s, qw, kBwdSm90Owned, ks);
      bwd_sm90_abt<KD>(dp, dow, kBwdSm90Owned, ks + S::kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (it == n_k - 1) mbar_arrive(oempty);    // the next q, do, o may come
      const int k0 = it * kBwdSm90Inner;
      const unsigned char* bt = ks + 2 * S::kTileBytes;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + 8 * j + 2 * t;
        const int2 lk = win_label_pair(lab, key, n);
        const float2 b[2] = {
            win_bias_pair(bt, kBwdSm90Owned, r0, 8 * j + 2 * t),
            win_bias_pair(bt, kBwdSm90Owned, r0 + 8, 8 * j + 2 * t)};
        // p is formed for every pair and kept where the pair counts:
        // a select, not a branch
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const bool keep = key + (i & 1) < n && (r ? row1 : row0) < n &&
                            ((i & 1) ? lk.y : lk.x) == lr[r];
          const float pr = ex2(fmaf((i & 1) ? b[r].y : b[r].x, kLog2e,
                                    fmaf(s[4 * j + i], scale2, -lse2[r])));
          s[4 * j + i] = (keep ? pr : 0.f) * (dp[4 * j + i] - delta[r]);
        }
      }
      uint32_t da[4][4];
      bwd_sm90_pack(s, da);
      wgmma_fence();
      bwd_sm90_xy<1>(dq, da, ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq[0]);
    } else if (it == n_k - 1) {
      mbar_arrive(oempty);
    }
    mbar_arrive(empty + st);                     // stage st may be refilled
  }
  if (active)
    bwd_sm90_store<1>(
        plane<__nv_bfloat16>(p.grad[0], p.st[wDQ][0], p.st[wDQ][1], w, h),
        p.st[wDQ][2], dq, row0, n, p.D, p.scale, t);
}

// One dK/dV consumer warpgroup: bwd_dkv_consumer's at DP 64, the bias
// from table[h] and the mask from window w's labels
template <int KD>
__device__ __forceinline__ void win_dkv_consumer(
    const WinParams& p, const unsigned char* ks, const unsigned char* vs,
    const unsigned char* ring, uint64_t* full, uint64_t* empty,
    uint64_t* ofull, uint64_t* oempty, int wg, int k0, int h, int w,
    int n_q, int ring0, unsigned ophase) {
  using S = WinDkvSmem;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kl = 64 * wg + 16 * warp + g;       // the key in the work tile
  const int key0 = k0 + kl, key1 = key0 + 8;
  const int n = p.n;
  const long long stat0 = ((long long)w * p.H + h) * n;
  const bool active = k0 + 64 * wg < n;
  const float scale2 = p.scale * kLog2e;
  const int* lab = win_labels(p, w);
  const int lk[2] = {win_label(lab, key0, n), win_label(lab, key1, n)};
  const unsigned char* kw = ks + 64 * wg * kSm90RowBytes;
  const unsigned char* vw = vs + 64 * wg * kSm90RowBytes;
  float dk[1][32], dv[1][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[0][i] = dv[0][i] = 0.f;
  mbar_wait_or_trap(ofull, ophase);
  for (int it = 0; it < n_q; ++it) {
    const int ri = ring0 + it, st = ri % kBwdSm90Stages;
    mbar_wait_or_trap(full + st, (ri / kBwdSm90Stages) & 1);
    const unsigned char* qt = ring + st * S::kStageBytes;
    const unsigned char* dot = qt + S::kTileBytes;
    // the tile's lse and delta, (stat0 + q0) % 4 values into their boxes
    const int q0 = it * kBwdSm90Inner, at = (int)((stat0 + q0) & 3);
    const float* lse_s =
        reinterpret_cast<const float*>(qt + 2 * S::kTileBytes) + at;
    const float* delta_s = reinterpret_cast<const float*>(
        qt + 2 * S::kTileBytes + S::kStatStride) + at;
    const unsigned char* bt = qt + S::kBiasOffset;
    if (active) {
      float sT[32], dpT[32];
      __syncwarp();
      wgmma_fence();
      bwd_sm90_abt<KD>(sT, kw, kBwdSm90Owned, qt);
      bwd_sm90_abt<KD>(dpT, vw, kBwdSm90Owned, dot);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sT);
      fence_regs(dpT);
      if (it == n_q - 1) mbar_arrive(oempty);    // the next k, v may come
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float lse[2] = {lse_s[c] * kLog2e, lse_s[c + 1] * kLog2e};
        const float dl[2] = {delta_s[c], delta_s[c + 1]};
        const int2 lq = win_label_pair(lab, q0 + c, n);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool keep = (i < 2 ? key0 : key1) < n && q0 + c + (i & 1) < n &&
                            ((i & 1) ? lq.y : lq.x) == lk[i >> 1];
          const float x = ex2(fmaf(*win_bias_ptr(bt, kBwdSm90Inner,
                                                 c + (i & 1),
                                                 kl + 8 * (i >> 1)),
                                   kLog2e,
                                   fmaf(sT[4 * j + i], scale2, -lse[i & 1])));
          const float pr = keep ? x : 0.f;
          dpT[4 * j + i] = pr * (dpT[4 * j + i] - dl[i & 1]);
          sT[4 * j + i] = pr;
        }
      }
      uint32_t pa[4][4], da[4][4];
      bwd_sm90_pack(sT, pa);
      bwd_sm90_pack(dpT, da);
      wgmma_fence();
      bwd_sm90_xy<1>(dv, pa, dot);
      bwd_sm90_xy<1>(dk, da, qt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk[0]);
      fence_regs(dv[0]);
    } else if (it == n_q - 1) {
      mbar_arrive(oempty);
    }
    mbar_arrive(empty + st);                     // stage st may be refilled
  }
  if (active) {
    bwd_sm90_store<1>(
        plane<__nv_bfloat16>(p.grad[1], p.st[wDK][0], p.st[wDK][1], w, h),
        p.st[wDK][2], dk, key0, n, p.D, p.scale, t);
    bwd_sm90_store<1>(
        plane<__nv_bfloat16>(p.grad[2], p.st[wDV][0], p.st[wDV][1], w, h),
        p.st[wDV][2], dv, key0, n, p.D, 1.f, t);
  }
}

// Persistent, as attention_bwd_dq_sm90_kernel given the lse: a work tile's
// q, do and o, then its key tiles' k, v and table tile (through tmap)
template <int KD>
__global__ void __launch_bounds__(kSm90Threads, 1)
window_attention_bwd_dq_sm90_kernel(const WinParams p,
                                    const __grid_constant__ BwdMaps m,
                                    const __grid_constant__ CUtensorMap tmap,
                                    int n_qtiles, int n_work) {
  using S = WinDqSmem;
  extern __shared__ __align__(1024) unsigned char win_smem[];
  unsigned char* qs = align_1024(win_smem);
  unsigned char* dos = qs + S::kOwnedBytes;
  unsigned char* os = dos + S::kOwnedBytes;
  unsigned char* ring = os + S::kOwnedBytes;
  auto* full = reinterpret_cast<uint64_t*>(qs + S::kBarOffset);
  uint64_t* empty = full + kBwdSm90Stages;
  uint64_t* ofull = empty + kBwdSm90Stages;
  uint64_t* oempty = ofull + 1;
  bwd_sm90_init(full);
  const int n_k = (p.n + kBwdSm90Inner - 1) / kBwdSm90Inner;
  const int wg = threadIdx.x / 128;
  if (wg == kSm90Consumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kSm90ProducerRegs));
    if (threadIdx.x != 128 * kSm90Consumers) return;
    int ri = 0;
    for (int u = blockIdx.x, c = 0; u < n_work; u += gridDim.x, ++c) {
      const WinWork wk = win_work(u, n_qtiles, kBwdSm90Owned, p.W);
      if (c > 0) mbar_wait_or_trap(oempty, (c - 1) & 1);
      mbar_arrive_expect_tx(ofull, 3 * S::kOwnedBytes);
      tma_load_at(qs, &m.own[0], ofull, m.own_slot[0], 0, wk.w, wk.h, wk.r0);
      tma_load_at(dos, &m.own[1], ofull, m.own_slot[1], 0, wk.w, wk.h,
                  wk.r0);
      tma_load_at(os, &m.own[2], ofull, m.own_slot[2], 0, wk.w, wk.h, wk.r0);
      for (int it = 0; it < n_k; ++it, ++ri) {
        const int st = ri % kBwdSm90Stages;
        mbar_wait_or_trap(empty + st, ((ri / kBwdSm90Stages) & 1) ^ 1);
        const int boxes = win_boxes(p.n, it * kBwdSm90Inner,
                                    kBwdSm90Inner / kWinBiasKeys);
        mbar_arrive_expect_tx(
            full + st,
            2 * S::kTileBytes + boxes * kBwdSm90Owned * kSm90RowBytes);
        unsigned char* ks = ring + st * S::kStageBytes;
        tma_load_at(ks, &m.str[0], full + st, m.str_slot[0], 0, wk.w, wk.h,
                    it * kBwdSm90Inner);
        tma_load_at(ks + S::kTileBytes, &m.str[1], full + st, m.str_slot[1],
                    0, wk.w, wk.h, it * kBwdSm90Inner);
        for (int c2 = 0; c2 < boxes; ++c2)
          tma_load_4d(ks + 2 * S::kTileBytes +
                          c2 * kBwdSm90Owned * kSm90RowBytes,
                      &tmap, full + st, it * kBwdSm90Inner + c2 * kWinBiasKeys,
                      wk.r0, wk.h, 0);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kSm90ConsumerRegs));
    for (int u = blockIdx.x, c = 0; u < n_work; u += gridDim.x, ++c) {
      const WinWork wk = win_work(u, n_qtiles, kBwdSm90Owned, p.W);
      win_dq_consumer<KD>(p, qs, dos, os, ring, full, empty, ofull, oempty,
                          wg, wk.r0, wk.h, wk.w, n_k, c * n_k, c & 1);
    }
  }
}

// Persistent, as attention_bwd_dkv_sm90_kernel: a work tile's k and v,
// then its query tiles' q, do, lse, delta and table tile (through tmap)
template <int KD>
__global__ void __launch_bounds__(kSm90Threads, 1)
window_attention_bwd_dkv_sm90_kernel(const WinParams p,
                                     const __grid_constant__ BwdMaps m,
                                     const __grid_constant__ CUtensorMap tmap,
                                     int n_ktiles, int n_work) {
  using S = WinDkvSmem;
  extern __shared__ __align__(1024) unsigned char win_smem[];
  unsigned char* ks = align_1024(win_smem);
  unsigned char* vs = ks + S::kOwnedBytes;
  unsigned char* ring = vs + S::kOwnedBytes;
  auto* full = reinterpret_cast<uint64_t*>(ks + S::kBarOffset);
  uint64_t* empty = full + kBwdSm90Stages;
  uint64_t* ofull = empty + kBwdSm90Stages;
  uint64_t* oempty = ofull + 1;
  bwd_sm90_init(full);
  const int n_q = (p.n + kBwdSm90Inner - 1) / kBwdSm90Inner;
  const int wg = threadIdx.x / 128;
  if (wg == kSm90Consumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kSm90ProducerRegs));
    if (threadIdx.x != 128 * kSm90Consumers) return;
    int ri = 0;
    for (int u = blockIdx.x, c = 0; u < n_work; u += gridDim.x, ++c) {
      const WinWork wk = win_work(u, n_ktiles, kBwdSm90Owned, p.W);
      if (c > 0) mbar_wait_or_trap(oempty, (c - 1) & 1);
      mbar_arrive_expect_tx(ofull, 2 * S::kOwnedBytes);
      tma_load_at(ks, &m.own[0], ofull, m.own_slot[0], 0, wk.w, wk.h, wk.r0);
      tma_load_at(vs, &m.own[1], ofull, m.own_slot[1], 0, wk.w, wk.h, wk.r0);
      const long long stat0 = ((long long)wk.w * p.H + wk.h) * p.n;
      for (int it = 0; it < n_q; ++it, ++ri) {
        const int st = ri % kBwdSm90Stages;
        mbar_wait_or_trap(empty + st, ((ri / kBwdSm90Stages) & 1) ^ 1);
        const int boxes =
            win_boxes(p.n, wk.r0, kBwdSm90Owned / kWinBiasKeys);
        mbar_arrive_expect_tx(full + st,
                              2 * S::kTileBytes + 2 * S::kStatBytes +
                                  boxes * kBwdSm90Inner * kSm90RowBytes);
        unsigned char* qt = ring + st * S::kStageBytes;
        tma_load_at(qt, &m.str[0], full + st, m.str_slot[0], 0, wk.w, wk.h,
                    it * kBwdSm90Inner);
        tma_load_at(qt + S::kTileBytes, &m.str[1], full + st, m.str_slot[1],
                    0, wk.w, wk.h, it * kBwdSm90Inner);
        unsigned char* stat = qt + 2 * S::kTileBytes;
        const int at = (int)((stat0 + it * kBwdSm90Inner) & ~3LL);
        tma_load_1d(stat, &m.stat[0], full + st, at);
        tma_load_1d(stat + S::kStatStride, &m.stat[1], full + st, at);
        for (int c2 = 0; c2 < boxes; ++c2)
          tma_load_4d(qt + S::kBiasOffset +
                          c2 * kBwdSm90Inner * kSm90RowBytes,
                      &tmap, full + st, wk.r0 + c2 * kWinBiasKeys,
                      it * kBwdSm90Inner, wk.h, 0);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kSm90ConsumerRegs));
    for (int u = blockIdx.x, c = 0; u < n_work; u += gridDim.x, ++c) {
      const WinWork wk = win_work(u, n_ktiles, kBwdSm90Owned, p.W);
      win_dkv_consumer<KD>(p, ks, vs, ring, full, empty, ofull, oempty, wg,
                           wk.r0, wk.h, wk.w, n_q, c * n_q, c & 1);
    }
  }
}

// The dtable kernel's shared memory: per consumer warpgroup a ring of
// stages, each one window's q and do (the item's 64 rows), k and v (its 64
// keys), each a 64-column box of 64 rows, and the rows' lse and delta boxes
// (kStatBox fp32 each, delta 512 bytes after lse); then the barriers (per
// warpgroup, full and empty per stage).
struct WinDtSmem {
  static constexpr int kStages = 3;
  static constexpr unsigned kTileBytes = kBwdSm90Inner * kSm90RowBytes;
  static constexpr unsigned kStatBytes = kStatBox * 4;
  static constexpr unsigned kStatStride = 512;
  static constexpr unsigned kStageBytes = 4 * kTileBytes + 1024;
  static constexpr unsigned kRingBytes = kStages * kStageBytes;
  static constexpr unsigned kBarOffset = kSm90Consumers * kRingBytes;
  static constexpr size_t kBytes =
      kBarOffset + kSm90Consumers * 2 * kStages * 8 + 1024;
  static_assert(kStatStride + kStatBytes <= 1024, "lse and delta in a pad");
  static_assert(kBytes <= 232448, "a block's shared memory on sm_90");
};

// (key tile, row tile, head, chunk) of dtable work item u, key tiles
// fastest
struct WinDtItem {
  int k0, r0, h, chunk;
};

__device__ __forceinline__ WinDtItem win_dt_item(int u, int n_tiles, int H) {
  return WinDtItem{u % n_tiles * kBwdSm90Inner,
                   u / n_tiles % n_tiles * kBwdSm90Inner,
                   u / (n_tiles * n_tiles) % H, u / (n_tiles * n_tiles * H)};
}

// The table's gradient by chunk of windows: each consumer warpgroup is a
// worker of its own (work items 2 blockIdx.x + wg, + 2 gridDim.x, ...), fed
// by its own producer thread (the first thread of warp wg of the last
// warpgroup) through its own ring. An item (64 rows x 64 keys of head h)
// holds its bias in registers, then over its chunk's windows forms s = q .
// k^T and dp = do . v^T from shared memory, p = exp2(s scale log2e + bias
// log2e - lse log2e) masked by the window's labels and ds = p (dp - delta),
// and sums ds in registers; the sums go to partial[chunk][h] once.
template <int KD>
__global__ void __launch_bounds__(kSm90Threads, 1)
window_attention_bwd_dtable_sm90_kernel(const WinParams p,
                                        const __grid_constant__ BwdMaps m,
                                        int n_tiles, int n_items) {
  using S = WinDtSmem;
  extern __shared__ __align__(1024) unsigned char win_smem[];
  unsigned char* base = align_1024(win_smem);
  auto* bars = reinterpret_cast<uint64_t*>(base + S::kBarOffset);
  if (threadIdx.x == 0) {
    for (int c = 0; c < kSm90Consumers; ++c)
      for (int s = 0; s < S::kStages; ++s) {
        mbar_init(bars + 2 * S::kStages * c + s, 1);
        mbar_init(bars + 2 * S::kStages * c + S::kStages + s, 128);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128, workers = kSm90Consumers * gridDim.x;
  const int n = p.n;
  if (wg == kSm90Consumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kSm90ProducerRegs));
    const int c = (threadIdx.x - 128 * kSm90Consumers) / 32;
    if (c >= kSm90Consumers || (threadIdx.x & 31)) return;
    unsigned char* ring = base + c * S::kRingBytes;
    uint64_t* full = bars + 2 * S::kStages * c;
    uint64_t* empty = full + S::kStages;
    int ri = 0;
    for (int u = kSm90Consumers * blockIdx.x + c; u < n_items; u += workers) {
      const WinDtItem it = win_dt_item(u, n_tiles, p.H);
      const int w0 = it.chunk * p.per_chunk;
      const int w1 = min(p.W, w0 + p.per_chunk);
      for (int w = w0; w < w1; ++w, ++ri) {
        const int st = ri % S::kStages;
        mbar_wait_or_trap(empty + st, ((ri / S::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full + st,
                              4 * S::kTileBytes + 2 * S::kStatBytes);
        unsigned char* at = ring + st * S::kStageBytes;
        tma_load_at(at, &m.str[0], full + st, m.str_slot[0], 0, w, it.h,
                    it.r0);
        tma_load_at(at + S::kTileBytes, &m.str[1], full + st, m.str_slot[1],
                    0, w, it.h, it.r0);
        tma_load_at(at + 2 * S::kTileBytes, &m.own[0], full + st,
                    m.own_slot[0], 0, w, it.h, it.k0);
        tma_load_at(at + 3 * S::kTileBytes, &m.own[1], full + st,
                    m.own_slot[1], 0, w, it.h, it.k0);
        const long long stat0 = ((long long)w * p.H + it.h) * n;
        const int sa = (int)((stat0 + it.r0) & ~3LL);
        tma_load_1d(at + 4 * S::kTileBytes, &m.stat[0], full + st, sa);
        tma_load_1d(at + 4 * S::kTileBytes + S::kStatStride, &m.stat[1],
                    full + st, sa);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kSm90ConsumerRegs));
  const unsigned char* ring = base + wg * S::kRingBytes;
  uint64_t* full = bars + 2 * S::kStages * wg;
  uint64_t* empty = full + S::kStages;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float scale2 = p.scale * kLog2e;
  int ri = 0;
  for (int u = kSm90Consumers * blockIdx.x + wg; u < n_items; u += workers) {
    const WinDtItem it = win_dt_item(u, n_tiles, p.H);
    const int w0 = it.chunk * p.per_chunk;
    const int w1 = min(p.W, w0 + p.per_chunk);
    const int rr = 16 * warp + g;              // the thread's first row
    const int row0 = it.r0 + rr, row1 = row0 + 8;
    const float* tab = p.table + (long long)it.h * n * n;
    // the item's bias, 0 outside the table
    float bias[32], acc[32];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = it.k0 + 8 * j + 2 * t + (i & 1);
        const int row = i < 2 ? row0 : row1;
        bias[4 * j + i] = key < n && row < n
                              ? __ldg(tab + (long long)row * n + key)
                              : 0.f;
        acc[4 * j + i] = 0.f;
      }
    for (int w = w0; w < w1; ++w, ++ri) {
      const int st = ri % S::kStages;
      mbar_wait_or_trap(full + st, (ri / S::kStages) & 1);
      const unsigned char* at = ring + st * S::kStageBytes;
      float s[32], dp[32];
      __syncwarp();
      wgmma_fence();
      bwd_sm90_abt<KD>(s, at, kBwdSm90Inner, at + 2 * S::kTileBytes);
      bwd_sm90_abt<KD>(dp, at + S::kTileBytes, kBwdSm90Inner,
                       at + 3 * S::kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      const long long stat0 = ((long long)w * p.H + it.h) * n;
      const int sa = (int)((stat0 + it.r0) & 3);
      const float* lse_s =
          reinterpret_cast<const float*>(at + 4 * S::kTileBytes) + sa;
      const float* delta_s = reinterpret_cast<const float*>(
          at + 4 * S::kTileBytes + S::kStatStride) + sa;
      const float lse2[2] = {lse_s[rr] * kLog2e, lse_s[rr + 8] * kLog2e};
      const float dl[2] = {delta_s[rr], delta_s[rr + 8]};
      const int* lab = win_labels(p, w);
      const int lr[2] = {win_label(lab, row0, n), win_label(lab, row1, n)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = it.k0 + 8 * j + 2 * t;
        const int2 lk = win_label_pair(lab, key, n);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const bool keep = key + (i & 1) < n && (r ? row1 : row0) < n &&
                            ((i & 1) ? lk.y : lk.x) == lr[r];
          const float pr = ex2(fmaf(bias[4 * j + i], kLog2e,
                                    fmaf(s[4 * j + i], scale2, -lse2[r])));
          acc[4 * j + i] += (keep ? pr : 0.f) * (dp[4 * j + i] - dl[r]);
        }
      }
      mbar_arrive(empty + st);                   // stage st may be refilled
    }
    float* out = p.partial + ((long long)it.chunk * p.H + it.h) * n * n;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = it.k0 + 8 * j + 2 * t + (i & 1);
        const int row = i < 2 ? row0 : row1;
        if (key < n && row < n) out[(long long)row * n + key] = acc[4 * j + i];
      }
  }
}

// dtable = the chunks' partial sums added in chunk order
__global__ void window_attention_bwd_dtable_reduce_kernel(
    const float* partial, float* dtable, long long count, int chunks) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < count; e += (long long)gridDim.x * blockDim.x) {
    float s = partial[e];
    for (int c = 1; c < chunks; ++c) s += partial[c * count + e];
    dtable[e] = s;
  }
}

// The copy engine reads q, k, v (and o, do) and the 1-D maps lse and
// delta; the epilogues write bf16 pairs: bf16, D a multiple of 8 from 8 to
// 64 (one 64-column box), every stride of the read operands a positive
// multiple of 8 elements and their bases 16-byte aligned, the written
// ones' strides even and bases 4-byte aligned, the lse and delta 16-byte
// aligned, a table 16-byte aligned whose rows the copy engine reads (n a
// multiple of 4), the labels 8-byte aligned (read in pairs), W a
// multiple of n_win, and W x H x n below 2^31.
bool window_takes(const WinParams& p, int dtype, bool bwd) {
  if (dtype != kBf16 || p.D < 8 || p.D > kSm90Box || p.D % 8 || p.n < 1 ||
      p.n % 4 || p.W < 1 || p.H < 1 || p.n_win < 1 || p.W % p.n_win ||
      !p.table || reinterpret_cast<uintptr_t>(p.table) % 16 ||
      reinterpret_cast<uintptr_t>(p.labels) % 8 ||
      (long long)p.W * p.H * p.n >= INT_MAX)
    return false;
  for (int o = wQ; o <= (bwd ? wDO : wV); ++o) {
    if (reinterpret_cast<uintptr_t>(p.in[o]) % 16) return false;
    for (int j = 0; j < 3; ++j)
      if (p.st[o][j] <= 0 || p.st[o][j] % 8) return false;
  }
  const int first = bwd ? wDQ : wO, last = bwd ? wDV : wO;
  for (int o = first; o <= last; ++o) {
    const void* base = bwd ? p.grad[o - wDQ] : p.out;
    if (reinterpret_cast<uintptr_t>(base) % 4) return false;
    for (int j = 0; j < 3; ++j)
      if (p.st[o][j] % 2) return false;
  }
  if (bwd && (!p.lse || !p.delta ||
              reinterpret_cast<uintptr_t>(p.lse) % 16 ||
              reinterpret_cast<uintptr_t>(p.delta) % 16))
    return false;
  return !p.lse || reinterpret_cast<uintptr_t>(p.lse) % 4 == 0;
}

// The copy engine's map of the (H, n, n) fp32 table: dimensions key, row,
// head (and a unit one), boxes of 32 keys by box_rows rows in 128-byte
// swizzle (zeros past n)
cudaError_t encode_table_map(CUtensorMap* map, const float* table, int H,
                             int n, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t N = n;
  const cuuint64_t dims[4] = {N, N, (cuuint64_t)H, 1};
  const cuuint64_t strides[3] = {N * 4, N * N * 4, H * N * N * 4};
  const cuuint32_t box[4] = {kWinBiasKeys, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(table),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int KD>
cudaError_t launch_window_fwd(const WinParams& p, cudaStream_t stream) {
  CUtensorMap maps[3], tmap;
  Sm90Slot slots[3];
  for (int o = wQ; o <= wV; ++o) {
    const cudaError_t err =
        encode_hmajor_map(&maps[o], &slots[o], p.in[o], p.st[o], p.W, p.H,
                          p.n, p.D, o == wQ ? kSm90BlockQ : kSm90BlockK);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = encode_table_map(&tmap, p.table, p.H, p.n, kSm90BlockQ);
  if (err != cudaSuccess) return err;
  auto kern = window_attention_fwd_sm90_kernel<KD>;
  const size_t smem = WinFwdSmem::kBytes;
  err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (p.n + kSm90BlockQ - 1) / kSm90BlockQ;
  const long long n_work = (long long)n_qtiles * p.W * p.H;
  int blocks;
  if ((err = persistent_blocks(n_work, &blocks)) != cudaSuccess) return err;
  kern<<<blocks, kSm90Threads, smem, stream>>>(
      p, maps[wQ], maps[wK], maps[wV], tmap, slots[wQ], slots[wK],
      slots[wV], n_qtiles, (int)n_work);
  return cudaGetLastError();
}

// dQ (and delta), then dK/dV, then, where the table's gradient is asked,
// its partial sums by chunk and their reduction; returns the first error
template <int KD>
cudaError_t launch_window_bwd(const WinParams& p, cudaStream_t stream) {
  BwdMaps mq, mk, mt;
  CUtensorMap tq, tk;
  cudaError_t err = cudaSuccess;
  const int own_q[3] = {wQ, wDO, wO}, kv[2] = {wK, wV}, qdo[2] = {wQ, wDO};
  auto map = [&](CUtensorMap* at, Sm90Slot* slot, int o, int rows) {
    if (err == cudaSuccess)
      err = encode_hmajor_map(at, slot, p.in[o], p.st[o], p.W, p.H, p.n, p.D,
                              rows);
  };
  for (int i = 0; i < 3; ++i)
    map(&mq.own[i], &mq.own_slot[i], own_q[i], kBwdSm90Owned);
  for (int i = 0; i < 2; ++i) {
    map(&mq.str[i], &mq.str_slot[i], kv[i], kBwdSm90Inner);
    map(&mk.own[i], &mk.own_slot[i], kv[i], kBwdSm90Owned);
    map(&mk.str[i], &mk.str_slot[i], qdo[i], kBwdSm90Inner);
    map(&mt.own[i], &mt.own_slot[i], kv[i], kBwdSm90Inner);
    map(&mt.str[i], &mt.str_slot[i], qdo[i], kBwdSm90Inner);
  }
  const long long n_stat = (long long)p.W * p.H * p.n;
  if (err == cudaSuccess) err = encode_stat_map(&mk.stat[0], p.lse, n_stat);
  if (err == cudaSuccess) err = encode_stat_map(&mk.stat[1], p.delta, n_stat);
  if (err == cudaSuccess)
    err = encode_table_map(&tq, p.table, p.H, p.n, kBwdSm90Owned);
  if (err == cudaSuccess)
    err = encode_table_map(&tk, p.table, p.H, p.n, kBwdSm90Inner);
  if (err != cudaSuccess) return err;
  mt.stat[0] = mk.stat[0];
  mt.stat[1] = mk.stat[1];

  auto dq_kern = window_attention_bwd_dq_sm90_kernel<KD>;
  auto dkv_kern = window_attention_bwd_dkv_sm90_kernel<KD>;
  auto dt_kern = window_attention_bwd_dtable_sm90_kernel<KD>;
  if ((err = allow_smem(dq_kern, WinDqSmem::kBytes)) != cudaSuccess ||
      (err = allow_smem(dkv_kern, WinDkvSmem::kBytes)) != cudaSuccess ||
      (err = allow_smem(dt_kern, WinDtSmem::kBytes)) != cudaSuccess)
    return err;
  const int n_owned = (p.n + kBwdSm90Owned - 1) / kBwdSm90Owned;
  const long long n_work = (long long)n_owned * p.W * p.H;
  int blocks;
  if ((err = persistent_blocks(n_work, &blocks)) != cudaSuccess) return err;
  dq_kern<<<blocks, kSm90Threads, WinDqSmem::kBytes, stream>>>(
      p, mq, tq, n_owned, (int)n_work);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkv_kern<<<blocks, kSm90Threads, WinDkvSmem::kBytes, stream>>>(
      p, mk, tk, n_owned, (int)n_work);
  if ((err = cudaGetLastError()) != cudaSuccess || !p.dtable) return err;

  const int n_tiles = (p.n + kBwdSm90Inner - 1) / kBwdSm90Inner;
  const long long n_items = (long long)p.chunks * p.H * n_tiles * n_tiles;
  if ((err = persistent_blocks((n_items + kSm90Consumers - 1) /
                                   kSm90Consumers,
                               &blocks)) != cudaSuccess)
    return err;
  dt_kern<<<blocks, kSm90Threads, WinDtSmem::kBytes, stream>>>(
      p, mt, n_tiles, (int)n_items);
  if ((err = cudaGetLastError()) != cudaSuccess || p.chunks == 1) return err;
  const long long count = (long long)p.H * p.n * p.n;
  const long long red_blocks = (count + 255) / 256;
  window_attention_bwd_dtable_reduce_kernel<<<
      (int)(red_blocks < 4096 ? red_blocks : 4096), 256, 0, stream>>>(
      p.partial, p.dtable, count, p.chunks);
  return cudaGetLastError();
}

// The WinParams of the window entries (their arguments, described there)
WinParams window_params(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* table,
                        const int* labels, void* out, void* dq, void* dk,
                        void* dv, float* lse, float* delta, float* partial,
                        float* dtable, int W, int H, int n, int D, int n_win,
                        int per_chunk, int chunks, const long long* strides,
                        float scale) {
  WinParams p = {};
  p.in[wQ] = q;
  p.in[wK] = k;
  p.in[wV] = v;
  p.in[wO] = o;
  p.in[wDO] = dout;
  p.out = out;
  p.grad[0] = dq;
  p.grad[1] = dk;
  p.grad[2] = dv;
  memcpy(p.st, strides, sizeof(p.st));
  p.table = table;
  p.labels = labels;
  p.lse = lse;
  p.delta = delta;
  p.partial = partial;
  p.dtable = dtable;
  p.W = W;
  p.H = H;
  p.n = n;
  p.D = D;
  p.n_win = n_win;
  p.per_chunk = per_chunk;
  p.chunks = chunks;
  p.scale = scale;
  return p;
}

}  // namespace
#endif

// Window attention's forward (ops/window_attention.py window_attention):
// q, k, v and out (W, H, n, D) bf16, each through its (window, head, row)
// element strides in ``strides`` (24 values: q, k, v, out, then 12 unread),
// the last axis contiguous; table (H, n, n) fp32 contiguous; labels (n_win,
// n) int32 contiguous, each clip's windows' region labels (null: no mask);
// lse (W, H, n) fp32 contiguous, or null: not written. Returns
// cudaErrorInvalidValue, and launches nothing, for operands the kernel
// does not take (window_takes); cudaErrorNotSupported where the driver has
// no tensor maps.
#if VAST_PART_ON(5)
extern "C" int vast_window_attention_fwd_sm90(
    const void* q, const void* k, const void* v, const float* table,
    const int* labels, void* out, float* lse, int dtype, int W, int H, int n,
    int D, int n_win, const long long* strides, float scale, void* stream) {
  const WinParams p = window_params(q, k, v, nullptr, nullptr, table, labels,
                                    out, nullptr, nullptr, nullptr, lse,
                                    nullptr, nullptr, nullptr, W, H, n, D,
                                    n_win, 1, 1, strides, scale);
  if (!window_takes(p, dtype, false)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D <= 32 ? launch_window_fwd<2>(p, s)
                       : launch_window_fwd<4>(p, s));
}
#endif

// Window attention's backward: q, k, v as the forward took them, o its
// output and dout its cotangent (W, H, n, D), dq, dk, dv the same, each
// through ``strides`` (24 values: q, k, v, o, dout, dq, dk, dv); table and
// labels as the forward's; lse the forward's (W, H, n) fp32 and delta (W,
// H, n) fp32 scratch, both 16-byte aligned; dtable (H, n, n) fp32 (null:
// not computed), the windows' ds summed, through partial ((chunks, H, n,
// n) fp32 scratch, the windows cut in chunks of per_chunk; with one chunk
// partial may be dtable itself). Up to four launches (dQ, dK/dV, the
// table's partial sums, their reduction); returns the first error, and
// cudaErrorInvalidValue, launching nothing, for operands the kernels do not
// take.
#if VAST_PART_ON(5)
extern "C" int vast_window_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* table, const int* labels, void* dq,
    void* dk, void* dv, float* dtable, float* partial, float* lse,
    float* delta, int dtype, int W, int H, int n, int D, int n_win,
    int per_chunk, int chunks, const long long* strides, float scale,
    void* stream) {
  const WinParams p = window_params(q, k, v, o, dout, table, labels, nullptr,
                                    dq, dk, dv, lse, delta, partial, dtable,
                                    W, H, n, D, n_win, per_chunk, chunks,
                                    strides, scale);
  if (!window_takes(p, dtype, true) ||
      (dtable && (!partial || per_chunk < 1 || chunks < 1 ||
                  (long long)per_chunk * (chunks - 1) >= W ||
                  (long long)per_chunk * chunks < W ||
                  (chunks == 1) != (partial == dtable))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D <= 32 ? launch_window_bwd<2>(p, s)
                       : launch_window_bwd<4>(p, s));
}
#endif
