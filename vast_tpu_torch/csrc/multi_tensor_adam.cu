// Multi-tensor Adam, AdamW and Adamax update for Hopper (sm_90a).
//
// One launch applies GroupedAdam's update (vast_tpu_torch/training/
// optimizer.py) to every trainable tensor that the optimizer hands it, in
// place of its per-tensor loop of about 18 elementwise launches a tensor.
// It replaces no TPU kernel: vast_tpu leaves the update to optax and XLA,
// which fuses it.
//
// Contract. The optimizer builds two device tables once (again after a
// reshard or a load):
//   tensors[t] = {p, mu, nu, n, group}: the fp32 parameter, its moments
//                (fp32 or bf16, one dtype each across the table), its
//                element count and its group (0-5: basic, basic_nd, new,
//                new_nd, clip, clip_nd);
//   chunks[c]  = {t, start}: kChunk elements of tensor t from start (fewer
//                at its end); one block a chunk.
// Each step it sends grads[t], the fp32 gradient pointers (null: a zero
// gradient, whose moments decay and whose parameter decoupled weight decay
// still moves), and passes the scalars by value: per group -lr and the
// weight decay, b1, b2, eps and the bias corrections c1 = 1 - b1^k, c2 =
// 1 - b2^k. `norm` (device, or null without clipping) is the gradient's
// global norm: where it is not below max_norm every gradient is scaled
// g / norm * max_norm, as optax.clip_by_global_norm scales it, with no
// host wait.
//
// Arithmetic: element by element in fp32, the same operations in the same
// order as the optimizer's per-tensor plain version, each one rounded
// (__f*_rn: no contraction into FMAs), the moments rounded to their dtype
// where the plain version's copy_ rounds them:
//   kAdam (optax.scale_by_adam):   m = (1-b1) g + rnd_mu(mu * rnd_mu(b1)),
//                                  nu = (1-b2) g g + b2 nu, mu = rnd_mu(m),
//                                  u = (m/c1) / (sqrt(nu/c2) + eps);
//   kAdamGeneral (adam_nu_dtype):  mu = rnd(b1 mu + (1-b1) g),
//                                  nu = rnd(b2 nu + (1-b2) g g),
//                                  u = (mu/c1) / (sqrt(nu/c2) + eps);
//   kAdamax:                       mu = (1-b1) g + b1 mu,
//                                  nu = max(|g| + eps, b2 nu), u = (mu/c1)/nu;
// then u += wd p where wd != 0, and p += u * -lr.
//
// What bounds it on an H100: HBM bytes. It reads p, g, mu and nu and
// writes p, mu and nu: 28 bytes a parameter with fp32 moments (1.25 B
// parameters: 35 GB, about 10.4 ms at 3.35 TB/s), at about 1 FLOP a byte.
// What the design does about it: every element is read and written once,
// 16 bytes a load where a chunk's pointers allow (8 for bf16 moments),
// elements past the last whole vector one at a time; blocks of 512
// threads over chunks of 64K elements keep each SM's loads in flight; the
// tables stay on the device, so a step moves only its gradient pointers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 512;
constexpr long long kChunk = 65536;  // optimizer.py CHUNK
constexpr int kGroups = 6;

enum { kAdam = 0, kAdamGeneral = 1, kAdamax = 2 };

struct TensorEntry {
  float* p;
  void* mu;
  void* nu;
  long long n;
  long long group;
};

// The scalars, in the order of the C entry's `scalars`.
struct Hyper {
  float one_minus_b1, b1_mu, b1, one_minus_b2, b2, eps, c1, c2, max_norm;
  float neg_lr[kGroups];
  float wd[kGroups];
};

template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision, in fp32
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

// torch.maximum: NaN if either is
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fmaxf(a, b);
}

template <int MODE, typename MuT, typename NuT>
__device__ __forceinline__ void update(float& p, float g, MuT& mu, NuT& nu,
                                       const Hyper& h, float neg_lr,
                                       float wd) {
  float u;
  if (MODE == kAdam) {
    const float m = __fadd_rn(__fmul_rn(h.one_minus_b1, g),
                              rnd<MuT>(__fmul_rn(to_f(mu), h.b1_mu)));
    nu = from_f<NuT>(__fadd_rn(__fmul_rn(__fmul_rn(h.one_minus_b2, g), g),
                               __fmul_rn(h.b2, to_f(nu))));
    mu = from_f<MuT>(m);
    u = __fdiv_rn(__fdiv_rn(m, h.c1),
                  __fadd_rn(__fsqrt_rn(__fdiv_rn(to_f(nu), h.c2)), h.eps));
  } else if (MODE == kAdamGeneral) {
    mu = from_f<MuT>(__fadd_rn(__fmul_rn(h.b1, to_f(mu)),
                               __fmul_rn(h.one_minus_b1, g)));
    nu = from_f<NuT>(__fadd_rn(__fmul_rn(h.b2, to_f(nu)),
                               __fmul_rn(__fmul_rn(h.one_minus_b2, g), g)));
    u = __fdiv_rn(__fdiv_rn(to_f(mu), h.c1),
                  __fadd_rn(__fsqrt_rn(__fdiv_rn(to_f(nu), h.c2)), h.eps));
  } else {
    mu = from_f<MuT>(__fadd_rn(__fmul_rn(h.one_minus_b1, g),
                               __fmul_rn(h.b1, to_f(mu))));
    nu = from_f<NuT>(nan_max(__fadd_rn(fabsf(g), h.eps),
                             __fmul_rn(h.b2, to_f(nu))));
    u = __fdiv_rn(__fdiv_rn(to_f(mu), h.c1), to_f(nu));
  }
  if (wd != 0.f) u = __fadd_rn(u, __fmul_rn(wd, p));
  p = __fadd_rn(p, __fmul_rn(u, neg_lr));
}

// optax.clip_by_global_norm's g / norm * max_norm where the norm is not
// below max_norm
__device__ __forceinline__ float clipped(float g, bool clip, float norm,
                                         float max_norm) {
  return clip ? __fmul_rn(__fdiv_rn(g, norm), max_norm) : g;
}

__device__ __forceinline__ bool aligned(const void* x, int bytes) {
  return reinterpret_cast<uintptr_t>(x) % bytes == 0;
}

template <int MODE, typename MuT, typename NuT>
__global__ void __launch_bounds__(kThreads)
    multi_tensor_adam_kernel(const TensorEntry* __restrict__ tensors,
                             const long long* __restrict__ chunks,
                             const float* const* __restrict__ grads,
                             const float* __restrict__ norm, Hyper h) {
  const long long t = chunks[2 * blockIdx.x];
  const long long start = chunks[2 * blockIdx.x + 1];
  const TensorEntry e = tensors[t];
  const int len = static_cast<int>(min(kChunk, e.n - start));
  float* p = e.p + start;
  MuT* mu = static_cast<MuT*>(e.mu) + start;
  NuT* nu = static_cast<NuT*>(e.nu) + start;
  const float* g = grads[t];
  if (g != nullptr) g += start;
  // the group's scalars by constant indices, so that h stays in the
  // parameter bank (an index from memory would copy it to the stack)
  float neg_lr = h.neg_lr[0], wd = h.wd[0];
#pragma unroll
  for (int k = 1; k < kGroups; ++k) {
    if (e.group == k) {
      neg_lr = h.neg_lr[k];
      wd = h.wd[k];
    }
  }
  const float nrm = norm != nullptr ? *norm : 0.f;
  const bool clip = norm != nullptr && !(nrm < h.max_norm);

  int vec_end = 0;
  if (aligned(p, 16) && (g == nullptr || aligned(g, 16)) &&
      aligned(mu, sizeof(Vec4<MuT>)) && aligned(nu, sizeof(Vec4<NuT>))) {
    vec_end = len & ~3;
    for (int i = 4 * threadIdx.x; i < vec_end; i += 4 * kThreads) {
      Vec4<float> pv = *reinterpret_cast<const Vec4<float>*>(p + i);
      Vec4<float> gv = {{0.f, 0.f, 0.f, 0.f}};
      if (g != nullptr) gv = *reinterpret_cast<const Vec4<float>*>(g + i);
      Vec4<MuT> mv = *reinterpret_cast<const Vec4<MuT>*>(mu + i);
      Vec4<NuT> nv = *reinterpret_cast<const Vec4<NuT>*>(nu + i);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        update<MODE>(pv.v[j], clipped(gv.v[j], clip, nrm, h.max_norm),
                     mv.v[j], nv.v[j], h, neg_lr, wd);
      *reinterpret_cast<Vec4<float>*>(p + i) = pv;
      *reinterpret_cast<Vec4<MuT>*>(mu + i) = mv;
      *reinterpret_cast<Vec4<NuT>*>(nu + i) = nv;
    }
  }
  for (int i = vec_end + threadIdx.x; i < len; i += kThreads) {
    float pi = p[i];
    MuT mi = mu[i];
    NuT ni = nu[i];
    update<MODE>(pi, clipped(g != nullptr ? g[i] : 0.f, clip, nrm, h.max_norm),
                 mi, ni, h, neg_lr, wd);
    p[i] = pi;
    mu[i] = mi;
    nu[i] = ni;
  }
}

template <int MODE, typename MuT, typename NuT>
cudaError_t launch(const void* tensors, const void* chunks, const void* grads,
                   unsigned blocks, const float* norm, const Hyper& h,
                   cudaStream_t stream) {
  multi_tensor_adam_kernel<MODE, MuT, NuT><<<blocks, kThreads, 0, stream>>>(
      static_cast<const TensorEntry*>(tensors),
      static_cast<const long long*>(chunks),
      static_cast<const float* const*>(grads), norm, h);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_dtypes(int mu_dtype, int nu_dtype, const void* tensors,
                          const void* chunks, const void* grads,
                          unsigned blocks, const float* norm, const Hyper& h,
                          cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int key = mu_dtype * 2 + nu_dtype;
  if (key == 0)
    return launch<MODE, float, float>(tensors, chunks, grads, blocks, norm, h,
                                      stream);
  if (key == 1)
    return launch<MODE, float, bf16>(tensors, chunks, grads, blocks, norm, h,
                                     stream);
  if (key == 2)
    return launch<MODE, bf16, float>(tensors, chunks, grads, blocks, norm, h,
                                     stream);
  return launch<MODE, bf16, bf16>(tensors, chunks, grads, blocks, norm, h,
                                  stream);
}

}  // namespace

// One update of every tensor of the tables (device pointers `tensors`,
// `chunks`, `grads`; `n_chunks` entries of `chunks`). mode: 0 Adam/AdamW
// (optax), 1 Adam with adam_nu_dtype (moments rounded before use), 2
// Adamax. mu_dtype, nu_dtype: 0 fp32, 1 bf16. scalars: 9 + 2 x 6 host
// floats, Hyper's fields in order. norm: a device fp32 scalar, or null
// without clipping. Returns a cudaError_t (0: launched).
extern "C" int vast_multi_tensor_adam(const void* tensors, const void* chunks,
                                      const void* grads, long long n_chunks,
                                      int mode, int mu_dtype, int nu_dtype,
                                      const float* scalars, const float* norm,
                                      void* stream) {
  if (n_chunks < 0 || n_chunks > 0x7fffffffLL || mode < 0 || mode > 2 ||
      mu_dtype < 0 || mu_dtype > 1 || nu_dtype < 0 || nu_dtype > 1)
    return cudaErrorInvalidValue;
  if (n_chunks == 0) return cudaSuccess;
  Hyper h;
  static_assert(sizeof(Hyper) == (9 + 2 * kGroups) * sizeof(float),
                "Hyper is the scalars' floats in order");
  memcpy(&h, scalars, sizeof(Hyper));
  const unsigned blocks = static_cast<unsigned>(n_chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kAdam)
    return launch_dtypes<kAdam>(mu_dtype, nu_dtype, tensors, chunks, grads,
                                blocks, norm, h, s);
  if (mode == kAdamGeneral)
    return launch_dtypes<kAdamGeneral>(mu_dtype, nu_dtype, tensors, chunks,
                                       grads, blocks, norm, h, s);
  return launch_dtypes<kAdamax>(mu_dtype, nu_dtype, tensors, chunks, grads,
                                blocks, norm, h, s);
}
