// Fused AdamW for Hopper (sm_90a): one AdamW step, in place, over one
// parameter tensor and its gradient and two moments.
//
// Replaces the TPU kernel _kernel / fused_adamw_update of
// paddle_tpu/ops/pallas_kernels/fused_adamw.py and computes what it (and
// the composed update of paddle_tpu/optimizer/optimizers.py,
// AdamW._apply_one) computes, in fp32 whatever the storage dtype:
//   m1 = beta1 * m1 + (1 - beta1) * g
//   m2 = beta2 * m2 + (1 - beta2) * g * g
//   p  = p * (1 - lr * wd) - lr * (m1 / (1 - beta1^t)) / (sqrt(m2 / (1 - beta2^t)) + eps)
// lr and the beta powers are arguments of every launch, so a schedule
// never rebuilds anything.  Two forms:
//
// - adamw_kernel: p, m1 and m2 are written back in their storage dtype
//   (bf16 or fp32, the same for all four tensors: the pure-bf16 regime
//   keeps its moments in the parameter dtype);
// - adamw_master_kernel, the fp32-master form (multi_precision=True over
//   bf16 or fp16 parameters): g is bf16 or fp16; the fp32 master weight
//   takes p's place in the formula, the master and the fp32 moments are
//   written back in fp32, and p is written in its storage dtype, rounded
//   from the new master.  p is never read.  This is AdamW._apply_one's
//   composed master path (optimizers.py:266-290), which the Pallas kernel
//   does not cover: the JAX package sends masters around it.
//
// What bounds it on this card: bytes.  Each element reads p, g, m1, m2
// and writes p, m1, m2 (14 bytes in bf16, 28 in fp32; the master form
// reads g 2, master 4, m1 4, m2 4 and writes master 4, m1 4, m2 4, p 2:
// 28 bytes) for ~15 operations: far below the card's operations per byte.
// The design streams each tensor once: 16-byte loads and stores (8 bf16
// or 4 fp32 elements per thread and step; the master form takes 8
// elements a step, one 16-byte load of g and two of each fp32 tensor) in
// a grid-stride loop over the flattened tensor, fp32 arithmetic in
// registers, a scalar loop for the tail (and for a tensor whose pointers
// are not 16-byte aligned).  One launch per parameter tensor: the stacked
// GPT keeps its decoder weights as a few [L, ...] slabs, 16 tensors in
// all, so a multi-tensor launch would save little.
//
// Interface: plain C, loaded through ctypes by
// paddle_tpu_torch/ops/kernels/fused_adamw.py.  The launch goes on the
// caller's stream, allocates nothing and returns the cudaError_t.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

namespace {

constexpr int THREADS = 256;

struct Args {
  void* p;
  const void* g;
  void* m1;
  void* m2;
  long long n;
  int vec;                 // all four pointers are 16-byte aligned
  // host-computed scalars, as the plain version uses them
  float lr, beta1, beta2, one_minus_beta1, one_minus_beta2, eps;
  float decay;             // 1 - lr * wd
  float bc1, bc2;          // 1 - beta1^t, 1 - beta2^t
};

__device__ __forceinline__ void update(float& p, float g, float& m1, float& m2,
                                       const Args& a) {
  m1 = a.beta1 * m1 + a.one_minus_beta1 * g;
  m2 = a.beta2 * m2 + a.one_minus_beta2 * g * g;
  const float m1h = m1 / a.bc1;
  const float m2h = m2 / a.bc2;
  p = p * a.decay - a.lr * m1h / (sqrtf(m2h) + a.eps);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ void from_f(float x, float& out) { out = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16& out) {
  out = __float2bfloat16(x);
}
__device__ __forceinline__ void from_f(float x, __half& out) { out = __float2half(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS) adamw_kernel(const Args a) {
  using V = Vec16<T>;
  T* p = static_cast<T*>(a.p);
  const T* g = static_cast<const T*>(a.g);
  T* m1 = static_cast<T*>(a.m1);
  T* m2 = static_cast<T*>(a.m2);
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nvec = a.vec ? a.n / V::N : 0;
  for (long long i = first; i < nvec; i += stride) {
    float pf[V::N], gf[V::N], m1f[V::N], m2f[V::N];
    V::unpack(reinterpret_cast<const uint4*>(p)[i], pf);
    V::unpack(reinterpret_cast<const uint4*>(g)[i], gf);
    V::unpack(reinterpret_cast<const uint4*>(m1)[i], m1f);
    V::unpack(reinterpret_cast<const uint4*>(m2)[i], m2f);
#pragma unroll
    for (int j = 0; j < V::N; ++j) update(pf[j], gf[j], m1f[j], m2f[j], a);
    reinterpret_cast<uint4*>(p)[i] = V::pack(pf);
    reinterpret_cast<uint4*>(m1)[i] = V::pack(m1f);
    reinterpret_cast<uint4*>(m2)[i] = V::pack(m2f);
  }
  for (long long i = nvec * V::N + first; i < a.n; i += stride) {
    float pf = to_f(p[i]), m1f = to_f(m1[i]), m2f = to_f(m2[i]);
    update(pf, to_f(g[i]), m1f, m2f, a);
    from_f(pf, p[i]);
    from_f(m1f, m1[i]);
    from_f(m2f, m2[i]);
  }
}

// The fp32-master form: Args.p is the low-precision parameter (written
// only), w the fp32 master, m1 and m2 fp32.  8 elements a step: one
// 16-byte load of g, two of each of w, m1 and m2, one 16-byte store of p.
struct MasterArgs {
  Args a;                  // a.p: p (T), a.g: g (T), a.m1, a.m2: fp32
  float* w;                // the fp32 master weights
};

template <typename T>
__global__ void __launch_bounds__(THREADS) adamw_master_kernel(const MasterArgs ma) {
  using V = Vec16<T>;
  using F = Vec16<float>;
  static_assert(V::N == 2 * F::N, "a 16-byte T vector spans two fp32 vectors");
  const Args& a = ma.a;
  T* p = static_cast<T*>(a.p);
  const T* g = static_cast<const T*>(a.g);
  float* w = ma.w;
  float* m1 = static_cast<float*>(a.m1);
  float* m2 = static_cast<float*>(a.m2);
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nvec = a.vec ? a.n / V::N : 0;
  for (long long i = first; i < nvec; i += stride) {
    float gf[V::N], wf[V::N], m1f[V::N], m2f[V::N];
    V::unpack(reinterpret_cast<const uint4*>(g)[i], gf);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      F::unpack(reinterpret_cast<const uint4*>(w)[2 * i + h], wf + h * F::N);
      F::unpack(reinterpret_cast<const uint4*>(m1)[2 * i + h], m1f + h * F::N);
      F::unpack(reinterpret_cast<const uint4*>(m2)[2 * i + h], m2f + h * F::N);
    }
#pragma unroll
    for (int j = 0; j < V::N; ++j) update(wf[j], gf[j], m1f[j], m2f[j], a);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      reinterpret_cast<uint4*>(w)[2 * i + h] = F::pack(wf + h * F::N);
      reinterpret_cast<uint4*>(m1)[2 * i + h] = F::pack(m1f + h * F::N);
      reinterpret_cast<uint4*>(m2)[2 * i + h] = F::pack(m2f + h * F::N);
    }
    reinterpret_cast<uint4*>(p)[i] = V::pack(wf);
  }
  for (long long i = nvec * V::N + first; i < a.n; i += stride) {
    float wf = w[i], m1f = m1[i], m2f = m2[i];
    update(wf, to_f(g[i]), m1f, m2f, a);
    w[i] = wf;
    m1[i] = m1f;
    m2[i] = m2f;
    from_f(wf, p[i]);
  }
}

long long grid_blocks(long long n, int elems) {
  long long blocks = (n / elems + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;       // grid-stride beyond that
  return blocks;
}

Args make_args(void* p, const void* g, void* m1, void* m2, long long n, int vec,
               const float* scalars) {
  return Args{p, g, m1, m2, n, vec, scalars[0], scalars[1], scalars[2], scalars[3],
              scalars[4], scalars[5], scalars[6], scalars[7], scalars[8]};
}

}  // namespace

extern "C" {

// device: the CUDA device index every pointer lives on.  dtype: 0 =
// float32, 1 = bfloat16, for all of p, g, m1 and m2 (each contiguous, n
// elements).  scalars: lr, beta1, beta2, 1 - beta1, 1 - beta2, eps,
// 1 - lr * wd, 1 - beta1^t, 1 - beta2^t.  Returns a cudaError_t (0 on
// success).
int fused_adamw(int device, int dtype, void* p, const void* g, void* m1, void* m2,
                long long n, const float* scalars, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int vec = ((uintptr_t)p | (uintptr_t)g | (uintptr_t)m1 | (uintptr_t)m2) % 16 == 0;
  const Args a = make_args(p, g, m1, m2, n, vec, scalars);
  const long long blocks = grid_blocks(n, dtype == 0 ? 4 : 8);  // elements a step
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    adamw_kernel<float><<<(unsigned)blocks, THREADS, 0, s>>>(a);
  else if (dtype == 1)
    adamw_kernel<__nv_bfloat16><<<(unsigned)blocks, THREADS, 0, s>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The fp32-master form.  dtype: 1 = bfloat16, 2 = float16, for p and g;
// master, m1 and m2 are float32 (each contiguous, n elements).  p is
// written, never read.  scalars as for fused_adamw.  Returns a
// cudaError_t (0 on success).
int fused_adamw_master(int device, int dtype, void* p, const void* g, float* master,
                       float* m1, float* m2, long long n, const float* scalars,
                       void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int vec = ((uintptr_t)p | (uintptr_t)g | (uintptr_t)master | (uintptr_t)m1 |
                   (uintptr_t)m2) % 16 == 0;
  const MasterArgs ma{make_args(p, g, m1, m2, n, vec, scalars), master};
  const long long blocks = grid_blocks(n, 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    adamw_master_kernel<__nv_bfloat16><<<(unsigned)blocks, THREADS, 0, s>>>(ma);
  else if (dtype == 2)
    adamw_master_kernel<__half><<<(unsigned)blocks, THREADS, 0, s>>>(ma);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* fused_adamw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
