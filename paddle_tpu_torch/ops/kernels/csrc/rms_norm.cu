// Fused residual add + RMSNorm / LayerNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel built by _build (kernel body `kernel`, one
// pallas_call) of paddle_tpu/ops/pallas_kernels/rms_norm.py, both of its
// instances (_rms_op and _ln_op), and computes what it computes, row by
// row over the last axis:
//   h      = float(x) + float(residual)                      (fp32)
//   RMS:   normed = h * (1 / sqrt(mean(h * h) + eps)) * g
//   LN:    mu = mean(h);  d = h - mu;  var = mean(d * d)
//          normed = d * (1 / sqrt(var + eps)) * g + b
// and writes both normed and h in x's dtype (fp32 or bf16; g and b are
// fp32 or bf16 on their own).  Every statistic stays in fp32, so an eps of
// 1e-12 (BERT's) is not lost; LayerNorm takes two passes over the held row
// (the mean, then the mean of the squared deviations), never E[h^2] - mu^2,
// which cancels.  The TPU gate (hidden a multiple of 128, a row block of at
// least 8) is a constraint of the TPU's lanes: this kernel takes any hidden
// size and any row count.
//
// What bounds it on this card: bytes.  Each element reads x and residual
// and writes normed and h (8 bytes in bf16, 16 in fp32) for ~10 operations.
// The design reads each input once: one CTA per row, the row's h held in
// fp32 registers across the passes (up to HELD elements a thread; a longer
// row's remainder is recomputed from x and residual, the same fp32 add, in
// the later passes), 16-byte loads and stores when every row of x,
// residual, normed and h starts on a 16-byte boundary and scalar ones when
// not; fp32 sums reduced by warp shuffles, then across warps in shared
// memory.
//
// Interface: plain C, loaded through ctypes by
// paddle_tpu_torch/ops/kernels/rms_norm.py.  The launch goes on the
// caller's stream, allocates nothing and returns the cudaError_t.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "vec16.cuh"

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int HELD = 16;            // fp32 row elements a thread keeps

struct Args {
  const void* x;
  const void* r;
  const void* g;
  const void* b;                    // null for RMSNorm
  void* out;
  void* h;
  int hidden;
  float eps;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float& o) { o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16& o) { o = __float2bfloat16(v); }

// one chunk of a row: N consecutive elements, a 16-byte vector (VEC) or a
// single element
template <typename T, bool VEC> struct Chunk;

template <typename T> struct Chunk<T, true> {
  static constexpr int N = Vec16<T>::N;
  static __device__ __forceinline__ void load(const T* p, int c, float* f) {
    Vec16<T>::unpack(reinterpret_cast<const uint4*>(p)[c], f);
  }
  static __device__ __forceinline__ void store(T* p, int c, const float* f) {
    reinterpret_cast<uint4*>(p)[c] = Vec16<T>::pack(f);
  }
};

template <typename T> struct Chunk<T, false> {
  static constexpr int N = 1;
  static __device__ __forceinline__ void load(const T* p, int c, float* f) { f[0] = to_f(p[c]); }
  static __device__ __forceinline__ void store(T* p, int c, const float* f) { from_f(f[0], p[c]); }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum of v over the CTA, returned to every thread
__device__ __forceinline__ float block_sum(float v, float* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? smem[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) smem[32] = v;
  }
  __syncthreads();
  v = smem[32];
  __syncthreads();                  // smem is reused by the next sum
  return v;
}

// h = x + residual in fp32 for chunk c, also written out rounded to T
template <typename T, bool VEC>
__device__ __forceinline__ void add_chunk(const T* x, const T* r, T* h, int c, float* f) {
  using C = Chunk<T, VEC>;
  float rf[C::N];
  C::load(x, c, f);
  C::load(r, c, rf);
#pragma unroll
  for (int j = 0; j < C::N; ++j) f[j] += rf[j];
  C::store(h, c, f);
}

template <typename T, typename P, bool LN, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS) fused_add_norm_kernel(const Args a) {
  using C = Chunk<T, VEC>;
  constexpr int N = C::N;
  constexpr int CAP = HELD / N;      // chunks held in registers
  __shared__ float smem[33];
  const long long off = (long long)blockIdx.x * a.hidden;
  const T* x = static_cast<const T*>(a.x) + off;
  const T* r = static_cast<const T*>(a.r) + off;
  T* out = static_cast<T*>(a.out) + off;
  T* h = static_cast<T*>(a.h) + off;
  const P* g = static_cast<const P*>(a.g);
  const P* b = static_cast<const P*>(a.b);
  const int nchunks = a.hidden / N;
  const int step = blockDim.x;
  const int spill = threadIdx.x + CAP * step;   // first chunk not held

  // pass 1: h (written out), and the sum of h (LN) or of h * h (RMS)
  float held[CAP][N];
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < CAP; ++k) {
    const int c = threadIdx.x + k * step;
    if (c < nchunks) {
      add_chunk<T, VEC>(x, r, h, c, held[k]);
#pragma unroll
      for (int j = 0; j < N; ++j) acc += LN ? held[k][j] : held[k][j] * held[k][j];
    }
  }
  for (int c = spill; c < nchunks; c += step) {
    float f[N];
    add_chunk<T, VEC>(x, r, h, c, f);
#pragma unroll
    for (int j = 0; j < N; ++j) acc += LN ? f[j] : f[j] * f[j];
  }
  const float n = (float)a.hidden;
  const float stat = block_sum(acc, smem) / n;  // mu (LN) or mean h^2 (RMS)

  float inv;
  if (LN) {
    // pass 2: the mean of the squared deviations from mu
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < CAP; ++k) {
      if (threadIdx.x + k * step < nchunks) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float d = held[k][j] - stat;
          sq += d * d;
        }
      }
    }
    for (int c = spill; c < nchunks; c += step) {
      float f[N], rf[N];
      C::load(x, c, f);
      C::load(r, c, rf);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float d = (f[j] + rf[j]) - stat;
        sq += d * d;
      }
    }
    inv = 1.0f / sqrtf(block_sum(sq, smem) / n + a.eps);
  } else {
    inv = 1.0f / sqrtf(stat + a.eps);
  }

  // pass 3: normed
  auto finish = [&](int c, float* f) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int e = c * N + j;
      f[j] = LN ? (f[j] - stat) * inv * to_f(g[e]) + to_f(b[e]) : f[j] * inv * to_f(g[e]);
    }
    C::store(out, c, f);
  };
#pragma unroll
  for (int k = 0; k < CAP; ++k) {
    const int c = threadIdx.x + k * step;
    if (c < nchunks) finish(c, held[k]);
  }
  for (int c = spill; c < nchunks; c += step) {
    float f[N], rf[N];
    C::load(x, c, f);
    C::load(r, c, rf);
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] += rf[j];
    finish(c, f);
  }
}

template <typename T, typename P, bool LN>
cudaError_t launch_typed(const Args& a, long long rows, bool vec, cudaStream_t s) {
  const int per = vec ? Vec16<T>::N : 1;
  const int nchunks = a.hidden / per;
  // one chunk a thread up to 1024 chunks, in whole warps
  int threads = ((nchunks + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  if (vec)
    fused_add_norm_kernel<T, P, LN, true><<<(unsigned)rows, threads, 0, s>>>(a);
  else
    fused_add_norm_kernel<T, P, LN, false><<<(unsigned)rows, threads, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T, bool LN>
cudaError_t launch_params(int param_dtype, const Args& a, long long rows, bool vec,
                          cudaStream_t s) {
  if (param_dtype == 0) return launch_typed<T, float, LN>(a, rows, vec, s);
  if (param_dtype == 1) return launch_typed<T, __nv_bfloat16, LN>(a, rows, vec, s);
  return cudaErrorInvalidValue;
}

template <bool LN>
cudaError_t launch_variant(int dtype, int param_dtype, const Args& a, long long rows,
                           bool vec, cudaStream_t s) {
  if (dtype == 0) return launch_params<float, LN>(param_dtype, a, rows, vec, s);
  if (dtype == 1) return launch_params<__nv_bfloat16, LN>(param_dtype, a, rows, vec, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// device: the CUDA device index every pointer lives on.  layer_norm: 1 =
// LayerNorm (g and b), 0 = RMSNorm (g only; b ignored).  dtype: 0 =
// float32, 1 = bfloat16, of x, residual, out and h (each a contiguous
// [rows, hidden] array); param_dtype the same codes for g and b (each
// [hidden]).  rows >= 1 (the CUDA grid's x dimension), hidden >= 1.
// Returns a cudaError_t (0 on success).
int fused_add_norm(int device, int layer_norm, int dtype, int param_dtype, const void* x,
                   const void* r, const void* g, const void* b, void* out, void* h,
                   long long rows, int hidden, float eps, void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || hidden < 1) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  cudaError_t e = guard.err;
  if (e != cudaSuccess) return (int)e;
  const int item = dtype == 0 ? 4 : 2;
  const bool vec = ((uintptr_t)x | (uintptr_t)r | (uintptr_t)out | (uintptr_t)h) % 16 == 0 &&
                   ((long long)hidden * item) % 16 == 0;
  const Args a{x, r, g, b, out, h, hidden, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = layer_norm ? launch_variant<true>(dtype, param_dtype, a, rows, vec, s)
                 : launch_variant<false>(dtype, param_dtype, a, rows, vec, s);
  return (int)e;
}

const char* fused_add_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
