// Single-query decode attention for Hopper (sm_90a): one new query per
// (batch, head) over a contiguous KV cache, and one per (slot, head) over
// that slot's pages of the paged KV pool.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas_kernels/:
//   - decode_attention.py: _decode_kernel / _decode_pallas (contiguous
//     [B, H, max_seq, D] cache, one scalar length);
//   - paged_attention.py: _paged_kernel / _paged_pallas ([P, H, page_size,
//     D] pool, [S, max_pages] page tables, [S] lengths);
// and computes what they compute: scores q.k * scale in fp32, an online
// softmax over the valid keys 0..length-1 with an fp32 running max,
// denominator and accumulator, P rounded to the cache dtype before the PV
// product (p.astype(v.dtype)) while the denominator sums the unrounded P,
// O = acc / l with the l == 0 guard, so a length-0 row writes zeros.
// fp32 caches are computed in plain fp32 FMA (no TF32).
//
// The int8 variants (the TPU kernels' quantized=True): an int8 cache or
// pool with one fp32 scale per (batch, head) or per (page, head), q and
// the output fp32.  Each key and value is dequantized as it is read,
// float(int8) * scale, before it meets q or P (the TPU kernels' order:
// k.astype(f32) * scale right after the DMA); P stays unrounded, since
// the TPU kernel's p.astype(v.dtype) is fp32 there.  K and V then cost one
// byte per element, half of bf16's, plus 4 bytes per scale.
//
// What bounds it on this card: bytes.  A decode row reads K and V of its
// valid positions once and does 2 x head_dim multiply-adds per key and
// element pair it reads: one operation per byte in bf16, far below the
// ~295 per byte at which Hopper's compute would be the limit.  At the
// generated shape (8 x 16 heads, head_dim 128, bf16, 264 positions) that
// is 17.3 MB, about 5.2 us at 3.35 TB/s.  The design spends its effort on
// the bytes:
//   - keys at or past length are never read (the Pallas kernel's "decode
//     at position p reads O(p) cache"); this also keeps a stale or
//     non-finite value in a recycled cache position or page away from
//     the output, where the plain version's 0 x NaN would not;
//   - the length is read from device memory, so a decode step needs no
//     host sync; the pool's page-table row is read by the CTA itself (the
//     TPU took it by scalar prefetch);
//   - scores: a group of threads per key (16-byte loads, neighbouring
//     threads on neighbouring addresses of one K row, a shuffle sum per
//     group), four keys' loads in flight per thread; PV: threads over
//     16-byte column chunks of V rows, the keys split over the rest of
//     the CTA and the splits summed at the end (a decode block has one
//     valid row: PR 1's lesson for the ragged kernel);
//   - one CTA of 256 threads per (batch, head) or (slot, head), walking
//     its keys in chunks of 256 with the softmax state in registers and
//     the chunk's probabilities in shared memory.
// Splitting one long context over several CTAs (flash-decoding), cp.async
// or TMA staging and the like are left for later work: at 8 x 16 rows the
// launch fills 128 of the 132 SMs with one CTA each.
//
// The two kernels are one template over how (row, key) becomes an element
// offset: contiguous (batch, head, position) strides, where each layer's
// cache is a view of the stacked [L, B, H, max_seq, D] cache, or the
// slot's page-table row.  The same policy says where a key's scale lives:
// scale[b * H + h] for the contiguous cache, scale[page * H + h] for the
// pool.  The template's T is the type of q and the output, KV the type the
// cache stores (T itself, or int8_t).
//
// Interface: plain C, loaded through ctypes by
// paddle_tpu_torch/ops/kernels/decode_attention.py and paged_attention.py.
// Launches go on the caller's stream, allocate nothing and return the
// cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "vec16.cuh"

namespace {

constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int KC = 256;        // keys per chunk of the online softmax
constexpr int UNROLL = 4;      // keys whose loads a thread has in flight
constexpr float NEG_INF = -1e30f;

template <typename T> struct Round;
template <> struct Round<float> {
  static __device__ float p(float x) { return x; }
};
// the probabilities are cast to the cache dtype before the PV product
template <> struct Round<__nv_bfloat16> {
  static __device__ float p(float x) { return __bfloat162float(__float2bfloat16(x)); }
};

// to fp32, for a q element of either dtype
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Each addressing maps CTA row r (batch * heads + head, or slot * heads +
// head) to its valid length and to a Row whose key(c) is the element
// offset of key c's head_dim elements in the K (and V) tensor.
//
// Contiguous cache: key c of (b, h) at b*sb + h*sh + c*ss; its scale (an
// int8 cache) at b * heads + h, the CTA row itself.
struct Contig {
  long long sb, sh, ss;
  int heads, max_seq;
  const int* length;   // one int32 on the device
  struct Row {
    long long base, ss;
    int row;
    __device__ long long key(int c) const { return base + c * ss; }
    __device__ long long scale_at(int) const { return row; }
  };
  __device__ int len(int) const { return min(max(*length, 0), max_seq); }
  __device__ Row at(int r) const {
    const int b = r / heads;
    return Row{b * sb + (r - b * heads) * sh, ss, r};
  }
};

// Paged pool: key c of (s, h) at pool page tables[s, c / page_size], head
// h, offset c % page_size; its scale (an int8 pool) at that page * heads +
// h.
struct Paged {
  const int* tables;    // [slots, max_pages]
  const int* lengths;   // [slots]
  int heads, page_size, max_pages, head_dim;
  struct Row {
    const int* table;   // the slot's table row
    long long head_off, page_stride;
    int page_size, head_dim, h, heads;
    __device__ long long key(int c) const {
      return table[c / page_size] * page_stride + head_off +
             (long long)(c % page_size) * head_dim;
    }
    __device__ long long scale_at(int c) const {
      return (long long)table[c / page_size] * heads + h;
    }
  };
  __device__ int len(int r) const {
    return min(max(lengths[r / heads], 0), max_pages * page_size);
  }
  __device__ Row at(int r) const {
    const int s = r / heads, h = r - s * heads;
    const long long page = (long long)page_size * head_dim;
    return Row{tables + (long long)s * max_pages, h * page, heads * page, page_size,
               head_dim, h, heads};
  }
};

template <typename Addr>
struct Args {
  const void* q;       // [rows / heads, heads, D]: (q_s0, q_s1, 1) strides
  long long q_s0, q_s1;
  const void* k;
  const void* v;
  const float* k_scale;  // int8 caches only: where Row::scale_at points
  const float* v_scale;
  void* out;           // [rows, D] contiguous
  int heads;
  float scale;
  Addr addr;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum over an aligned group of G lanes (G a power of two <= 32); every
// lane of the warp must call it
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, typename KV, int D, typename Addr>
__global__ void __launch_bounds__(THREADS) decode_kernel(const Args<Addr> a) {
  // int8 storage: dequantize each key and value as it is read
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  static_assert(QUANT || std::is_same<KV, T>::value,
                "a float cache shares the type of q and the output");
  constexpr int VEC = Vec16<KV>::N;           // elements per 16-byte load
  constexpr int NVD = D / VEC;                // 16-byte chunks per row
  // scores: TPK threads per key, each owning NV chunks of the row
  constexpr int TPK = NVD < 32 ? NVD : 32;
  constexpr int NV = NVD / TPK;
  constexpr int KPP = THREADS / TPK;          // keys per pass of the CTA
  // PV: thread = (key split, column chunk)
  static_assert(THREADS % NVD == 0, "PV: whole rows of column chunks");
  constexpr int NSPLIT = THREADS / NVD;
  static_assert(D % VEC == 0 && (TPK & (TPK - 1)) == 0, "head_dim tiling");

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const KV* __restrict__ k = static_cast<const KV*>(a.k);
  const KV* __restrict__ v = static_cast<const KV*>(a.v);
  __shared__ float q_s[D];
  __shared__ float p_s[KC];
  __shared__ float red_m[WARPS], red_s[WARPS];
  __shared__ __align__(16) float part[THREADS * VEC];

  const int len = a.addr.len(row);
  const typename Addr::Row at = a.addr.at(row);
  {
    const int b = row / a.heads, h = row - b * a.heads;
    const T* q = static_cast<const T*>(a.q) + b * a.q_s0 + h * a.q_s1;
    for (int i = tid; i < D; i += THREADS) q_s[i] = to_f(q[i]);
  }
  const int grp = tid / TPK, lig = tid - grp * TPK;    // score group, lane in it
  const int split = tid / NVD, cv = tid - split * NVD; // PV split, column chunk
  float m = NEG_INF, l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < len; c0 += KC) {
    const int nk = min(KC, len - c0);
    __syncthreads();   // q_s written; the last chunk's readers of p_s done
    // 1. scaled scores of keys c0 .. c0 + nk - 1 (nk is uniform, so every
    //    lane of a warp runs the same shuffles)
    for (int cb = 0; cb < nk; cb += KPP * UNROLL) {
      uint4 kv[UNROLL][NV];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = cb + u * KPP + grp;
        if (c < nk) {
          const KV* kr = k + at.key(c0 + c);
#pragma unroll
          for (int j = 0; j < NV; ++j)
            kv[u][j] = *reinterpret_cast<const uint4*>(kr + (lig + j * TPK) * VEC);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = cb + u * KPP + grp;
        float dot = 0.f;
        if (c < nk) {
          const float sk = QUANT ? a.k_scale[at.scale_at(c0 + c)] : 1.f;
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            float kf[VEC];
            Vec16<KV>::unpack(kv[u][j], kf);
            if (QUANT) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) kf[e] *= sk;
            }
            const float* qe = q_s + (lig + j * TPK) * VEC;
#pragma unroll
            for (int e = 0; e < VEC; ++e) dot = fmaf(qe[e], kf[e], dot);
          }
        }
        dot = group_sum<TPK>(dot);
        if (c < nk && lig == 0) p_s[c] = dot * a.scale;
      }
    }
    __syncthreads();
    // 2. online softmax over the chunk
    float mx = NEG_INF;
    for (int c = tid; c < nk; c += THREADS) mx = fmaxf(mx, p_s[c]);
    mx = warp_max(mx);
    if (lane == 0) red_m[warp] = mx;
    __syncthreads();
    mx = red_m[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, red_m[w]);
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
    for (int c = tid; c < nk; c += THREADS) {
      const float p = expf(p_s[c] - m_new);
      sum += p;
      p_s[c] = Round<T>::p(p);
    }
    sum = warp_sum(sum);
    if (lane == 0) red_s[warp] = sum;
    __syncthreads();   // also publishes p_s
    sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red_s[w];
    const float alpha = expf(m - m_new);
    l = alpha * l + sum;
    m = m_new;
    // 3. acc = acc * alpha + P V over this thread's keys and columns
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= alpha;
    for (int cb = split; cb < nk; cb += NSPLIT * UNROLL) {
      uint4 vv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = cb + u * NSPLIT;
        if (c < nk)
          vv[u] = *reinterpret_cast<const uint4*>(v + at.key(c0 + c) + cv * VEC);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = cb + u * NSPLIT;
        if (c < nk) {
          float vf[VEC];
          Vec16<KV>::unpack(vv[u], vf);
          if (QUANT) {
            const float sv = a.v_scale[at.scale_at(c0 + c)];
#pragma unroll
            for (int e = 0; e < VEC; ++e) vf[e] *= sv;
          }
          const float p = p_s[c];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
        }
      }
    }
  }
  // sum the key splits of each column chunk, normalise, write the row
#pragma unroll
  for (int e = 0; e < VEC; ++e) part[tid * VEC + e] = acc[e];
  __syncthreads();
  if (split == 0) {
    for (int j = 1; j < NSPLIT; ++j) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += part[(j * NVD + cv) * VEC + e];
    }
    const float l_safe = l == 0.f ? 1.f : l;
    float o[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = acc[e] / l_safe;
    // a column chunk of an int8 cache is 16 elements: four fp32 vectors
    constexpr int OV = Vec16<T>::N;
    T* dst = static_cast<T*>(a.out) + (long long)row * D + cv * VEC;
#pragma unroll
    for (int j = 0; j < VEC / OV; ++j)
      *reinterpret_cast<uint4*>(dst + j * OV) = Vec16<T>::pack(o + j * OV);
  }
}

template <typename T, typename KV, int D, typename Addr>
int launch(const Args<Addr>& a, long long rows, cudaStream_t stream) {
  decode_kernel<T, KV, D, Addr><<<(unsigned)rows, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename KV, typename Addr>
int dispatch_head_dim(int head_dim, const Args<Addr>& a, long long rows, cudaStream_t s) {
  switch (head_dim) {
    case 16: return launch<T, KV, 16>(a, rows, s);
    case 32: return launch<T, KV, 32>(a, rows, s);
    case 64: return launch<T, KV, 64>(a, rows, s);
    case 128: return launch<T, KV, 128>(a, rows, s);
    case 256: return launch<T, KV, 256>(a, rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Addr>
int run(int device, int dtype, int head_dim, const Args<Addr>& a, long long rows,
        void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || a.heads < 1) return (int)cudaErrorInvalidValue;
  // scales with an int8 cache, and only then
  if ((dtype == 2) != (a.k_scale != nullptr && a.v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_head_dim<float, float>(head_dim, a, rows, s);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16, __nv_bfloat16>(head_dim, a, rows, s);
  if (dtype == 2) return dispatch_head_dim<float, int8_t>(head_dim, a, rows, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// device: the CUDA device index every pointer lives on (this library links
// its own CUDA runtime, whose current device is not PyTorch's).  dtype:
// 0 = float32, 1 = bfloat16, for q, the cache and out alike; 2 = an int8
// cache with fp32 q and out, and fp32 k_scale/v_scale (null for dtypes 0
// and 1); head_dim one of 16, 32, 64, 128, 256.  q: [batch, heads,
// head_dim] with element strides (q_sb, q_sh, 1); out: [batch, heads,
// head_dim], contiguous.  Every returns a cudaError_t (0 on success).
//
// Contiguous cache: k, v [batch, heads, max_seq, head_dim], both with the
// element strides (sb, sh, ss, 1), rows 16-byte aligned; k_scale, v_scale
// [batch, heads] contiguous; length: one int32 on the device, the valid
// positions (clamped to [0, max_seq]).
int decode_attention_forward(int device, int dtype, int head_dim, const void* q,
                             long long q_sb, long long q_sh, const void* k, const void* v,
                             const float* k_scale, const float* v_scale,
                             long long sb, long long sh, long long ss, void* out,
                             const int* length, int batch, int heads, int max_seq,
                             float scale, void* stream) {
  if (batch < 1 || max_seq < 1) return (int)cudaErrorInvalidValue;
  const Args<Contig> a{q, q_sb, q_sh, k, v, k_scale, v_scale, out, heads, scale,
                       Contig{sb, sh, ss, heads, max_seq, length}};
  return run(device, dtype, head_dim, a, (long long)batch * heads, stream);
}

// Paged pool: k_pool, v_pool [num_pages, heads, page_size, head_dim],
// contiguous; k_scale, v_scale [num_pages, heads] contiguous; tables
// [slots, max_pages] int32, contiguous, every entry read a page id below
// num_pages; lengths [slots] int32, the valid positions of each slot
// (clamped to [0, max_pages * page_size]; 0 gives zeros).  q: [slots,
// heads, head_dim] with strides (q_ss, q_sh, 1).
int paged_attention_forward(int device, int dtype, int head_dim, const void* q,
                            long long q_ss, long long q_sh, const void* k_pool,
                            const void* v_pool, const float* k_scale,
                            const float* v_scale, const int* tables, const int* lengths,
                            void* out, int slots, int heads, int page_size, int max_pages,
                            float scale, void* stream) {
  if (slots < 1 || page_size < 1 || max_pages < 1) return (int)cudaErrorInvalidValue;
  const Args<Paged> a{q, q_ss, q_sh, k_pool, v_pool, k_scale, v_scale, out, heads, scale,
                      Paged{tables, lengths, heads, page_size, max_pages, head_dim}};
  return run(device, dtype, head_dim, a, (long long)slots * heads, stream);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
