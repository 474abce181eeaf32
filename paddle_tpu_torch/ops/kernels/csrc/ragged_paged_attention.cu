// Ragged paged attention for Hopper (sm_90a): token-granular causal
// attention for one fused mixed prefill/decode serving step over the
// paged KV pool.
//
// Replaces the TPU kernel _ragged_kernel / _ragged_pallas of
// paddle_tpu/ops/pallas_kernels/ragged_paged_attention.py, and computes
// what it computes: every query token of the step (decode tokens and
// prefill-chunk tokens mixed) attends causally over its own slot's pages,
// driven by the host-built plan of build_ragged_plan (token blocks of 16
// rows, and a work list of (block, pool page, page slot) items).
//
// What bounds it on this card: bytes.  Each (work item, head) reads a K
// and a V page tile of page_size x head_dim -- 64 KiB at the served shape
// (head_dim 128, page 128, bf16) -- and does at most 2 x 16 x 128 x 128
// multiply-adds on it (QK and PV for 16 rows): 16 operations per byte,
// far below the ~295 per byte at which Hopper's tensor cores would become
// the limit; a decode block (one valid row) does 1 per byte.  The design
// therefore spends its effort on the bytes:
//   - one CTA per (token block, head), so each K/V page tile is read from
//     device memory once per block and reused by all 16 rows of the block
//     (a prefill chunk amortises a page over 16 query tokens);
//   - the page is streamed through shared memory in chunks of at most
//     32 KiB (K + V), double-buffered with cp.async so the next chunk's
//     copies are in flight while this one is computed on; a chunk that
//     starts past the block's last query position is never loaded: a
//     decode token at position p reads ceil((p + 1) / chunk) chunks, not
//     whole pages;
//   - rows past blk_rows (the padding of a decode block) are neither
//     scored nor accumulated, and the PV product is spread over all 128
//     threads whatever the number of valid rows (a decode row's keys are
//     split 8 ways and summed at the end);
//   - scores, the online softmax and the PV accumulation run in fp32 in
//     registers and shared memory; nothing but the output goes back to
//     device memory, written straight to each row's flat token index.
// wgmma, TMA and splitting one block's pages over several CTAs (what a
// decode-heavy step needs to fill the card: 8 slots x 16 heads is 128
// CTAs) are left for later work.
//
// The int8 variant (the TPU kernel's quantized=True): int8 pools with one
// fp32 scale per (page, head), q and the output fp32.  The int8 page goes
// through the same cp.async double buffer (a 16-byte copy now carries 16
// elements, so a chunk holds 64 keys of head_dim 128 in 16 KiB + 16 KiB);
// each K and V element is dequantized in fp32 as the chunk is read,
// float(int8) * scale, with the scale of the chunk's work-item page,
// before it meets q or P: the TPU kernel's order (k.astype(f32) * scale
// right after the DMA), rather than folding the K scale into the score.
// P is not rounded before PV, since the TPU kernel's p.astype(v.dtype) is
// fp32 there.  K and V cost one byte per element, half of bf16's.
//
// Where a straight port of the TPU kernel goes wrong, and what this does:
//   - the TPU grid runs the work list in order and carries the online
//     softmax across grid steps; here a CTA finds its own item range by
//     binary search over wl_blk (non-decreasing over the real items), and
//     n_items is read on the device, never copied back to the host;
//   - items at index >= n_items repeat the last real entry and are never
//     visited;
//   - padding rows of a block point at the block's first token: only rows
//     < blk_rows[b] are written;
//   - blocks with blk_rows == 0 are padding and return at once; a fully
//     masked row keeps the finite NEG_INF and the l == 0 guard;
//   - flat tokens that belong to no block (the step's padding tokens) get
//     zeros from one extra column of CTAs, so the output is defined
//     everywhere without a separate memset.
//
// Interface: plain C, loaded through ctypes by
// paddle_tpu_torch/ops/kernels/ragged_paged_attention.py.  The launch
// goes on the caller's stream, allocates nothing and returns the
// cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int QB = 16;               // token-block rows (the port's block)
constexpr int THREADS = 128;         // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr int KV_CHUNK_BYTES = 32768;  // K + V bytes staged per chunk

// PV: each row's 8-element output chunks are spread over 128 / rows2
// threads (rows2 = rows rounded up to a power of two); with more threads
// than chunks a row's keys are split too, and the splits are summed at
// the end.  A decode block (1 row) thus uses all 128 threads.
static_assert(THREADS % QB == 0, "at least one PV thread per row");

// T: the type of q and the output (and of P before PV)
template <typename T> struct Traits;
template <> struct Traits<float> {
  static __device__ float to_f(float x) { return x; }
  static __device__ float from_f(float x) { return x; }
  static __device__ float round_p(float x) { return x; }
};
template <> struct Traits<__nv_bfloat16> {
  static __device__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __nv_bfloat16 from_f(float x) { return __float2bfloat16(x); }
  // the probabilities are cast to the pool dtype before the PV product,
  // as the TPU kernel and the plain version do
  static __device__ float round_p(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// KV: the type the pool stores (T itself, or int8_t); a 16-byte vector
// holds 16 / sizeof(KV) elements, and a shared-memory row is padded by one
// vector
template <typename KV> struct Stage {
  static constexpr int VEC = 16 / (int)sizeof(KV);
  static constexpr int PAD = VEC;
};

template <typename KV, int D>
struct Geometry {
  static constexpr int KC_RAW = KV_CHUNK_BYTES / (2 * D * (int)sizeof(KV));
  // key rows per staged chunk: a power of two in [16, 64]
  static constexpr int KC = KC_RAW >= 64 ? 64 : (KC_RAW >= 32 ? 32 : 16);
  static constexpr int QS = D + 4;                 // q row stride (floats)
  static constexpr int KS = D + Stage<KV>::PAD;    // K/V row stride (KV)
  static constexpr int NDC = D / 8;                // 8-element chunks/row
  // most chunks one thread owns (at THREADS / QB threads per row)
  static constexpr int MAXDC = NDC * QB / THREADS > 1 ? NDC * QB / THREADS
                                                      : 1;
  // q, scores, m/l/alpha, then K and V chunks, each double-buffered
  static constexpr size_t SMEM =
      sizeof(float) * (QB * QS + QB * KC + 3 * QB) +
      sizeof(KV) * 2 * 2 * KC * KS;
  // the K buffers hold the key splits' partial sums at the end
  static_assert(sizeof(KV) * 2 * KC * KS >= sizeof(float) * THREADS * 8,
                "K buffers too small for the PV partial sums");
};

__device__ __forceinline__ void load8(const float* p, float* o) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// eight int8 elements (8 bytes, 8-byte aligned), converted exactly
__device__ __forceinline__ void load8(const int8_t* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[i] = (float)(int)(signed char)((u.x >> (8 * i)) & 0xffu);
    o[4 + i] = (float)(int)(signed char)((u.y >> (8 * i)) & 0xffu);
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// cp.async (sm_80+): 16-byte global -> shared copies that take no
// registers and complete asynchronously, in commit groups
__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// first index w in [lo, hi) with key(w) > blk (strict) or >= blk
__device__ __forceinline__ int search(const int* wl_blk, int lo, int hi,
                                      int blk, bool strict) {
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    int v = wl_blk[mid];
    if (strict ? (v <= blk) : (v < blk)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The launch's arguments, as rpa_forward documents them.
struct Args {
  const void* q;           // [num_tokens, num_heads, D], rows strided
  const void* k_pool;      // [P, num_heads, page_size, D]
  const void* v_pool;
  const float* k_scale;    // [P, num_heads], int8 pools only
  const float* v_scale;
  void* out;               // [num_tokens, num_heads, D], contiguous
  const int* blk_tok;      // the nine plan arrays (RAGGED_PLAN_FIELDS)
  const int* tok_blk;
  const int* tok_row;
  const int* blk_base;
  const int* blk_rows;
  const int* wl_blk;
  const int* wl_page;
  const int* wl_pageslot;
  const int* n_items;
  long long q_row_stride;  // elements between consecutive tokens' q rows
  int num_tokens, num_heads, page_size, nb_max, wl_max;
  float scale;
};

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(THREADS)
ragged_paged_attention_kernel(const Args a) {
  using G = Geometry<KV, D>;
  using TR = Traits<T>;
  // int8 storage: dequantize each element as the staged chunk is read
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  static_assert(QUANT || std::is_same<KV, T>::value,
                "a float pool shares the type of q and the output");
  constexpr int KC = G::KC, QS = G::QS, KS = G::KS;
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const KV* __restrict__ k_pool = static_cast<const KV*>(a.k_pool);
  const KV* __restrict__ v_pool = static_cast<const KV*>(a.v_pool);
  T* __restrict__ out = static_cast<T*>(a.out);
  const int* __restrict__ blk_tok = a.blk_tok;
  const int* __restrict__ wl_blk = a.wl_blk;
  const int* __restrict__ wl_page = a.wl_page;
  const int* __restrict__ wl_pageslot = a.wl_pageslot;
  const int num_heads = a.num_heads, page_size = a.page_size;
  const int nb_max = a.nb_max;
  const int blk = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;

  if (blk == nb_max) {
    // the extra column: zero the rows of flat tokens that no block owns
    for (int t = tid; t < a.num_tokens; t += THREADS) {
      int b = a.tok_blk[t], r = a.tok_row[t];
      bool real = b >= 0 && b < nb_max && r >= 0 && r < QB &&
                  r < a.blk_rows[b] && blk_tok[b * QB + r] == t;
      if (!real) {
        T* o = out + ((size_t)t * num_heads + h) * D;
        for (int d = 0; d < D; ++d) o[d] = TR::from_f(0.f);
      }
    }
    return;
  }
  const int rows = a.blk_rows[blk];
  if (rows <= 0) return;                       // padding block: no items
  const int base = a.blk_base[blk];
  const int max_pos = base + rows - 1;         // last query position
  const int n = min(a.n_items[0], a.wl_max);
  const int w0 = search(wl_blk, 0, n, blk, false);
  const int w1 = search(wl_blk, w0, n, blk, true);

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);          // [QB][QS]
  float* s_s = q_s + QB * QS;                            // [QB][KC]
  float* m_s = s_s + QB * KC;                            // [QB]
  float* l_s = m_s + QB;                                 // [QB]
  float* a_s = l_s + QB;                                 // [QB] rescale
  KV* k_s = reinterpret_cast<KV*>(a_s + QB);             // [2][KC][KS]
  KV* v_s = k_s + 2 * KC * KS;                           // [2][KC][KS]
  constexpr int VEC = Stage<KV>::VEC;
  constexpr int VPR = D / VEC;                 // 16-byte vectors per row

  // stage chunk (item w, key rows c0..) into buffer buf: one commit group
  auto stage = [&](int w, int c0, int buf) {
    const int nk = min(KC, page_size - c0);
    const size_t src =
        (((size_t)wl_page[w] * num_heads + h) * page_size + c0) * D;
    KV* kd = k_s + buf * KC * KS;
    KV* vd = v_s + buf * KC * KS;
#pragma unroll
    for (int j = 0; j < (KC * VPR + THREADS - 1) / THREADS; ++j) {
      const int i = tid + j * THREADS;
      const int rr = i / VPR, cv = i - rr * VPR;
      if (rr < nk) {
        cp_async16(kd + rr * KS + cv * VEC,
                   k_pool + src + (size_t)rr * D + cv * VEC);
        cp_async16(vd + rr * KS + cv * VEC,
                   v_pool + src + (size_t)rr * D + cv * VEC);
      }
    }
    cp_async_commit();
  };
  // the chunk after (w, c0): the rest of this page up to the block's last
  // query position (later keys are masked for every row), then the next
  // work item
  auto advance = [&](int& w, int& c0) {
    c0 += KC;
    if (c0 >= page_size || wl_pageslot[w] * page_size + c0 > max_pos) {
      ++w;
      c0 = 0;
    }
  };

  int w = w0, c0 = 0, buf = 0;
  if (w < w1) stage(w, 0, 0);
  for (int i = tid; i < rows * D; i += THREADS) {
    int r = i / D, d = i - r * D;
    int t = blk_tok[blk * QB + r];
    q_s[r * QS + d] = TR::to_f(q[t * a.q_row_stride + h * D + d]);
  }
  if (tid < QB) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  // PV ownership: row pr; chunks dc0 + k * tpr (k < ndc); keys
  // c = split, split + nsplit, ... of each staged chunk
  int rows2 = 1;
  while (rows2 < rows) rows2 <<= 1;
  const int tpr = THREADS / rows2;               // threads per row
  const int pr = tid / tpr, pt = tid - pr * tpr;
  const int dc0 = pt % G::NDC, split = pt / G::NDC;
  const int nsplit = tpr > G::NDC ? tpr / G::NDC : 1;   // key splits
  const int ndc = tpr < G::NDC ? G::NDC / tpr : 1;   // chunks per thread
  float acc[8 * G::MAXDC];
#pragma unroll
  for (int i = 0; i < 8 * G::MAXDC; ++i) acc[i] = 0.f;
  const int lane = tid & 31, warp = tid >> 5;
  __syncthreads();

  while (w < w1) {
    // 1. the next chunk's copies go out before this one is used
    int nw = w, nc0 = c0;
    advance(nw, nc0);
    if (nw < w1) {
      stage(nw, nc0, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int pos0 = wl_pageslot[w] * page_size + c0;   // key row 0
    const int nk = min(KC, page_size - c0);
    const KV* kb = k_s + buf * KC * KS;
    const KV* vb = v_s + buf * KC * KS;
    // an int8 chunk's (page, head) scales
    const size_t si = (size_t)wl_page[w] * num_heads + h;
    const float ksc = QUANT ? a.k_scale[si] : 1.f;
    const float vsc = QUANT ? a.v_scale[si] : 1.f;
    // 2. masked scores of the valid rows
    for (int i = tid; i < rows * KC; i += THREADS) {
      int r = i / KC, c = i - r * KC;
      float s = NEG_INF;
      if (c < nk && pos0 + c <= base + r) {
        const float* qr = q_s + r * QS;
        const KV* kr = kb + c * KS;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 8) {
          float kf[8], qf[8];
          load8(kr + d, kf);
          if (QUANT) {
#pragma unroll
            for (int e = 0; e < 8; ++e) kf[e] *= ksc;
          }
          load8(qr + d, qf);
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(qf[e], kf[e], dot);
        }
        s = dot * a.scale;
      }
      s_s[r * KC + c] = s;
    }
    __syncthreads();
    // 3. online softmax, one warp per row
    for (int r = warp; r < rows; r += WARPS) {
      float mx = NEG_INF;
      for (int c = lane; c < nk; c += 32) mx = fmaxf(mx, s_s[r * KC + c]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < nk; c += 32) {
        float p = expf(s_s[r * KC + c] - m_new);
        sum += p;
        s_s[r * KC + c] = TR::round_p(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
      }
    }
    __syncthreads();
    // 4. acc = acc * alpha + P V
    if (pr < rows) {
      const float alpha = a_s[pr];
#pragma unroll
      for (int i = 0; i < 8 * G::MAXDC; ++i) acc[i] *= alpha;
      const float* pr_s = s_s + pr * KC;
      // only the keys this row may see: a masked key has p == 0, but
      // 0 * (stale non-finite V left in a recycled page) would not be 0
      const int c_end = min(nk, base + pr - pos0 + 1);
      for (int c = split; c < c_end; c += nsplit) {
        const float p = pr_s[c];
        const KV* vr = vb + c * KS;
#pragma unroll
        for (int k = 0; k < G::MAXDC; ++k) {
          if (k < ndc) {
            float vf[8];
            load8(vr + (dc0 + k * tpr) * 8, vf);
            if (QUANT) {
#pragma unroll
              for (int e = 0; e < 8; ++e) vf[e] *= vsc;
            }
#pragma unroll
            for (int e = 0; e < 8; ++e)
              acc[k * 8 + e] = fmaf(p, vf[e], acc[k * 8 + e]);
          }
        }
      }
    }
    // the buffer just read is the next iteration's staging target
    __syncthreads();
    w = nw;
    c0 = nc0;
    buf ^= 1;
  }
  // sum a row's key splits (through the now idle K/V buffers), then
  // normalise and write each valid row to its flat token index
  float* part = reinterpret_cast<float*>(k_s);           // [THREADS][8]
  if (nsplit > 1 && pr < rows) {
#pragma unroll
    for (int e = 0; e < 8; ++e) part[tid * 8 + e] = acc[e];
  }
  __syncthreads();
  if (pr < rows && split == 0) {
    if (nsplit > 1) {
      for (int j = 1; j < nsplit; ++j) {
        const float* o = part + (tid + j * G::NDC) * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += o[e];
      }
    }
    const float l = l_s[pr];
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    const int t = blk_tok[blk * QB + pr];
    T* o = out + ((size_t)t * num_heads + h) * D;
#pragma unroll
    for (int k = 0; k < G::MAXDC; ++k) {
      if (k < ndc) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[(dc0 + k * tpr) * 8 + e] = TR::from_f(acc[k * 8 + e] * inv);
      }
    }
  }
}

template <typename T, typename KV, int D>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = Geometry<KV, D>::SMEM;
  auto kernel = ragged_paged_attention_kernel<T, KV, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(a.nb_max + 1, a.num_heads);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int dispatch_head_dim(int head_dim, const Args& a, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, KV, 16>(a, stream);
    case 32: return launch<T, KV, 32>(a, stream);
    case 64: return launch<T, KV, 64>(a, stream);
    case 128: return launch<T, KV, 128>(a, stream);
    case 256: return launch<T, KV, 256>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// device: the CUDA device index every pointer lives on (this library
// links its own CUDA runtime, whose current device is not PyTorch's).
// dtype: 0 = float32, 1 = bfloat16, for q, the pools and out alike; 2 =
// int8 pools with fp32 q and out, and fp32 k_scale/v_scale [P, num_heads]
// (null for dtypes 0 and 1).  q: [num_tokens, num_heads, head_dim]
// with heads and elements contiguous and q_row_stride elements between
// tokens (3 x hidden when q is a view into the fused QKV output); out:
// [num_tokens, num_heads, head_dim], contiguous; k_pool, v_pool: [P,
// num_heads, page_size, head_dim]; the plan arrays are int32 as
// RAGGED_PLAN_FIELDS documents.  Returns a cudaError_t (0 on success).
int rpa_forward(int device, int dtype, const void* q, const void* k_pool,
                const void* v_pool, const float* k_scale,
                const float* v_scale, void* out, const int* blk_tok,
                const int* tok_blk, const int* tok_row, const int* blk_base,
                const int* blk_rows, const int* wl_blk, const int* wl_page,
                const int* wl_pageslot, const int* n_items,
                long long q_row_stride, int num_tokens, int num_heads,
                int head_dim, int page_size, int token_block, int nb_max,
                int wl_max, float scale, void* stream) {
  if (token_block != QB || page_size < 16 || page_size > 128 ||
      page_size % 16 != 0 || num_tokens < 1 || num_heads < 1 ||
      num_heads > 65535 || nb_max < 1 || wl_max < 1 ||
      q_row_stride < (long long)num_heads * head_dim ||
      (dtype == 2) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Args a{q, k_pool, v_pool, k_scale, v_scale, out, blk_tok, tok_blk, tok_row, blk_base,
               blk_rows, wl_blk, wl_page, wl_pageslot, n_items, q_row_stride,
               num_tokens, num_heads, page_size, nb_max, wl_max, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_head_dim<float, float>(head_dim, a, s);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16, __nv_bfloat16>(head_dim, a, s);
  if (dtype == 2) return dispatch_head_dim<float, int8_t>(head_dim, a, s);
  return (int)cudaErrorInvalidValue;
}

const char* rpa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
