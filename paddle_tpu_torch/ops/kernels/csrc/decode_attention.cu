// Single-query decode attention for Hopper (sm_90a): one new query per
// (batch, head) over a contiguous KV cache, and one per (slot, head) over
// that slot's pages of the paged KV pool, by one split-and-merge kernel.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas_kernels/:
//   - decode_attention.py: _decode_kernel / _decode_pallas (contiguous
//     [B, H, max_seq, D] cache, one scalar length);
//   - paged_attention.py: _paged_kernel / _paged_pallas ([P, H, page_size,
//     D] pool, [S, max_pages] page tables, [S] lengths);
// and computes what they compute: scores q.k * scale in fp32, a softmax
// over the valid keys 0..length-1 with an fp32 max, denominator and
// accumulator, P rounded to the cache dtype before the PV product
// (p.astype(v.dtype)) while the denominator sums the unrounded P, O =
// acc / l with the l == 0 guard, so a length-0 row writes zeros.  fp32
// caches are computed in plain fp32 FMA (no TF32).
//
// The int8 variants (the TPU kernels' quantized=True): an int8 cache or
// pool with one fp32 scale per (batch, head) or per (page, head), q and
// the output fp32.  Each key and value is dequantized as it is read,
// float(int8) * scale, before it meets q or P (the TPU kernels' order:
// k.astype(f32) * scale right after the DMA); P stays unrounded, since
// the TPU kernel's p.astype(v.dtype) is fp32 there.  K and V then cost one
// byte per element, half of bf16's, plus 4 bytes per scale.
//
// What bounds both on this card: bytes.  A decode row reads K and V of
// its valid positions once and does 2 x head_dim multiply-adds per key
// and element pair it reads: one operation per byte in bf16, far below
// the ~295 per byte at which Hopper's compute would be the limit.  At the
// generated shape (8 x 16 heads, head_dim 128, bf16, 264 positions) that
// is 17.3 MB, about 5.2 us at 3.35 TB/s.  Keys at or past the length are
// never read (the Pallas kernel's "decode at position p reads O(p)
// cache"), which also keeps a stale or non-finite value in a recycled
// cache position or page away from the output, where the plain version's
// 0 x NaN would not; the length is read from device memory, so a decode
// step needs no host sync.
//
// The design (decode_split_kernel, flash-decoding): the keys of each row
// -- a (batch, head) of the cache, a (slot, head) of the pool -- are split
// over CTAs.  A CTA takes KS keys (Split::KS: K and V of the split fill at
// most 32 KiB of shared memory, 64 keys at head_dim 128 in bf16) and puts
// all of its K and V in flight at once with cp.async, K and V as two
// commit groups, before any arithmetic: at the generated shape 5 live
// CTAs of 128 threads a row, 640 in all, ~5 an SM, so an SM has ~160 KB
// in flight.  The grid is rows x ceil(capacity / KS), the capacity being
// max_seq or max_pages * page_size, sized on the host; each CTA reads its
// row's length on the device and one whose keys start at or past it exits
// at once.  Scores: a group of threads per key, 16-byte reads of shared
// memory, a shuffle sum per group; the split's max and denominator by
// every warp alike (no CTA-wide reduction); PV: threads over 16-byte
// column chunks of V rows and the keys split over the rest of the CTA,
// summed in a fixed order.  Each CTA writes a partial (m, l, acc[D]) in
// fp32; the last CTA of a row to finish -- found by an atomic ticket,
// which it resets to 0 itself -- merges the row's partials in split order
// (never in order of arrival, so two runs give the same bits):
// O = sum_s e^(m_s - m) acc_s / sum_s e^(m_s - m) l_s.  Every CTA of a row
// counts the row's live splits from the row's own length, so the ticket
// count is that of the CTAs that take one.  P is rounded against each
// split's own max.  A row with one live split writes its output straight
// away.  One launch: no combine kernel.  The partials and tickets are a
// workspace the wrapper allocates (zeroed tickets), cached per device and
// stream; the kernel allocates nothing.
//
// The two addressings (the template's Addr) differ only in where a key
// lies.  Contig: key c of (b, h) at b * sb + h * sh + c * ss, one length
// for every row, its scale at [b * heads + h].  Paged: key c of (s, h) at
// pool page tables[s, c / page_size], head h, offset c % page_size, the
// slot's own length.  Before its loads a paged CTA reads the table
// entries of the pages its live keys touch, one thread a page, each once
// (one entry when KS divides page_size), and turns them into each key's
// offset, so its copies do not wait on table reads page by page; entries
// past the length are never read, so a stale entry naming a page outside
// the pool is never followed.  An int8 pool's two scales of each of those
// pages ride in shared memory beside K, copied in K's commit group.  T is
// the type of q and the output, KV the type the cache stores (T itself,
// or int8_t).
//
// Interface: plain C, loaded through ctypes by
// paddle_tpu_torch/ops/kernels/decode_attention.py and paged_attention.py.
// Launches go on the caller's stream, allocate nothing and return the
// cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "device_guard.cuh"
#include "vec16.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int SPLIT_THREADS = 128;   // 4 warps a CTA

template <typename T> struct Round;
template <> struct Round<float> {
  static __device__ float p(float x) { return x; }
};
// the probabilities are cast to the cache dtype before the PV product
template <> struct Round<__nv_bfloat16> {
  static __device__ float p(float x) { return __bfloat162float(__float2bfloat16(x)); }
};

// to fp32, for a q element of either dtype, and back for an output
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

// sum over an aligned group of G lanes (G a power of two <= 32); every
// lane of the warp must call it
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// keys one CTA takes: K and V of the split fill at most 32 KiB of shared
// memory before their rows are padded, between 16 and 128 keys (a power
// of two).
// ops/kernels/decode_attention.py's keys_per_split says the same.
template <typename KV, int D>
struct Split {
  static constexpr int RAW = 16384 / (D * (int)sizeof(KV));
  static constexpr int KS = RAW >= 128 ? 128 : RAW >= 64 ? 64 : RAW >= 32 ? 32 : 16;
};

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src)
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

// a 16-byte vector of K or V as fp32; int8 exactly, each byte biased by
// 128 and permuted into the low mantissa byte of 2^23, then 2^23 + 128
// taken off (two full-rate instructions where a conversion instruction
// runs at an eighth of the FMA rate)
template <typename KV>
__device__ __forceinline__ void unpack_kv(const uint4& u, float* f) {
  Vec16<KV>::unpack(u, f);
}
template <>
__device__ __forceinline__ void unpack_kv<int8_t>(const uint4& u, float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned x = w[j] ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[4 * j + i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u + i)) - 8388736.f;
  }
}

// the ticket: an atomic add at GPU scope that releases this CTA's writes
// (made before a __syncthreads) and acquires those of the CTAs that
// took the ticket before it (read after a __syncthreads)
__device__ __forceinline__ int ticket_add(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// The contiguous cache [batch, heads, max_seq, D] with element strides
// (sb, sh, ss, 1); one length for every row.
struct Contig {
  const int* length;   // one int32 on the device
  long long sb, sh, ss;
  int max_seq;
  __device__ int len(int) const { return min(max(*length, 0), max_seq); }
};

// The paged pool [pages, heads, page_size, D], contiguous: key c of slot
// s at page tables[s, c / page_size], offset c % page_size; each slot's
// own length.
struct Paged {
  const int* tables;   // [slots, max_pages]
  const int* lengths;  // [slots]
  int page_size, max_pages;
  __device__ int len(int s) const {
    return min(max(lengths[s], 0), max_pages * page_size);
  }
};

// The launch's arguments, as decode_attention_forward and
// paged_attention_forward document them.
template <typename Addr>
struct SplitArgs {
  const void* q;       // [rows / heads, heads, D]: (q_s0, q_s1, 1) strides
  long long q_s0, q_s1;
  const void* k;       // the cache or the pool
  const void* v;
  const float* k_scale;  // int8 only: [batch, heads] or [pages, heads]
  const float* v_scale;
  void* out;           // [rows, D] contiguous
  float* ws;           // [rows, nsplit, D] partial sums, then [rows, nsplit, 2] (m, l)
  int* tickets;        // [rows], 0 between launches
  long long rows;      // batch (or slots) * heads
  int heads, nsplit;
  float scale;
  Addr addr;
};

template <typename T, typename KV, int D, typename Addr>
__global__ void __launch_bounds__(SPLIT_THREADS) decode_split_kernel(const SplitArgs<Addr> a) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr bool PAGED = std::is_same<Addr, Paged>::value;
  static_assert(QUANT || std::is_same<KV, T>::value,
                "a float cache shares the type of q and the output");
  constexpr int NT = SPLIT_THREADS;
  constexpr int KS = Split<KV, D>::KS;
  constexpr int VEC = Vec16<KV>::N;           // elements per 16-byte load
  constexpr int NVD = D / VEC;                // 16-byte chunks per row
  // a K/V row of the staged tile is padded by one 16-byte vector, so the
  // rows that neighbouring lanes read start in different banks
  constexpr int KP = D + VEC;
  // scores: TPK lanes per key, so the split's keys take one pass of the
  // CTA; each lane owns NV of the row's chunks
  constexpr int TPK = NT / KS;
  constexpr int NV = NVD / TPK;
  // PV: thread = (key group, column chunk); threads past NG * NVD idle
  constexpr int NG = NT / NVD;
  static_assert(D % VEC == 0 && NG >= 1 && TPK >= 1 && NVD % TPK == 0,
                "head_dim tiling");
  static_assert(KS <= NT, "paged: a thread a key, and so a page, of the split");
  // shared memory: K and V of the split, q (fp32), the scores, then the
  // key groups' partial sums (over K, once K is no longer read, when they
  // fit there); paged: each key's offset in the pool and, int8, the
  // scales of the split's pages and each key's page among them
  constexpr int TILE = KS * KP * (int)sizeof(KV);
  constexpr int PART = NG * D * 4;
  constexpr int Q_AT = 2 * TILE, S_AT = Q_AT + D * 4;
  constexpr int PART_AT = PART <= TILE ? 0 : S_AT + KS * 4;
  constexpr int OFF_AT = S_AT + KS * 4 + (PART <= TILE ? 0 : PART);
  constexpr int SC_AT = OFF_AT + (PAGED ? KS * 8 : 0);
  constexpr int PJ_AT = SC_AT + (PAGED && QUANT ? 2 * KS * 4 : 0);
  constexpr int SMEM = PJ_AT + (PAGED && QUANT ? KS : 0);
  __shared__ __align__(16) unsigned char smem[SMEM];
  __shared__ int last;
  KV* k_s = reinterpret_cast<KV*>(smem);
  KV* v_s = reinterpret_cast<KV*>(smem + TILE);
  float* q_s = reinterpret_cast<float*>(smem + Q_AT);
  float* s_s = reinterpret_cast<float*>(smem + S_AT);
  float* part = reinterpret_cast<float*>(smem + PART_AT);
  long long* off_s = reinterpret_cast<long long*>(smem + OFF_AT);
  float* ksc_s = reinterpret_cast<float*>(smem + SC_AT);
  float* vsc_s = ksc_s + KS;
  unsigned char* pj_s = smem + PJ_AT;

  const long long row = blockIdx.x;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  T* out = static_cast<T*>(a.out) + row * D;
  const int b = (int)(row / a.heads), h = (int)(row - (long long)b * a.heads);
  const int len = a.addr.len(b);
  if (len == 0) {                      // a length-0 row writes zeros
    if (split == 0)
      for (int i = tid; i < D; i += NT) out[i] = from_f<T>(0.f);
    return;
  }
  const int c0 = split * KS;
  if (c0 >= len) return;               // every key of this split is past the length
  const int nk = min(KS, len - c0);
  const int nlive = (len + KS - 1) / KS;

  // 1. where key c0 + r of the split lies: its element offset in the
  //    cache or the pool
  long long base = 0;
  if constexpr (PAGED) {
    // the table entries of the pages the live keys touch (np <= nk <= NT),
    // one thread a page, into K's tile before its copies; an int8 pool's
    // scales of those pages copied beside them, in K's commit group
    const int ps = a.addr.page_size;
    const int p0 = c0 / ps, np = (c0 + nk - 1) / ps - p0 + 1;
    int* pg_s = reinterpret_cast<int*>(smem);
    if (tid < np) {
      const int pg = a.addr.tables[(long long)b * a.addr.max_pages + p0 + tid];
      pg_s[tid] = pg;
      if constexpr (QUANT) {
        cp_async4(ksc_s + tid, a.k_scale + (long long)pg * a.heads + h);
        cp_async4(vsc_s + tid, a.v_scale + (long long)pg * a.heads + h);
      }
    }
    __syncthreads();                   // the split's pages in place
    if (tid < nk) {
      const int j = (c0 - p0 * ps + tid) / ps;   // the key's page in the split
      off_s[tid] = ((long long)pg_s[j] * a.heads + h) * ps * D +
                   (long long)(c0 + tid - (p0 + j) * ps) * D;
      if constexpr (QUANT) pj_s[tid] = (unsigned char)j;
    }
    __syncthreads();                   // offsets in place; K's tile free again
  } else {
    base = b * a.addr.sb + h * a.addr.sh + c0 * a.addr.ss;
  }
  const auto key_at = [&](int r) -> long long {
    if constexpr (PAGED) {
      return off_s[r];
    } else {
      return base + r * a.addr.ss;
    }
  };

  // 2. all of the split's K, then all of its V, in flight before any
  //    arithmetic: two commit groups
  {
    const KV* kg = static_cast<const KV*>(a.k);
    const KV* vg = static_cast<const KV*>(a.v);
    for (int i = tid; i < nk * NVD; i += NT) {
      const int r = i / NVD, c = i - r * NVD;
      cp_async16(k_s + r * KP + c * VEC, kg + key_at(r) + c * VEC);
    }
    cp_async_commit();
    for (int i = tid; i < nk * NVD; i += NT) {
      const int r = i / NVD, c = i - r * NVD;
      cp_async16(v_s + r * KP + c * VEC, vg + key_at(r) + c * VEC);
    }
    cp_async_commit();
  }
  // q, as fp32, while the copies fly
  {
    const T* q = static_cast<const T*>(a.q) + b * a.q_s0 + h * a.q_s1;
    for (int i = tid; i < D; i += NT) q_s[i] = to_f(q[i]);
  }
  cp_async_wait<1>();
  __syncthreads();                     // K and q in place

  // 3. scaled scores: key c = tid / TPK; each lane sums its chunks one
  //    by one, adds the chunks' sums pairwise, and the TPK lanes are
  //    summed by shuffles (no long serial chain: fp32 error stays at the
  //    size of a 16-term sum)
  {
    const int c = tid / TPK, lig = tid - c * TPK;
    float sk = 1.f;
    if constexpr (QUANT) {
      if constexpr (PAGED) {
        sk = c < nk ? ksc_s[pj_s[c]] : 1.f;
      } else {
        sk = a.k_scale[row];
      }
    }
    float dot = 0.f;
    if (c < nk) {
      float cs[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int e0 = (lig + j * TPK) * VEC;
        float kf[VEC];
        unpack_kv<KV>(*reinterpret_cast<const uint4*>(k_s + c * KP + e0), kf);
        float t = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) t = fmaf(q_s[e0 + e], QUANT ? kf[e] * sk : kf[e], t);
        cs[j] = t;
      }
#pragma unroll
      for (int w = 1; w < NV; w *= 2)
#pragma unroll
        for (int j = 0; j + w < NV; j += 2 * w) cs[j] += cs[j + w];
      dot = cs[0];
    }
    dot = group_sum<TPK>(dot);
    if (c < nk && lig == 0) s_s[c] = dot * a.scale;
  }
  __syncthreads();                     // scores in place; K no longer read

  // 4. the split's max and denominator (the unrounded P), each warp for
  //    itself: the same sums in the same order, so the same bits
  float m = NEG_INF;
  for (int c = lane; c < nk; c += 32) m = fmaxf(m, s_s[c]);
  m = warp_max(m);
  float l = 0.f;
  for (int c = lane; c < nk; c += 32) l += expf(s_s[c] - m);
  l = warp_sum(l);

  // 5. P V: P rounded to the cache dtype against the split's max
  cp_async_wait<0>();
  __syncthreads();                     // V in place
  const int g = tid / NVD, cv = tid - g * NVD;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  if (g < NG) {
    float sv = 1.f;
    if constexpr (QUANT && !PAGED) sv = a.v_scale[row];
#pragma unroll 4
    for (int c = g; c < nk; c += NG) {
      if constexpr (QUANT && PAGED) sv = vsc_s[pj_s[c]];
      const float p = Round<T>::p(expf(s_s[c] - m));
      float vf[VEC];
      unpack_kv<KV>(*reinterpret_cast<const uint4*>(v_s + c * KP + cv * VEC), vf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(p, QUANT ? vf[e] * sv : vf[e], acc[e]);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) part[(g * NVD + cv) * VEC + e] = acc[e];
  }
  __syncthreads();
  // the key groups of each column chunk summed in group order
  if (tid < NVD) {
    for (int j = 1; j < NG; ++j) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += part[(j * NVD + tid) * VEC + e];
    }
  }

  // 6. one live split: the output straight away
  if (nlive == 1) {
    if (tid < NVD) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[tid * VEC + e] = from_f<T>(acc[e] / l);
    }
    return;
  }
  // 7. else the partial (m, l, acc) into the workspace; the last CTA of
  //    the row to arrive merges the row's partials in split order
  float* const ws_ml = a.ws + a.rows * a.nsplit * D + row * a.nsplit * 2;
  float* const ws_o = a.ws + row * a.nsplit * D;
  if (tid < NVD) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) ws_o[split * D + tid * VEC + e] = acc[e];
  }
  if (tid == 0) {
    ws_ml[2 * split] = m;
    ws_ml[2 * split + 1] = l;
  }
  __syncthreads();
  if (tid == 0) {
    last = ticket_add(a.tickets + row) == nlive - 1;
    if (last) a.tickets[row] = 0;      // every other split has arrived
  }
  __syncthreads();
  if (!last) return;
  // the row's partials read MB splits at a time, all loads of a batch out
  // together, and summed in split order against the running max (one
  // batch, and so one read, at up to MB splits)
  constexpr int MB = 8;
  for (int d = tid; d < D; d += NT) {
    float mx = NEG_INF, o = 0.f, den = 0.f;
    for (int s0 = 0; s0 < nlive; s0 += MB) {
      float mv[MB], lv[MB], ov[MB];
#pragma unroll
      for (int j = 0; j < MB; ++j) {
        const bool ok = s0 + j < nlive;
        mv[j] = ok ? __ldcg(ws_ml + 2 * (s0 + j)) : NEG_INF;
        lv[j] = ok ? __ldcg(ws_ml + 2 * (s0 + j) + 1) : 0.f;
        ov[j] = ok ? __ldcg(ws_o + (s0 + j) * D + d) : 0.f;
      }
      float m_new = mx;
#pragma unroll
      for (int j = 0; j < MB; ++j) m_new = fmaxf(m_new, mv[j]);
      const float alpha = expf(mx - m_new);
      den *= alpha;
      o *= alpha;
#pragma unroll
      for (int j = 0; j < MB; ++j) {
        if (s0 + j < nlive) {
          const float w = expf(mv[j] - m_new);
          den = fmaf(w, lv[j], den);
          o = fmaf(w, ov[j], o);
        }
      }
      mx = m_new;
    }
    out[d] = from_f<T>(o / (den == 0.f ? 1.f : den));
  }
}

template <typename T, typename KV, int D, typename Addr>
int launch_split(const SplitArgs<Addr>& a, long long capacity, int keys_per_split,
                 cudaStream_t stream) {
  // the wrapper sizes the grid and the workspace from the same split
  if (keys_per_split != Split<KV, D>::KS ||
      a.nsplit != (capacity + keys_per_split - 1) / keys_per_split || a.nsplit > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)a.rows, (unsigned)a.nsplit);
  decode_split_kernel<T, KV, D, Addr><<<grid, SPLIT_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename KV, typename Addr>
int dispatch_split(int head_dim, const SplitArgs<Addr>& a, long long capacity, int ks,
                   cudaStream_t s) {
  switch (head_dim) {
    case 16: return launch_split<T, KV, 16>(a, capacity, ks, s);
    case 32: return launch_split<T, KV, 32>(a, capacity, ks, s);
    case 64: return launch_split<T, KV, 64>(a, capacity, ks, s);
    case 128: return launch_split<T, KV, 128>(a, capacity, ks, s);
    case 192: return launch_split<T, KV, 192>(a, capacity, ks, s);
    case 256: return launch_split<T, KV, 256>(a, capacity, ks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Addr>
int run_split(int device, int dtype, int head_dim, const SplitArgs<Addr>& a,
              long long capacity, int keys_per_split, void* stream) {
  if (a.rows < 1 || a.rows > 0x7fffffffLL || a.heads < 1 || capacity < 1 ||
      keys_per_split < 1 || a.ws == nullptr || a.tickets == nullptr)
    return (int)cudaErrorInvalidValue;
  // scales with an int8 cache, and only then
  if ((dtype == 2) != (a.k_scale != nullptr && a.v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  cudaError_t e = guard.err;
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_split<float, float>(head_dim, a, capacity, keys_per_split, s);
  if (dtype == 1)
    return dispatch_split<__nv_bfloat16, __nv_bfloat16>(head_dim, a, capacity,
                                                        keys_per_split, s);
  if (dtype == 2) return dispatch_split<float, int8_t>(head_dim, a, capacity, keys_per_split, s);
  return (int)cudaErrorInvalidValue;
}

// what a launch runs: static shared memory per CTA, registers per thread,
// CTAs resident per SM, threads per CTA, local memory per thread, keys
// per split
template <typename T, typename KV, int D, typename Addr>
int info_split(int* info) {
  auto fn = decode_split_kernel<T, KV, D, Addr>;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  int ctas = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, SPLIT_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  info[0] = (int)attr.sharedSizeBytes;
  info[1] = attr.numRegs;
  info[2] = ctas;
  info[3] = SPLIT_THREADS;
  info[4] = (int)attr.localSizeBytes;
  info[5] = Split<KV, D>::KS;
  return 0;
}

template <typename T, typename KV, typename Addr>
int info_head_dim(int head_dim, int* info) {
  switch (head_dim) {
    case 16: return info_split<T, KV, 16, Addr>(info);
    case 32: return info_split<T, KV, 32, Addr>(info);
    case 64: return info_split<T, KV, 64, Addr>(info);
    case 128: return info_split<T, KV, 128, Addr>(info);
    case 192: return info_split<T, KV, 192, Addr>(info);
    case 256: return info_split<T, KV, 256, Addr>(info);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Addr>
int kernel_info(int device, int dtype, int head_dim, int* info) {
  const DeviceGuard guard(device);
  cudaError_t e = guard.err;
  if (e != cudaSuccess) return (int)e;
  if (dtype == 0) return info_head_dim<float, float, Addr>(head_dim, info);
  if (dtype == 1) return info_head_dim<__nv_bfloat16, __nv_bfloat16, Addr>(head_dim, info);
  if (dtype == 2) return info_head_dim<float, int8_t, Addr>(head_dim, info);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// device: the CUDA device index every pointer lives on (this library links
// its own CUDA runtime, whose current device is not PyTorch's).  dtype:
// 0 = float32, 1 = bfloat16, for q, the cache and out alike; 2 = an int8
// cache with fp32 q and out, and fp32 k_scale/v_scale (null for dtypes 0
// and 1).  head_dim: one of 16, 32, 64, 128, 192, 256.  out: [rows / heads,
// heads, head_dim], contiguous.  keys_per_split: the keys one CTA takes
// (the kernel's own Split::KS, which the wrappers compute alike);
// num_splits = ceil(capacity / keys_per_split), the capacity being
// max_seq or max_pages * page_size; workspace: rows * num_splits *
// (head_dim + 2) fp32; tickets: rows int32, all 0 (the kernel leaves them
// 0).  Launches on one stream may share a workspace; launches that may run
// at the same time may not.  Each returns a cudaError_t (0 on success).
//
// Contiguous cache: q [batch, heads, head_dim] with element strides (q_sb,
// q_sh, 1); k, v [batch, heads, max_seq, head_dim], both with the element
// strides (sb, sh, ss, 1), rows 16-byte aligned; k_scale, v_scale [batch,
// heads] contiguous; length: one int32 on the device, the valid positions
// (clamped to [0, max_seq]).
int decode_attention_forward(int device, int dtype, int head_dim, const void* q,
                             long long q_sb, long long q_sh, const void* k, const void* v,
                             const float* k_scale, const float* v_scale,
                             long long sb, long long sh, long long ss, void* out,
                             const int* length, int batch, int heads, int max_seq,
                             float scale, int keys_per_split, int num_splits,
                             float* workspace, int* tickets, void* stream) {
  if (batch < 1 || max_seq < 1) return (int)cudaErrorInvalidValue;
  const SplitArgs<Contig> a{q, q_sb, q_sh, k, v, k_scale, v_scale, out, workspace, tickets,
                            (long long)batch * heads, heads, num_splits, scale,
                            Contig{length, sb, sh, ss, max_seq}};
  return run_split(device, dtype, head_dim, a, max_seq, keys_per_split, stream);
}

// Paged pool: q [slots, heads, head_dim] with element strides (q_ss, q_sh,
// 1); k_pool, v_pool [num_pages, heads, page_size, head_dim], contiguous;
// k_scale, v_scale [num_pages, heads] contiguous; tables [slots,
// max_pages] int32, contiguous, every entry of a page below a slot's
// length a page id below num_pages (entries past it are never read);
// lengths [slots] int32, the valid positions of each slot (clamped to [0,
// max_pages * page_size]; 0 gives zeros).
int paged_attention_forward(int device, int dtype, int head_dim, const void* q,
                            long long q_ss, long long q_sh, const void* k_pool,
                            const void* v_pool, const float* k_scale,
                            const float* v_scale, const int* tables, const int* lengths,
                            void* out, int slots, int heads, int page_size, int max_pages,
                            float scale, int keys_per_split, int num_splits,
                            float* workspace, int* tickets, void* stream) {
  const long long capacity = (long long)max_pages * page_size;
  if (slots < 1 || page_size < 1 || max_pages < 1 || capacity > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const SplitArgs<Paged> a{q, q_ss, q_sh, k_pool, v_pool, k_scale, v_scale, out, workspace,
                           tickets, (long long)slots * heads, heads, num_splits, scale,
                           Paged{tables, lengths, page_size, max_pages}};
  return run_split(device, dtype, head_dim, a, capacity, keys_per_split, stream);
}

// The contiguous-cache launch of this dtype and head_dim: info[0] static
// shared memory per CTA (bytes), [1] registers per thread, [2] CTAs
// resident per SM, [3] threads per CTA, [4] local memory per thread
// (bytes), [5] keys per split.
int decode_attention_kernel_info(int device, int dtype, int head_dim, int* info) {
  return kernel_info<Contig>(device, dtype, head_dim, info);
}

// The same for the paged launch.
int paged_attention_kernel_info(int device, int dtype, int head_dim, int* info) {
  return kernel_info<Paged>(device, dtype, head_dim, info);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
