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
// the limit; a decode block (one valid row) does 1 per byte.  A
// decode-heavy step has only 8 live blocks: one CTA per (block, head), as
// the first design had, is 128 CTAs walking their pages alone, about one
// SM's worth of bytes in flight each.  The design:
//   - the split unit is a work item's page, cut into splits of KS keys
//     (Geometry::KS: K and V of a split fill at most 32 KiB unpadded, 64
//     keys at head_dim 128 in bf16); one CTA of 4 warps per (split, head),
//     so a decode-heavy step of 8 rows x 4 pages x 16 heads launches ~850
//     live CTAs, several an SM;
//   - each CTA puts the whole split of K and of V in flight at once with
//     cp.async (K and V two commit groups), only the keys up to the
//     block's last query position (max_pos); the rows of the tile past
//     them, up to the next 16, are zero-filled by the copy (src-size 0,
//     nothing read), never left stale;
//   - bf16: S = Q K^T and O = P V on the tensor cores, mma.sync.m16n8k16
//     with bf16 operands and fp32 accumulation -- the MXU's arithmetic of
//     the TPU kernel (_dot, Precision.DEFAULT) -- with ldmatrix from tiles
//     whose rows are padded by 16 bytes (an odd number of 16-byte chunks a
//     row, so the 8 rows one ldmatrix phase reads hit 8 distinct bank
//     groups).  The token block is 16 rows, the M of m16n8k16: a decode
//     block and a 16-row prefill block cost the same tensor-core work, the
//     decode block's spare rows masked and never written.  The warps split
//     S by 16-key column pairs and O by 16-column pairs of head_dim, with
//     the row max and sums exchanged through shared memory and P (rounded
//     to bf16, as p.astype(v.dtype)) staged there between the products.
//     wgmma is left out: it takes 64-row tiles, and a token block has 16;
//   - fp32 and int8 stay on CUDA-core FMAs (no TF32): a group of lanes per
//     (row, key) dot with 16-byte reads of shared memory and a shuffle sum,
//     a warp per row for the softmax, and PV over (row, 8-column chunk,
//     key group) with the groups summed in a fixed order; int8 pages are
//     dequantized as they are read, float(int8) * the (page, head) scale,
//     before they meet q or P (the TPU kernel's order), and P stays
//     unrounded (the TPU kernel's p.astype(v.dtype) is fp32 there);
//   - each CTA writes a partial (m, l, O[rows, D]) in fp32 to a
//     workspace; the last CTA of a (block, head) to finish -- found by an
//     atomic ticket, which it resets to 0 itself -- merges the block's
//     splits in work-list order (never in order of arrival, so two
//     launches give the same bits), O = sum_s e^(m_s - m) O_s / sum_s
//     e^(m_s - m) l_s, and writes each valid row to its flat token index.
//     A block with one split writes straight out.  P is rounded against
//     each split's own max: one bf16 rounding, as against a running max
//     before.
//
// The trap that tensor cores bring: a masked P of exactly 0 still
// multiplies every V row of the tile in an mma, and 0 x NaN is NaN.  So
// no stale row ever reaches the tile: the keys of a split up to max_pos
// are this step's or earlier real keys, and every row past them is
// zero-filled.  Within a prefill block the rows see different prefixes:
// the causal mask goes on S before the row max, and the keys between a
// row's position and max_pos (finite, real) get P = 0.
//
// Where a straight port of the TPU kernel goes wrong, and what this does:
//   - the TPU grid runs the work list in order and carries the online
//     softmax across grid steps; here a CTA finds its block's first split
//     from its item's page slot: build_ragged_plan lists a block's items
//     as its page slots 0, 1, ..., last in order, so the block's first
//     item is w - wl_pageslot[w] and its split count follows from
//     max_pos; n_items is read on the device, never copied to the host;
//   - items at index >= n_items repeat the last real entry and are never
//     visited;
//   - padding rows of a block point at the block's first token: only rows
//     < blk_rows[b] are written;
//   - a row with no visible key in a split keeps m = NEG_INF (finite),
//     l = 0 and O = 0, so it adds nothing to the merge: exp(NEG_INF - m)
//     is 0 beside a row's real max;
//   - flat tokens that belong to no block (the step's padding tokens) get
//     zeros from the grid's first row of CTAs, which runs beside the
//     splits, so the output is defined everywhere without a separate
//     memset.
//
// Interface: plain C, loaded through ctypes by
// paddle_tpu_torch/ops/kernels/ragged_paged_attention.py.  The launch
// goes on the caller's stream, allocates nothing (the workspace and the
// tickets are the caller's) and returns the cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr int QB = 16;               // token-block rows (the port's block)
constexpr int THREADS = 128;         // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;

// T: the type of q and the output; KV: the type the pool stores (T
// itself, or int8_t).  Shared memory, in order: the K tile and the V tile
// [KS][KP], the q tile [QB][QP] (T), the S/P tile, then the row
// reductions.  KP pads a K/V row by one 16-byte vector.
template <typename KV, int D>
struct Geometry {
  static constexpr bool MMA = std::is_same<KV, bf16>::value;
  static constexpr int RAW = 16384 / (D * (int)sizeof(KV));
  // keys a split takes, a power of two in [16, 128]: K and V of a split
  // fill at most 32 KiB before padding, and the FMA path (fp32, int8),
  // whose 16-row blocks are bound by instructions, takes at most 64 so a
  // prefill block's work spreads over more CTAs;
  // ops/kernels/ragged_paged_attention.py's keys_per_split says the same
  static constexpr int KS = MMA && RAW >= 128 ? 128 : RAW >= 64 ? 64 : RAW >= 32 ? 32 : 16;
  static constexpr int VEC = 16 / (int)sizeof(KV);         // elements a 16-byte copy
  static constexpr int NVD = D / VEC;                      // 16-byte chunks a row
  static constexpr int KP = D + VEC;                       // K/V row pitch
  static constexpr int QP = MMA ? D + 8 : D + 4;           // q row pitch (T)
  static constexpr int PP = KS + 8;                        // P row pitch (bf16), mma
  // the unnormalised O tile [QB][OP] fp32 of the epilogue: over the K
  // tile (mma: no longer read once S is taken) or the q tile (FMA)
  static constexpr int OP = MMA ? D + 8 : D + 4;
  static constexpr size_t KV_BYTES = (size_t)KS * KP * sizeof(KV);
  static constexpr size_t Q_BYTES = (size_t)QB * QP * (MMA ? 2 : 4);
  static constexpr size_t S_BYTES = MMA ? (size_t)QB * PP * 2 : (size_t)QB * KS * 4;
  static constexpr size_t RED_AT = 2 * KV_BYTES + Q_BYTES + S_BYTES;
  // red_m, red_l [WARPS][QB], m_s, l_s [QB], the merge flag
  static constexpr size_t RED_BYTES = (2 * WARPS * QB + 2 * QB + 4) * 4;
  // the FMA path's PV key-group sums [THREADS][8]: over the K tile (no
  // longer read by then) when it holds them, else after the reductions
  static constexpr size_t PART_BYTES = (size_t)THREADS * 8 * 4;
  static constexpr bool PART_OWN = !MMA && KV_BYTES < PART_BYTES;
  static constexpr size_t PART_AT = PART_OWN ? RED_AT + RED_BYTES : 0;
  static constexpr size_t SMEM = RED_AT + RED_BYTES + (PART_OWN ? PART_BYTES : 0);
  static_assert((MMA ? KV_BYTES : Q_BYTES) >= (size_t)QB * OP * 4,
                "the O tile must fit where it is put");
  static_assert(D % 16 == 0 && KS % 16 == 0, "16-wide tiles");
  static_assert(KS % (THREADS / QB) == 0, "whole keys a scoring thread");
};

template <typename T> struct Traits;
template <> struct Traits<float> {
  static __device__ float to_f(float x) { return x; }
  static __device__ float from_f(float x) { return x; }
};
template <> struct Traits<bf16> {
  static __device__ float to_f(bf16 x) { return __bfloat162float(x); }
  static __device__ bf16 from_f(float x) { return __float2bfloat16(x); }
};

__device__ __forceinline__ void load8(const float* p, float* o) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// the four signed bytes of w as fp32, exactly: each byte, biased by 128,
// becomes the low mantissa byte of 2^23 (a byte permute), and one add
// takes 2^23 + 128 off -- two full-rate instructions where a conversion
// instruction runs at an eighth of the FMA rate
__device__ __forceinline__ void s8x4(unsigned w, float* o) {
  const unsigned x = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u + i)) - 8388736.f;
}

// eight int8 elements (8 bytes, 8-byte aligned), converted exactly
__device__ __forceinline__ void load8(const int8_t* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  s8x4(u.x, o);
  s8x4(u.y, o + 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async (sm_80+): a 16-byte global -> shared copy that takes no
// registers; with valid false nothing is read and the 16 bytes are zeros
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem_dst)),
               "l"(gmem_src), "r"(valid ? 16 : 0)
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

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8 fp32) += a (16 x 16 bf16, row-major) x b (16 x 8 bf16)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
  float* ws;               // [wl_max * spp, H, QB, D] partial O, then (m, l)
  int* tickets;            // [nb_max, H], 0 between launches
  long long q_row_stride;  // elements between consecutive tokens' q rows
  int num_tokens, num_heads, page_size, nb_max, wl_max, spp;
  float scale;
};

// S = Q K^T and O = P V of one split on the tensor cores (bf16).  On
// return, o_s holds the unnormalised O [QB][OP] and m_s / l_s each row's
// max and sum of the unrounded P over the split; a row with no visible
// key has m = NEG_INF, l = 0 and O = 0.
template <int D, int KS>
__device__ __forceinline__ void split_mma(const bf16* q_s, const bf16* k_s, const bf16* v_s,
                                          bf16* p_s, float* red_m, float* red_l, float* o_s,
                                          float* m_s, float* l_s, int rows, int base,
                                          int pos0, int nk, float scale) {
  using G = Geometry<bf16, D>;
  constexpr int KP = G::KP, QP = G::QP, PP = G::PP, OP = G::OP;
  constexpr int NPS = KS / 16;                    // 16-key column pairs of S
  constexpr int MAXP = (NPS + WARPS - 1) / WARPS;
  constexpr int NPO = D / 16;                     // 16-column pairs of O
  constexpr int MAXO = (NPO + WARPS - 1) / WARPS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int np = (nk + 15) >> 4;                  // pairs with a visible key
  // a key is visible to a row when it lies at or before the row's
  // position; rows past `rows` are block padding
  auto visible = [&](int r, int c) { return r < rows && c < nk && pos0 + c <= base + r; };

  // 1. S over this warp's column pairs: A from the q tile, B = K rows
  float s[MAXP][2][4];
#pragma unroll
  for (int i = 0; i < MAXP; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
  const uint32_t qa = smem_u32(q_s) + (lane & 15) * QP * 2 + (lane >> 4) * 16;
  const uint32_t kb =
      smem_u32(k_s) + ((lane & 7) + (lane >> 4) * 8) * KP * 2 + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm4(af, qa + kk * 32);
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      const int pp = warp + i * WARPS;
      if (pp < np) {
        uint32_t bf[4];
        ldsm4(bf, kb + pp * 16 * KP * 2 + kk * 32);
        mma(s[i][0], af, bf[0], bf[1]);
        mma(s[i][1], af, bf[2], bf[3]);
      }
    }
  }
  // 2. scale, the causal mask before the max, each row's max over the split
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    const int pp = warp + i * WARPS;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + (e >> 1) * 8, c = pp * 16 + j * 8 + 2 * t4 + (e & 1);
        s[i][j][e] = pp < np && visible(r, c) ? s[i][j][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[i][j][e]);
      }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
  }
  if (t4 == 0) {
    red_m[warp * QB + g] = mx[0];
    red_m[warp * QB + g + 8] = mx[1];
  }
  __syncthreads();   // every warp's max; K no longer read
  float m[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    m[hh] = red_m[g + hh * 8];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m[hh] = fmaxf(m[hh], red_m[w * QB + g + hh * 8]);
  }
  // 3. P = exp(S - m) for the visible keys, exactly 0 elsewhere; the row
  //    sums take the unrounded P, the tile the bf16-rounded one
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    const int pp = warp + i * WARPS;
    if (pp < np) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + (e >> 1) * 8, c = pp * 16 + j * 8 + 2 * t4 + (e & 1);
          p[e] = visible(r, c) ? expf(s[i][j][e] - m[e >> 1]) : 0.f;
          ls[e >> 1] += p[e];
        }
        const int c = pp * 16 + j * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(p_s + g * PP + c) = pack_bf16(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(p_s + (g + 8) * PP + c) = pack_bf16(p[2], p[3]);
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    ls[hh] += __shfl_xor_sync(0xffffffffu, ls[hh], 1);
    ls[hh] += __shfl_xor_sync(0xffffffffu, ls[hh], 2);
  }
  if (t4 == 0) {
    red_l[warp * QB + g] = ls[0];
    red_l[warp * QB + g + 8] = ls[1];
  }
  cp_async_wait<0>();
  __syncthreads();   // P, the row sums and V in place
  if (tid < QB) {
    float mm = red_m[tid], ll = red_l[tid];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      mm = fmaxf(mm, red_m[w * QB + tid]);
      ll += red_l[w * QB + tid];
    }
    m_s[tid] = mm;
    l_s[tid] = ll;
  }
  // 4. O = P V over this warp's column pairs: A from the P tile, B = V
  //    read column-wise (ldmatrix.trans)
  float o[MAXO][2][4];
#pragma unroll
  for (int i = 0; i < MAXO; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][j][e] = 0.f;
  const uint32_t pa = smem_u32(p_s) + (lane & 15) * PP * 2 + (lane >> 4) * 16;
  const uint32_t vb =
      smem_u32(v_s) + ((lane & 7) + ((lane >> 3) & 1) * 8) * KP * 2 + (lane >> 4) * 16;
  for (int ks = 0; ks < np; ++ks) {
    uint32_t af[4];
    ldsm4(af, pa + ks * 32);
#pragma unroll
    for (int i = 0; i < MAXO; ++i) {
      const int cp = warp + i * WARPS;
      if (cp < NPO) {
        uint32_t bf[4];
        ldsm4t(bf, vb + ks * 16 * KP * 2 + cp * 32);
        mma(o[i][0], af, bf[0], bf[1]);
        mma(o[i][1], af, bf[2], bf[3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MAXO; ++i) {
    const int cp = warp + i * WARPS;
    if (cp < NPO) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = cp * 16 + j * 8 + 2 * t4;
        *reinterpret_cast<float2*>(o_s + g * OP + c) = make_float2(o[i][j][0], o[i][j][1]);
        *reinterpret_cast<float2*>(o_s + (g + 8) * OP + c) =
            make_float2(o[i][j][2], o[i][j][3]);
      }
    }
  }
}

// The same split on CUDA-core FMAs (fp32 pools, and int8 pools with fp32
// q), with the same outputs as split_mma.
template <typename KV, int D, int KS>
__device__ __forceinline__ void split_fma(const float* q_s, KV* k_s, const KV* v_s,
                                          float* s_s, float* o_s, float* m_s, float* l_s,
                                          int rows, int base, int pos0, int nk, float scale,
                                          float ksc, float vsc) {
  using G = Geometry<KV, D>;
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int KP = G::KP, QP = G::QP, OP = G::OP;
  constexpr int NDC = D / 8;                      // 8-element chunks a row
  constexpr int MAXDC = (NDC + THREADS / QB - 1) / (THREADS / QB);
  constexpr int MAXK = KS / (THREADS / QB);       // keys a thread scores, at most
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // thread = (row pr, its keys pt, pt + tpr, ...), rows spread over all
  // 128 threads whatever their number (a decode block: 1 row)
  int rows2 = 1;
  while (rows2 < rows) rows2 <<= 1;
  const int tpr = THREADS / rows2;                // threads per row
  const int pr = tid / tpr, pt = tid - pr * tpr;

  // 1. masked scores of the valid rows: each thread holds its keys'
  //    sums and walks head_dim 8 elements at a time, q read once a step;
  //    each 8-element chunk is summed alone and added to one of two
  //    sums a key, alternately (no long serial chain: fp32 error stays at
  //    the size of a 16-term sum at head_dim 128)
  if (pr < rows) {
    float dot[MAXK][2];
#pragma unroll
    for (int j = 0; j < MAXK; ++j) dot[j][0] = dot[j][1] = 0.f;
    for (int d0 = 0; d0 < D; d0 += 16) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float qf[8];
        load8(q_s + pr * QP + d0 + hf * 8, qf);
#pragma unroll
        for (int j = 0; j < MAXK; ++j) {
          const int c = pt + j * tpr;
          if (c < nk) {
            float kf[8];
            load8(k_s + c * KP + d0 + hf * 8, kf);
            float t = 0.f;
#pragma unroll
            for (int e = 0; e < 8; ++e) t = fmaf(qf[e], QUANT ? kf[e] * ksc : kf[e], t);
            dot[j][hf] += t;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MAXK; ++j) {
      const int c = pt + j * tpr;
      if (c < nk)
        s_s[pr * KS + c] = pos0 + c <= base + pr ? (dot[j][0] + dot[j][1]) * scale : NEG_INF;
    }
  }
  __syncthreads();
  // 2. softmax over the split, a warp per row; P unrounded (T is fp32)
  for (int r = warp; r < rows; r += WARPS) {
    float mx = NEG_INF;
    for (int c = lane; c < nk; c += 32) mx = fmaxf(mx, s_s[r * KS + c]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < nk; c += 32) {
      const float p = pos0 + c <= base + r ? expf(s_s[r * KS + c] - mx) : 0.f;
      sum += p;
      s_s[r * KS + c] = p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[r] = mx;
      l_s[r] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // P and V in place
  // 3. O = P V: thread = (row pr, 8-column chunks dc0 + k * tpr, key
  //    group); a decode block (1 row) spreads its columns and keys over
  //    all 128 threads
  const int dc0 = pt % NDC, kg = pt / NDC;
  const int ngrp = tpr > NDC ? tpr / NDC : 1;     // key groups
  const int ndc = tpr < NDC ? (NDC + tpr - 1) / tpr : 1;
  float acc[8 * MAXDC];
#pragma unroll
  for (int i = 0; i < 8 * MAXDC; ++i) acc[i] = 0.f;
  const bool live = pr < rows && kg < ngrp;
  if (live) {
    // only the keys this row may see
    const int c_end = min(nk, base + pr - pos0 + 1);
    for (int c = kg; c < c_end; c += ngrp) {
      const float p = s_s[pr * KS + c];
      const KV* vr = v_s + c * KP;
#pragma unroll
      for (int k = 0; k < MAXDC; ++k) {
        const int dc = dc0 + k * tpr;
        if (k < ndc && dc < NDC) {
          float vf[8];
          load8(vr + dc * 8, vf);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[k * 8 + e] = fmaf(p, QUANT ? vf[e] * vsc : vf[e],
                                                            acc[k * 8 + e]);
        }
      }
    }
  }
  // the key groups of a row summed in group order (through Geometry's
  // part region), into the O tile (over the q tile, no longer read)
  float* part = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(k_s) + G::PART_AT);
  if (ngrp > 1 && live) {
#pragma unroll
    for (int e = 0; e < 8; ++e) part[tid * 8 + e] = acc[e];
  }
  __syncthreads();
  if (live && kg == 0) {
    for (int j = 1; j < ngrp; ++j) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += part[(tid + j * NDC) * 8 + e];
    }
#pragma unroll
    for (int k = 0; k < MAXDC; ++k) {
      const int dc = dc0 + k * tpr;
      if (k < ndc && dc < NDC) {
#pragma unroll
        for (int e = 0; e < 8; ++e) o_s[pr * OP + dc * 8 + e] = acc[k * 8 + e];
      }
    }
  }
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(THREADS) ragged_paged_attention_kernel(const Args a) {
  using G = Geometry<KV, D>;
  using TR = Traits<T>;
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  static_assert(QUANT || std::is_same<KV, T>::value,
                "a float pool shares the type of q and the output");
  static_assert(G::MMA == std::is_same<T, bf16>::value, "bf16 runs on the tensor cores");
  constexpr int KS = G::KS, VEC = G::VEC, NVD = G::NVD, KP = G::KP, QP = G::QP;
  constexpr int OP = G::OP;
  const int num_heads = a.num_heads, page_size = a.page_size;
  const int h = blockIdx.x;
  const int tid = threadIdx.x;
  T* __restrict__ out = static_cast<T*>(a.out);
  extern __shared__ __align__(16) unsigned char smem[];

  if (blockIdx.y == 0) {
    // the first row of CTAs (running beside the splits, not after them):
    // zero this head's output of the flat tokens that no block owns.  A
    // token's plan entries are read by one thread, all tokens of a batch
    // at once; the zeros go out 16 bytes a thread, neighbouring threads on
    // neighbouring bytes of a token's row
    constexpr int CH = D * (int)sizeof(T) / 16;    // 16-byte chunks a row
    int* pad = reinterpret_cast<int*>(smem);       // [THREADS]
    for (int t0 = 0; t0 < a.num_tokens; t0 += THREADS) {
      const int t = t0 + tid;
      bool real = false;
      if (t < a.num_tokens) {
        const int b = a.tok_blk[t], r = a.tok_row[t];
        if (b >= 0 && b < a.nb_max && r >= 0 && r < QB) {
          const int rows_b = a.blk_rows[b], tok = a.blk_tok[b * QB + r];
          real = r < rows_b && tok == t;
        }
      }
      pad[tid] = !real;
      __syncthreads();
      const int nt = min(THREADS, a.num_tokens - t0);
      for (int i = tid; i < nt * CH; i += THREADS) {
        const int tt = i / CH, c = i - tt * CH;
        if (pad[tt])
          reinterpret_cast<uint4*>(out + ((size_t)(t0 + tt) * num_heads + h) * D)[c] =
              make_uint4(0u, 0u, 0u, 0u);
      }
      __syncthreads();
    }
    return;
  }
  const int x = blockIdx.y - 1;                    // the split: item * spp + sub
  const int w = x / a.spp, sub = x - w * a.spp;
  // the plan's entries, loaded together (w < wl_max: in bounds even in
  // the tail)
  const int n = a.n_items[0];
  const int blk = a.wl_blk[w], ps = a.wl_pageslot[w], page = a.wl_page[w];
  if (w >= min(n, a.wl_max)) return;              // the repeated tail
  const int rows = a.blk_rows[blk], base = a.blk_base[blk];
  if (rows <= 0) return;
  const int max_pos = base + rows - 1;             // the block's last query position
  const int k0 = sub * KS;                         // the split's first key in its page
  const int pos0 = ps * page_size + k0;            // and its position
  if (k0 >= page_size || pos0 > max_pos) return;   // no key any row may see
  const int nk = min(min(KS, page_size - k0), max_pos - pos0 + 1);
  // the block's splits: full pages before its last, then the last page's
  // splits up to max_pos; its first item is page slot 0
  const int nsplit = (max_pos / page_size) * a.spp + (max_pos % page_size) / KS + 1;

  KV* k_s = reinterpret_cast<KV*>(smem);
  KV* v_s = reinterpret_cast<KV*>(smem + G::KV_BYTES);
  T* q_s = reinterpret_cast<T*>(smem + 2 * G::KV_BYTES);
  void* s_tile = smem + 2 * G::KV_BYTES + G::Q_BYTES;
  float* red_m = reinterpret_cast<float*>(smem + G::RED_AT);
  float* red_l = red_m + WARPS * QB;
  float* m_s = red_l + WARPS * QB;
  float* l_s = m_s + QB;
  int* flag = reinterpret_cast<int*>(l_s + QB);

  // 1. the split's K, then its V, in flight at once: key rows < nk copied,
  //    rows up to the next 16 zero-filled (nothing read)
  {
    const size_t src = (((size_t)page * num_heads + h) * page_size + k0) * D;
    const KV* kg = static_cast<const KV*>(a.k_pool) + src;
    const KV* vg = static_cast<const KV*>(a.v_pool) + src;
    const int nk16 = (nk + 15) & ~15;
    for (int i = tid; i < nk16 * NVD; i += THREADS) {
      const int r = i / NVD, c = i - r * NVD;
      cp_async16(k_s + r * KP + c * VEC, r < nk ? kg + (size_t)r * D + c * VEC : kg, r < nk);
    }
    cp_async_commit();
    for (int i = tid; i < nk16 * NVD; i += THREADS) {
      const int r = i / NVD, c = i - r * NVD;
      cp_async16(v_s + r * KP + c * VEC, r < nk ? vg + (size_t)r * D + c * VEC : vg, r < nk);
    }
    cp_async_commit();
  }
  // the block's q rows while the copies fly (rows past `rows` zero)
  {
    const T* q = static_cast<const T*>(a.q);
    for (int i = tid; i < QB * D; i += THREADS) {
      const int r = i / D, d = i - r * D;
      T x = TR::from_f(0.f);
      if (r < rows) x = q[a.blk_tok[blk * QB + r] * a.q_row_stride + h * D + d];
      q_s[r * QP + d] = x;
    }
  }
  cp_async_wait<1>();
  __syncthreads();   // K and q in place

  float* o_s;
  if constexpr (G::MMA) {
    o_s = reinterpret_cast<float*>(k_s);
    split_mma<D, KS>(q_s, k_s, v_s, static_cast<bf16*>(s_tile), red_m, red_l, o_s, m_s, l_s,
                     rows, base, pos0, nk, a.scale);
  } else {
    o_s = reinterpret_cast<float*>(q_s);
    const size_t si = (size_t)page * num_heads + h;   // an int8 page's scales
    split_fma<KV, D, KS>(q_s, k_s, v_s, static_cast<float*>(s_tile), o_s, m_s, l_s, rows,
                         base, pos0, nk, a.scale, QUANT ? a.k_scale[si] : 1.f,
                         QUANT ? a.v_scale[si] : 1.f);
  }
  __syncthreads();   // O, m and l of every row in place

  constexpr int C4 = D / 4;
  if (nsplit == 1) {
    // the block's only split: normalise and write each valid row
    for (int i = tid; i < rows * C4; i += THREADS) {
      const int r = i / C4, c = (i - r * C4) * 4;
      const float l = l_s[r] == 0.f ? 1.f : l_s[r];
      T* o = out + ((size_t)a.blk_tok[blk * QB + r] * num_heads + h) * D + c;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = TR::from_f(o_s[r * OP + c + e] / l);
    }
    return;
  }
  // 2. the partial (m, l, O) of the valid rows into the workspace; the
  //    last CTA of the (block, head) to arrive merges the block's splits
  const size_t nsp = (size_t)a.wl_max * a.spp;      // workspace splits
  float* const ws_o = a.ws;                          // [nsp][H][QB][D]
  float* const ws_ml = a.ws + nsp * num_heads * QB * D;   // [nsp][H][QB][2]
  {
    float* wo = ws_o + (((size_t)x * num_heads + h) * QB) * D;
    float* wml = ws_ml + ((size_t)x * num_heads + h) * QB * 2;
    for (int i = tid; i < rows * C4; i += THREADS) {
      const int r = i / C4, c = (i - r * C4) * 4;
      *reinterpret_cast<float4*>(wo + r * D + c) =
          *reinterpret_cast<const float4*>(o_s + r * OP + c);
    }
    if (tid < rows) {
      wml[2 * tid] = m_s[tid];
      wml[2 * tid + 1] = l_s[tid];
    }
  }
  __syncthreads();
  int* ticket = a.tickets + (size_t)blk * num_heads + h;
  if (tid == 0) {
    *flag = ticket_add(ticket) == nsplit - 1;
    if (*flag) *ticket = 0;           // every other split has arrived
  }
  __syncthreads();
  if (!*flag) return;
  // the block's splits are workspace splits j0 .. j0 + nsplit - 1, in
  // work-list order: their (m, l, O) read MB splits at a time, all loads
  // of a batch out together, and summed in that order against the running
  // max (one batch, and so one read, at up to MB splits)
  constexpr int MB = 8;
  const size_t j0 = (size_t)(w - ps) * a.spp;
  for (int i = tid; i < rows * C4; i += THREADS) {
    const int r = i / C4, c = (i - r * C4) * 4;
    float mx = NEG_INF, den = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < nsplit; s0 += MB) {
      float mv[MB], lv[MB];
      float4 xv[MB];
#pragma unroll
      for (int j = 0; j < MB; ++j) {
        const bool ok = s0 + j < nsplit;
        const size_t at = ((j0 + s0 + j) * num_heads + h) * QB + r;
        mv[j] = ok ? __ldcg(ws_ml + at * 2) : NEG_INF;
        lv[j] = ok ? __ldcg(ws_ml + at * 2 + 1) : 0.f;
        xv[j] = ok ? __ldcg(reinterpret_cast<const float4*>(ws_o + at * D + c))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float m_new = mx;
#pragma unroll
      for (int j = 0; j < MB; ++j) m_new = fmaxf(m_new, mv[j]);
      const float alpha = expf(mx - m_new);
      den *= alpha;
      o.x *= alpha;
      o.y *= alpha;
      o.z *= alpha;
      o.w *= alpha;
#pragma unroll
      for (int j = 0; j < MB; ++j) {
        if (s0 + j < nsplit) {
          const float wgt = expf(mv[j] - m_new);
          den = fmaf(wgt, lv[j], den);
          o.x = fmaf(wgt, xv[j].x, o.x);
          o.y = fmaf(wgt, xv[j].y, o.y);
          o.z = fmaf(wgt, xv[j].z, o.z);
          o.w = fmaf(wgt, xv[j].w, o.w);
        }
      }
      mx = m_new;
    }
    const float l = den == 0.f ? 1.f : den;
    T* dst = out + ((size_t)a.blk_tok[blk * QB + r] * num_heads + h) * D + c;
    dst[0] = TR::from_f(o.x / l);
    dst[1] = TR::from_f(o.y / l);
    dst[2] = TR::from_f(o.z / l);
    dst[3] = TR::from_f(o.w / l);
  }
}

template <typename T, typename KV, int D>
int launch(const Args& a, int keys_per_split, cudaStream_t stream) {
  using G = Geometry<KV, D>;
  // the wrapper sizes the grid and the workspace from the same split
  if (keys_per_split != G::KS || a.spp != (a.page_size + G::KS - 1) / G::KS)
    return (int)cudaErrorInvalidValue;
  auto kernel = ragged_paged_attention_kernel<T, KV, D>;
  if (G::SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)G::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  // heads on x; on y the zeroing row, then the splits: every head's live
  // splits come before the repeated tail's, which exit at once
  dim3 grid(a.num_heads, (unsigned)(a.wl_max * a.spp + 1));
  kernel<<<grid, THREADS, G::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// what a launch runs: dynamic shared memory per CTA, registers per
// thread, CTAs resident per SM, threads per CTA, local memory per thread,
// keys per split
template <typename T, typename KV, int D>
int info_of(int* out) {
  using G = Geometry<KV, D>;
  auto kernel = ragged_paged_attention_kernel<T, KV, D>;
  cudaError_t e = cudaSuccess;
  if (G::SMEM > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  int ctas = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, THREADS, G::SMEM);
  if (e != cudaSuccess) return (int)e;
  out[0] = (int)G::SMEM;
  out[1] = attr.numRegs;
  out[2] = ctas;
  out[3] = THREADS;
  out[4] = (int)attr.localSizeBytes;
  out[5] = G::KS;
  return 0;
}

template <typename T, typename KV>
int info_head_dim(int head_dim, int* out) {
  switch (head_dim) {
    case 16: return info_of<T, KV, 16>(out);
    case 32: return info_of<T, KV, 32>(out);
    case 64: return info_of<T, KV, 64>(out);
    case 128: return info_of<T, KV, 128>(out);
    case 192: return info_of<T, KV, 192>(out);
    case 256: return info_of<T, KV, 256>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename KV>
int dispatch_head_dim(int head_dim, const Args& a, int ks, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, KV, 16>(a, ks, stream);
    case 32: return launch<T, KV, 32>(a, ks, stream);
    case 64: return launch<T, KV, 64>(a, ks, stream);
    case 128: return launch<T, KV, 128>(a, ks, stream);
    case 192: return launch<T, KV, 192>(a, ks, stream);
    case 256: return launch<T, KV, 256>(a, ks, stream);
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
// RAGGED_PLAN_FIELDS documents, with a block's items its page slots 0, 1,
// ... in order (build_ragged_plan's layout).  head_dim one of 16, 32, 64,
// 128, 192, 256; page_size a multiple of 16 up to 128.  keys_per_split:
// the keys one CTA takes (the kernel's Geometry::KS, which the wrapper
// computes alike); splits_per_page = ceil(page_size / keys_per_split);
// workspace: wl_max * splits_per_page * num_heads * 16 * (head_dim + 2)
// fp32; tickets: nb_max * num_heads int32, all 0 (the kernel leaves them
// 0).  Launches on one stream may share a workspace; launches that may
// run at the same time may not.  Returns a cudaError_t (0 on success).
int rpa_forward(int device, int dtype, const void* q, const void* k_pool,
                const void* v_pool, const float* k_scale,
                const float* v_scale, void* out, const int* blk_tok,
                const int* tok_blk, const int* tok_row, const int* blk_base,
                const int* blk_rows, const int* wl_blk, const int* wl_page,
                const int* wl_pageslot, const int* n_items,
                long long q_row_stride, int num_tokens, int num_heads,
                int head_dim, int page_size, int token_block, int nb_max,
                int wl_max, float scale, int keys_per_split, int splits_per_page,
                float* workspace, int* tickets, void* stream) {
  if (token_block != QB || page_size < 16 || page_size > 128 ||
      page_size % 16 != 0 || num_tokens < 1 || num_heads < 1 ||
      num_heads > 65535 || nb_max < 1 || wl_max < 1 || splits_per_page < 1 ||
      (long long)wl_max * splits_per_page + 1 > 65535 ||
      workspace == nullptr || tickets == nullptr ||
      q_row_stride < (long long)num_heads * head_dim ||
      (dtype == 2) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Args a{q, k_pool, v_pool, k_scale, v_scale, out, blk_tok, tok_blk, tok_row, blk_base,
               blk_rows, wl_blk, wl_page, wl_pageslot, n_items, workspace, tickets,
               q_row_stride, num_tokens, num_heads, page_size, nb_max, wl_max,
               splits_per_page, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_head_dim<float, float>(head_dim, a, keys_per_split, s);
  if (dtype == 1) return dispatch_head_dim<bf16, bf16>(head_dim, a, keys_per_split, s);
  if (dtype == 2) return dispatch_head_dim<float, int8_t>(head_dim, a, keys_per_split, s);
  return (int)cudaErrorInvalidValue;
}

// The kernel of this dtype and head_dim: info[0] dynamic shared memory per
// CTA (bytes), [1] registers per thread, [2] CTAs resident per SM, [3]
// threads per CTA, [4] local memory per thread (bytes), [5] keys per split.
int rpa_kernel_info(int device, int dtype, int head_dim, int* info) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (dtype == 0) return info_head_dim<float, float>(head_dim, info);
  if (dtype == 1) return info_head_dim<bf16, bf16>(head_dim, info);
  if (dtype == 2) return info_head_dim<float, int8_t>(head_dim, info);
  return (int)cudaErrorInvalidValue;
}

const char* rpa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
