// Flash attention for Hopper (sm_90a): the forward (O and the per-row
// logsumexp) and the two backward kernels (dK/dV, and dQ) of causal or
// full attention over [B, N, S, D] operands.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas_kernels/
// flash_attention.py: _fwd_kernel / _flash_fwd (forward), _bwd_dkv_kernel
// and _bwd_dq_kernel / _flash_bwd (backward), and computes what they
// compute, with their rounding points:
//   - scores and every product accumulate in fp32; fp32 operands stay fp32
//     (plain FMA, no TF32), bf16 operands go through the tensor cores;
//   - forward: online softmax over KV blocks in fp32; P is rounded to the
//     V dtype before PV; O = acc / l (l == 0 guarded); lse = m + log(l);
//   - backward: P = exp(S * scale - lse) recomputed from q, k and lse;
//     P rounded to the dO dtype before dV += P^T dO; dS = P * (dP - delta)
//     in fp32, rounded to the q/k dtype before dK += dS^T Q and
//     dQ += dS K; the scale enters dK and dQ (applied once, to the fp32
//     sums), not dV.  delta = rowsum(dO * O) is computed outside, as the
//     TPU version does;
//   - masking uses the finite NEG_INF = -1e30, and causal blocks that lie
//     wholly above the diagonal are skipped.
// The bf16 kernels take the exponentials in base 2: the scores are scaled
// by scale * log2(e) in fp32 and exp2f replaces expf (forward: the running
// max is kept in that domain and lse = max * ln 2 + log(l); backward:
// P = exp2(S * scale * log2 e - lse * log2 e)).  That moves P by a few fp32
// ulps, far below its bf16 rounding.
//
// What bounds it on this card: both, nearly equally.  At the trained shape
// (B 8, N 16, S 1024, D 128, bf16, causal) the forward does 34 GFLOP on
// 134 MB (about 256 operations per byte, just below the ~295 where
// Hopper's bf16 tensor cores, not its memory, become the limit) and the
// backward, least work, 86 GFLOP on 268 MB (above it).  The kernels are
// far from either bound, so what they are built for is keeping the tensor
// cores fed.
//
// The bf16 kernels (every bf16 main path: training, the prefill of
// generate(), the encoder) are built for that.  Common to all three:
//   - one CTA owns 128 rows (query rows: forward and dQ; key rows: dK/dV)
//     and runs 8 warps; nothing is carried between CTAs, so the TPU grid's
//     sequential accumulation becomes the loop over the streamed blocks;
//   - S, P, dP, dS and the O / dK / dV / dQ accumulators live in registers;
//     the accumulator layout of one product is the A-operand layout of the
//     next, so P (and dS, P^T, dS^T) is rounded to bf16 in registers and fed
//     straight into P V, dS K, P^T dO and dS^T Q; row max and row sum are
//     taken by two shuffles within the four threads that hold a row;
//   - the streamed operand (K and V in the forward and dQ kernels; Q, dO,
//     lse and delta in the dK/dV kernel) goes through a ring of shared-
//     memory stages (3; 2 for the forward at D 256) that every thread fills
//     with cp.async (16 bytes a thread; rows at or past seq take the
//     src-size 0 form, zero-filled and never read) and signals on the
//     stage's "full" mbarrier through cp.async.mbarrier.arrive; each warp
//     releases a stage on its "empty" mbarrier.  So the next blocks load
//     while this one computes, and the loop holds no __syncthreads: a warp
//     waits only for the stage it reads next and for the stage it refills;
//   - tiles are XOR-swizzled, not padded (16-byte chunk c of a row at
//     c ^ (row % 8)), so the 8 rows that one ldmatrix or wgmma phase reads
//     fall in 8 bank groups;
//   - q, k, v, dO and every output are read and written through their own
//     (batch, head, row) strides, so the views into the fused QKV output
//     [B, S, 3, N, D] need no copy; causal CTAs with the most blocks are
//     scheduled first.
// Forward: two warpgroups of 64 query rows; S = Q K^T as wgmma.m64nBk16
// (B the key block: 128 at D 128, 64 otherwise) with both operands read
// from shared memory through 128-byte-swizzle descriptors (Q and each K/V
// tile held as 64-column panels, the layout wgmma reads), and O += P V as
// wgmma.m64nDk16 with P from registers and V read transposed by the
// descriptor (bf16 in, fp32 accumulate; head_dim 64, 128, 192, 256).  The consumers fence the cp.async
// data into the async proxy before each product.
// Backward: mma.sync.m16n8k16 (bf16 in, fp32 accumulate), operands from
// shared memory through ldmatrix (.trans where the product reads a tile
// column-wise), each warp 16 rows.  No tile needs a transpose through
// shared memory: the dK/dV warps own key rows, so S^T = K Q^T and
// dP^T = V dO^T come out with keys as rows, the A layout of P^T dO and
// dS^T Q; Q and dO are read column-wise there through ldmatrix.trans.
// Each warp loads the rows it owns (Q, or K and V, or Q and dO) once and
// writes its output back through the same rows of shared memory with
// 16-byte coalesced stores.
// Budget (bf16, per CTA of 256 threads; chip_smoke.py's build phase prints
// ptxas's registers and spills and the runtime's shared memory and CTAs
// per SM, flash_attention_kernel_info):
//   - forward, D 64 / 128 / 192 / 256: the 128-row Q tile and 3 stages (2
//     at D 256) of a K and V tile of 64 keys (128 at D 128), + 1 KB to
//     align the tiles to 1024 bytes: 66,688 / 230,528 / 197,760 / 197,760
//     bytes; 2 CTAs per SM at D 64 (registers), 1 above (shared memory);
//   - dK/dV, D 64 / 128: K and V of 128 key rows and 3 stages of Q and dO
//     of 64 query rows with their lse and delta: 83,584 / 165,504 bytes;
//   - dQ, D 64 / 128: Q and dO of 128 rows and 3 stages of a 64-key K and
//     V tile: 82,048 / 163,968 bytes;
//   so the backward runs one CTA of 8 warps per SM (registers), against one
//   4-warp CTA in its first version.  The backward takes head_dim 64 and
//   128; 192 and 256 are refused (ROADMAP.md, queue 2): two D-wide fp32
//   accumulators do not fit a thread's registers at 16 rows a warp.
// The fp32 kernels are on no bf16 main path and keep the first version's
// design behind the same entry points: one CTA of 4 warps per 64-row
// block (32 in the dK/dV kernel), every tile staged in shared memory,
// register-blocked FMA products, scores and sums in fp32 shared memory.
//
// Interface: plain C, loaded through ctypes by
// paddle_tpu_torch/ops/kernels/flash_attention.py.  Launches go on the
// caller's stream, allocate nothing and return the cudaError_t.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// one [B, N, S, D] operand: element strides of batch, head and row; the D
// elements of a row are contiguous
struct Operand {
  const void* p;
  long long sb, sn, ss;
};

// operand slots of the pointer and stride arrays the C entry points take
enum Slot { Q = 0, K, V, O, DO, DQ, DK, DV, NUM_OPERANDS };

struct Args {
  Operand t[NUM_OPERANDS];
  float* lse;              // [B * N, S] fp32
  const float* delta;      // [B * N, S] fp32
  int heads, seq;
  float scale;
  int causal;
};

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}

template <typename T>
__device__ __forceinline__ const T* row_ptr(const Operand& x, int b, int n, int row) {
  return static_cast<const T*>(x.p) + b * x.sb + n * x.sn + (long long)row * x.ss;
}

// ===========================================================================
// fp32: the first version's kernels
// ===========================================================================

constexpr int THREADS = 128;   // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int BLK = 64;        // rows of the block a CTA owns

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

constexpr int PAD = 4;   // shared-memory row padding (elements)

// rows x D elements of T from device memory (row stride ss) into shared
// memory (row stride ld), 16 bytes per thread and step; rows at or past
// `valid` are never read and hold zeros
template <typename T, int D>
__device__ void load_tile(T* dst, int ld, const T* src, long long ss, int rows,
                          int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < rows * VPR; i += THREADS) {
    const int r = i / VPR, c = (i - r * VPR) * VEC;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        r < valid ? *reinterpret_cast<const uint4*>(src + r * ss + c) : make_uint4(0, 0, 0, 0);
  }
}

template <typename T, int D>
__device__ void load_tile(T* dst, int ld, const T* src, long long ss, int rows) {
  load_tile<T, D>(dst, ld, src, ss, rows, rows);
}

// rows x D fp32 sums from shared memory (row stride ld) to device memory
// as T: x * mul, or x / div[r] when div is given
template <typename T, int D>
__device__ void store_tile(T* dst, long long ss, const float* src, int ld, int rows,
                           float mul, const float* div) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < rows * VPR; i += THREADS) {
    const int r = i / VPR, c = (i - r * VPR) * VEC;
    float e[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float x = src[r * ld + c + j];
      e[j] = div ? x / div[r] : x * mul;
    }
    *reinterpret_cast<uint4*>(dst + r * ss + c) = Vec16<T>::pack(e);
  }
}

// C[M][N] (fp32, shared, row stride ldc) = (ACC: +=) A[M][K] x B, with A
// row-major T (row stride lda) and B(k, n) = BT ? b[n * ldb + k]
// : b[k * ldb + n].  Called by all 128 threads; the caller synchronises.
//
// fp32: full-precision FMA, each thread a (M/8) x (N/16) micro-tile.
template <int M, int N, int K, bool BT, bool ACC>
__device__ void mm(const float* a, int lda, const float* b, int ldb, float* c,
                   int ldc) {
  static_assert(M % 8 == 0 && N % 16 == 0, "fp32 micro-tiling");
  constexpr int TM = M / 8, TN = N / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      acc[i][j] = ACC ? c[(ty + 8 * i) * ldc + tx + 16 * j] : 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = a[(ty + 8 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      bv[j] = BT ? b[(tx + 16 * j) * ldb + k] : b[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) c[(ty + 8 * i) * ldc + tx + 16 * j] = acc[i][j];
}

// ---------------------------------------------------------------------------
// forward: one CTA per (64 query rows, b * n); loops over KV blocks.  Any
// seq >= 1: the last block's rows and keys at or past seq load as zeros,
// those keys are masked to NEG_INF before the row max, and O and lse are
// stored for rows below seq only.
// ---------------------------------------------------------------------------

template <typename T, int D>
struct FwdGeom {
  static constexpr int TS = D + PAD;               // q/k/v row stride
  static constexpr int SS = BLK + 4;               // score (and P) row stride
  static constexpr int OS = D + 4;                 // O row stride
  static constexpr size_t TILE = align128(sizeof(T) * BLK * TS);
  static constexpr size_t S_BYTES = align128(sizeof(float) * BLK * SS);
  static constexpr size_t O_BYTES = align128(sizeof(float) * BLK * OS);
  static constexpr size_t ROW = align128(sizeof(float) * BLK);
  // P overwrites S in place
  static constexpr size_t SMEM = 3 * TILE + S_BYTES + O_BYTES + 3 * ROW;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Args a) {
  using G = FwdGeom<T, D>;
  constexpr int TS = G::TS, SS = G::SS, PS = G::SS, OS = G::OS;
  const int n_blk = (a.seq + BLK - 1) / BLK;
  const int qb = n_blk - 1 - blockIdx.x;       // most KV blocks first
  const int bn = blockIdx.y, b = bn / a.heads, n = bn - b * a.heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q_rows = min(BLK, a.seq - qb * BLK);   // rows below seq
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = reinterpret_cast<T*>(smem + G::TILE);
  T* v_s = reinterpret_cast<T*>(smem + 2 * G::TILE);
  float* s_s = reinterpret_cast<float*>(smem + 3 * G::TILE);
  float* o_s = reinterpret_cast<float*>(smem + 3 * G::TILE + G::S_BYTES);
  float* m_s = reinterpret_cast<float*>(smem + 3 * G::TILE + G::S_BYTES + G::O_BYTES);
  float* l_s = m_s + G::ROW / sizeof(float);
  float* al_s = l_s + G::ROW / sizeof(float);
  T* p_s = s_s;

  load_tile<T, D>(q_s, TS, row_ptr<T>(a.t[Q], b, n, qb * BLK), a.t[Q].ss, BLK, q_rows);
  for (int i = tid; i < BLK * D; i += THREADS) o_s[(i / D) * OS + i % D] = 0.f;
  if (tid < BLK) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  const int kv_end = a.causal ? qb + 1 : n_blk;
  for (int kb = 0; kb < kv_end; ++kb) {
    __syncthreads();   // the last iteration's readers of k/v/p are done
    const int kv_rows = min(BLK, a.seq - kb * BLK);
    load_tile<T, D>(k_s, TS, row_ptr<T>(a.t[K], b, n, kb * BLK), a.t[K].ss, BLK, kv_rows);
    load_tile<T, D>(v_s, TS, row_ptr<T>(a.t[V], b, n, kb * BLK), a.t[V].ss, BLK, kv_rows);
    __syncthreads();
    mm<BLK, BLK, D, true, false>(q_s, TS, k_s, TS, s_s, SS);       // S = Q K^T
    __syncthreads();
    // online softmax, one warp per row, two columns per lane
    for (int r = warp; r < BLK; r += WARPS) {
      const int qpos = qb * BLK + r;
      float sv[BLK / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BLK / 32; ++j) {
        const int c = lane + 32 * j;
        float s = s_s[r * SS + c] * a.scale;
        if ((a.causal && kb * BLK + c > qpos) || c >= kv_rows) s = NEG_INF;
        sv[j] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BLK / 32; ++j) {
        const float p = expf(sv[j] - m_new);
        sum += p;
        p_s[r * PS + lane + 32 * j] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        al_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
      }
    }
    __syncthreads();
    for (int i = tid; i < BLK * D; i += THREADS) o_s[(i / D) * OS + i % D] *= al_s[i / D];
    __syncthreads();
    mm<BLK, D, BLK, false, true>(p_s, PS, v_s, TS, o_s, OS);       // O += P V
  }
  __syncthreads();
  if (tid < BLK) {
    const float l = l_s[tid];
    const float l_safe = l == 0.f ? 1.f : l;
    l_s[tid] = l_safe;
    if (tid < q_rows) a.lse[(long long)bn * a.seq + qb * BLK + tid] = m_s[tid] + logf(l_safe);
  }
  __syncthreads();
  store_tile<T, D>(const_cast<T*>(row_ptr<T>(a.t[O], b, n, qb * BLK)), a.t[O].ss, o_s,
                   OS, q_rows, 1.f, l_s);
}

// ---------------------------------------------------------------------------
// backward dK/dV: one CTA per (64 key rows, b * n); loops over query blocks
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DkvGeom {
  static constexpr int BQ = 32;                    // query rows per step
  static constexpr int TS = D + PAD;
  static constexpr int STS = BQ + 4;               // fp32 S^T / dP^T stride
  static constexpr int OS = D + 4;
  static constexpr size_t KV_TILE = align128(sizeof(T) * BLK * TS);
  static constexpr size_t Q_TILE = align128(sizeof(T) * BQ * TS);
  static constexpr size_t ACC = align128(sizeof(float) * BLK * OS);
  static constexpr size_t ST = align128(sizeof(float) * BLK * STS);
  static constexpr size_t ROW = align128(sizeof(float) * BQ);
  // P^T and dS^T overwrite S^T and dP^T in place
  static constexpr size_t SMEM = 2 * KV_TILE + 2 * ACC + 2 * Q_TILE + 2 * ST + 2 * ROW;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(const Args a) {
  using G = DkvGeom<T, D>;
  constexpr int BQ = G::BQ, TS = G::TS, STS = G::STS, PTS = G::STS, OS = G::OS;
  const int kb = blockIdx.x;                   // causal: block 0 has most work
  const int bn = blockIdx.y, b = bn / a.heads, n = bn - b * a.heads;
  const int tid = threadIdx.x;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* at = smem;
  T* k_s = reinterpret_cast<T*>(at);  at += G::KV_TILE;
  T* v_s = reinterpret_cast<T*>(at);  at += G::KV_TILE;
  float* dk_s = reinterpret_cast<float*>(at);  at += G::ACC;
  float* dv_s = reinterpret_cast<float*>(at);  at += G::ACC;
  T* q_s = reinterpret_cast<T*>(at);  at += G::Q_TILE;
  T* do_s = reinterpret_cast<T*>(at);  at += G::Q_TILE;
  float* st_s = reinterpret_cast<float*>(at);  at += G::ST;
  float* dpt_s = reinterpret_cast<float*>(at);  at += G::ST;
  float* lse_s = reinterpret_cast<float*>(at);  at += G::ROW;
  float* dl_s = reinterpret_cast<float*>(at);  at += G::ROW;
  T* pt_s = st_s;
  T* dst_s = dpt_s;

  load_tile<T, D>(k_s, TS, row_ptr<T>(a.t[K], b, n, kb * BLK), a.t[K].ss, BLK);
  load_tile<T, D>(v_s, TS, row_ptr<T>(a.t[V], b, n, kb * BLK), a.t[V].ss, BLK);
  for (int i = tid; i < BLK * D; i += THREADS) {
    dk_s[(i / D) * OS + i % D] = 0.f;
    dv_s[(i / D) * OS + i % D] = 0.f;
  }
  const long long row0 = (long long)bn * a.seq;
  // causal: query blocks wholly before this key block see none of it
  for (int qi = a.causal ? kb * BLK / BQ : 0; qi < a.seq / BQ; ++qi) {
    __syncthreads();
    load_tile<T, D>(q_s, TS, row_ptr<T>(a.t[Q], b, n, qi * BQ), a.t[Q].ss, BQ);
    load_tile<T, D>(do_s, TS, row_ptr<T>(a.t[DO], b, n, qi * BQ), a.t[DO].ss, BQ);
    if (tid < BQ) {
      lse_s[tid] = a.lse[row0 + qi * BQ + tid];
      dl_s[tid] = a.delta[row0 + qi * BQ + tid];
    }
    __syncthreads();
    mm<BLK, BQ, D, true, false>(k_s, TS, q_s, TS, st_s, STS);      // S^T = K Q^T
    mm<BLK, BQ, D, true, false>(v_s, TS, do_s, TS, dpt_s, STS);    // dP^T = V dO^T
    __syncthreads();
    for (int i = tid; i < BLK * BQ; i += THREADS) {
      const int r = i / BQ, c = i - r * BQ;   // key row r, query column c
      float s = st_s[r * STS + c] * a.scale;
      if (a.causal && kb * BLK + r > qi * BQ + c) s = NEG_INF;
      const float p = expf(s - lse_s[c]);
      const float ds = p * (dpt_s[r * STS + c] - dl_s[c]);
      pt_s[r * PTS + c] = p;
      dst_s[r * PTS + c] = ds;
    }
    __syncthreads();
    mm<BLK, D, BQ, false, true>(pt_s, PTS, do_s, TS, dv_s, OS);    // dV += P^T dO
    mm<BLK, D, BQ, false, true>(dst_s, PTS, q_s, TS, dk_s, OS);    // dK += dS^T Q
  }
  __syncthreads();
  store_tile<T, D>(const_cast<T*>(row_ptr<T>(a.t[DK], b, n, kb * BLK)), a.t[DK].ss, dk_s,
                   OS, BLK, a.scale, nullptr);
  store_tile<T, D>(const_cast<T*>(row_ptr<T>(a.t[DV], b, n, kb * BLK)), a.t[DV].ss, dv_s,
                   OS, BLK, 1.f, nullptr);
}

// ---------------------------------------------------------------------------
// backward dQ: one CTA per (64 query rows, b * n); loops over KV blocks
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DqGeom {
  static constexpr int TS = D + PAD;
  static constexpr int SS = BLK + 4;
  static constexpr int OS = D + 4;
  static constexpr size_t TILE = align128(sizeof(T) * BLK * TS);
  static constexpr size_t ACC = align128(sizeof(float) * BLK * OS);
  static constexpr size_t S_BYTES = align128(sizeof(float) * BLK * SS);
  static constexpr size_t ROW = align128(sizeof(float) * BLK);
  // dS overwrites dP in place
  static constexpr size_t SMEM = 4 * TILE + ACC + 2 * S_BYTES + 2 * ROW;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const Args a) {
  using G = DqGeom<T, D>;
  constexpr int TS = G::TS, SS = G::SS, PS = G::SS, OS = G::OS;
  const int n_blk = a.seq / BLK;
  const int qb = n_blk - 1 - blockIdx.x;       // most KV blocks first
  const int bn = blockIdx.y, b = bn / a.heads, n = bn - b * a.heads;
  const int tid = threadIdx.x;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* at = smem;
  T* q_s = reinterpret_cast<T*>(at);  at += G::TILE;
  T* do_s = reinterpret_cast<T*>(at);  at += G::TILE;
  T* k_s = reinterpret_cast<T*>(at);  at += G::TILE;
  T* v_s = reinterpret_cast<T*>(at);  at += G::TILE;
  float* dq_s = reinterpret_cast<float*>(at);  at += G::ACC;
  float* s_s = reinterpret_cast<float*>(at);  at += G::S_BYTES;
  float* dp_s = reinterpret_cast<float*>(at);  at += G::S_BYTES;
  float* lse_s = reinterpret_cast<float*>(at);  at += G::ROW;
  float* dl_s = reinterpret_cast<float*>(at);  at += G::ROW;
  T* ds_s = dp_s;

  load_tile<T, D>(q_s, TS, row_ptr<T>(a.t[Q], b, n, qb * BLK), a.t[Q].ss, BLK);
  load_tile<T, D>(do_s, TS, row_ptr<T>(a.t[DO], b, n, qb * BLK), a.t[DO].ss, BLK);
  const long long row0 = (long long)bn * a.seq + qb * BLK;
  if (tid < BLK) {
    lse_s[tid] = a.lse[row0 + tid];
    dl_s[tid] = a.delta[row0 + tid];
  }
  for (int i = tid; i < BLK * D; i += THREADS) dq_s[(i / D) * OS + i % D] = 0.f;
  const int kv_end = a.causal ? qb + 1 : n_blk;
  for (int kb = 0; kb < kv_end; ++kb) {
    __syncthreads();
    load_tile<T, D>(k_s, TS, row_ptr<T>(a.t[K], b, n, kb * BLK), a.t[K].ss, BLK);
    load_tile<T, D>(v_s, TS, row_ptr<T>(a.t[V], b, n, kb * BLK), a.t[V].ss, BLK);
    __syncthreads();
    mm<BLK, BLK, D, true, false>(q_s, TS, k_s, TS, s_s, SS);       // S = Q K^T
    mm<BLK, BLK, D, true, false>(do_s, TS, v_s, TS, dp_s, SS);     // dP = dO V^T
    __syncthreads();
    for (int i = tid; i < BLK * BLK; i += THREADS) {
      const int r = i / BLK, c = i - r * BLK;   // query row r, key column c
      float s = s_s[r * SS + c] * a.scale;
      if (a.causal && kb * BLK + c > qb * BLK + r) s = NEG_INF;
      const float p = expf(s - lse_s[r]);
      ds_s[r * PS + c] = p * (dp_s[r * SS + c] - dl_s[r]);
    }
    __syncthreads();
    mm<BLK, D, BLK, false, true>(ds_s, PS, k_s, TS, dq_s, OS);     // dQ += dS K
  }
  __syncthreads();
  store_tile<T, D>(const_cast<T*>(row_ptr<T>(a.t[DQ], b, n, qb * BLK)), a.t[DQ].ss, dq_s,
                   OS, BLK, a.scale, nullptr);
}

// ===========================================================================
// bf16: the Hopper kernels
// ===========================================================================

namespace hop {

using bf16 = __nv_bfloat16;
constexpr int HWARPS = 8;                    // 16 rows each
constexpr int ROWS = HWARPS * 16;            // rows a CTA owns
constexpr int HTHREADS = HWARPS * 32;
constexpr int STAGES = 3;                    // ring depth
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of the 16-byte chunk holding (row, col) of a tile of D bf16
// a row; col is a multiple of 8.  Chunk c of row r sits at chunk c ^ (r & 7).
template <int D>
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * (D * 2) + ((((col >> 3) ^ row) & 7) | ((col >> 3) & ~7)) * 16;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// ROWS_T x D bf16 (row stride ss elements) into the swizzled tile at dst,
// shared by NT threads (this one is idx); rows at or past `valid` are
// zero-filled and never read (their source address is `safe`)
template <int D, int ROWS_T, int NT>
__device__ __forceinline__ void copy_tile(uint32_t dst, const bf16* src, long long ss, int valid,
                                          int idx, const void* safe) {
  constexpr int CPR = D / 8;   // 16-byte chunks a row
  if constexpr (NT % CPR == 0 && (ROWS_T * CPR) % NT == 0 && (NT / CPR) % 8 == 0) {
    // each thread keeps one column and steps down by whole swizzle periods
    constexpr int STEP = NT / CPR;
    const int r0 = idx / CPR, c = idx - r0 * CPR;
    const uint32_t d0 = dst + swz<D>(r0, c * 8);
#pragma unroll
    for (int u = 0; u < ROWS_T / STEP; ++u) {
      const int r = r0 + u * STEP;
      const bool ok = r < valid;
      cp_async16(d0 + u * STEP * 2 * D,
                 ok ? static_cast<const void*>(src + r * ss + c * 8) : safe, ok);
    }
  } else {
    for (int i = idx; i < ROWS_T * CPR; i += NT) {
      const int r = i / CPR, c = i - r * CPR;
      const bool ok = r < valid;
      cp_async16(dst + swz<D>(r, c * 8),
                 ok ? static_cast<const void*>(src + r * ss + c * 8) : safe, ok);
    }
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrives on bar once every cp.async this thread issued so far has landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// waits for the phase of the given parity to complete; a wait of more
// than ~2^34 clock cycles (seconds) can only be a fault of the ring's
// protocol, and traps (an error on the caller's stream) rather than hang
// the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1ll << 34))
      __trap();
  }
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
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment addressing (lane = threadIdx.x & 31).  An accumulator c[4] of a
// 16 x 8 tile holds (row g, cols 2t, 2t + 1) and (row g + 8, the same
// cols), g = lane / 4, t = lane % 4; two neighbouring 8-column tiles of it
// are, packed to bf16, the A fragment of a 16-deep product (a_frag).
//
// The lane's part of an ldmatrix address into a swizzled tile is taken
// once (frag_a, frag_b, frag_bt): its row times the row pitch plus its
// swizzled chunk at column block 0.  The 16 x 16 block (r16, c16) is then
// an add and an XOR away: the block column flips the chunk's low bits by
// (c16 % 4) * 2 and moves 8 chunks on per 4 blocks.  Tiles start on a
// 128-byte boundary.
template <int D>
struct Frag {
  uint32_t off;
  __device__ __forceinline__ uint32_t at(uint32_t tile, int r16, int c16) const {
    return ((tile + off + r16 * 32 * D) ^ ((c16 & 3) * 32)) + (c16 >> 2) * 128;
  }
};
// row: the lane's row in a 16 x 16 block (row % 8 == lane % 8); hi: its
// 8-column half
template <int D>
__device__ __forceinline__ Frag<D> frag(int row, int hi, int lane) {
  return {uint32_t(row * 2 * D + ((hi ^ (lane & 7)) << 4))};
}
// A: block (r16, c16) is rows r16 * 16.., columns c16 * 16..
template <int D>
__device__ __forceinline__ Frag<D> frag_a(int lane) {
  return frag<D>(lane & 15, lane >> 4, lane);
}
// B read row-wise (B(k, n) = tile[n][k]; S = Q K^T): block (n16, k16);
// r[0], r[1] feed the 8 columns n16 * 16.., r[2], r[3] the next 8
template <int D>
__device__ __forceinline__ Frag<D> frag_b(int lane) {
  return frag<D>((lane & 7) + (lane >> 4) * 8, (lane >> 3) & 1, lane);
}
// B read column-wise through ldsm4t (B(k, n) = tile[k][n]; O = P V):
// block (k16, n16), the same register order as frag_b
template <int D>
__device__ __forceinline__ Frag<D> frag_bt(int lane) {
  return frag<D>((lane & 7) + ((lane >> 3) & 1) * 8, lane >> 4, lane);
}

__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

// the warp's 16 x D fp32 accumulator, times mul, as bf16 into its 16 rows
// of a swizzled tile (generic pointer), then from there to device memory
// rows row0.. (those below seq), 16 bytes a lane
template <int D>
__device__ __forceinline__ void store_rows(unsigned char* tile, const float (&acc)[D / 8][4],
                                           float mul, bf16* dst, long long ss, int valid,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(tile + swz<D>(g, j * 8) + 4 * t) =
        pack(acc[j][0] * mul, acc[j][1] * mul);
    *reinterpret_cast<uint32_t*>(tile + swz<D>(g + 8, j * 8) + 4 * t) =
        pack(acc[j][2] * mul, acc[j][3] * mul);
  }
  __syncwarp();
  constexpr int CPR = D / 8;
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = i - r * CPR;
    if (r < valid)
      *reinterpret_cast<uint4*>(dst + r * ss + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz<D>(r, c * 8));
  }
}

// the warp's own 16 rows of an operand (rows row0.., those below seq) into
// its slice of a swizzled tile, waited for; read by this warp only
template <int D>
__device__ __forceinline__ void load_own_rows(uint32_t tile, const Operand& x, int b, int n,
                                              int row0, int seq, int lane) {
  copy_tile<D, 16, 32>(tile, row_ptr<bf16>(x, b, n, row0), x.ss, seq - row0, lane, x.p);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  cp_async_wait_all();
  __syncwarp();
}

template <int NSTAGES = STAGES>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGES; ++s) {
      mbar_init(&full[s], HTHREADS);   // every thread's copies
      mbar_init(&empty[s], HWARPS);    // one release per warp
    }
  }
  __syncthreads();
}

// The ring over n streamed blocks: block it goes to stage it % STAGES.
// Every thread copies its share of a block (fill(s, it)) and arrives on
// the stage's full barrier once its copies land; every warp computes on
// the block (body(s, it)) and then releases the stage on its empty
// barrier.  A stage is refilled only after every warp has released it,
// and blocks it + 1 .. it + STAGES - 1 load while block it computes.
template <int NSTAGES = STAGES, typename Fill, typename Body>
__device__ __forceinline__ void pipeline(uint64_t* full, uint64_t* empty, int n, Fill&& fill,
                                         Body&& body) {
  auto issue = [&](int it) {
    const int s = it % NSTAGES, use = it / NSTAGES;
    if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
    fill(s, it);
    mbar_arrive_cp_async(&full[s]);
  };
  for (int it = 0; it < NSTAGES - 1 && it < n; ++it) issue(it);
  for (int it = 0; it < n; ++it) {
    if (it + NSTAGES - 1 < n) issue(it + NSTAGES - 1);
    const int s = it % NSTAGES;
    mbar_wait(&full[s], (it / NSTAGES) & 1);
    body(s, it);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);
  }
}

// ---------------------------------------------------------------------------
// wgmma: the forward's tensor-core products
// ---------------------------------------------------------------------------

// byte offset of (row, col) in a tile of R rows x D bf16 held as D / 64
// panels of R rows x 128 bytes, the 16-byte chunks of each 128-byte row
// XOR-swizzled by row % 8: the layout of wgmma's 128-byte swizzle, which
// a panel base on a 1024-byte boundary keeps
template <int D, int R>
__device__ __forceinline__ uint32_t pan(int row, int col) {
  return (col >> 6) * (R * 128) + row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4) +
         (col & 7) * 2;
}

// ROWS_T x D bf16 (row stride ss elements) into rows row_off.. of the
// R-row panel tile at dst, shared by NT threads (this one is idx); rows at
// or past `valid` are zero-filled and never read (source `safe`)
template <int D, int R, int ROWS_T, int NT>
__device__ __forceinline__ void copy_pan(uint32_t dst, int row_off, const bf16* src,
                                         long long ss, int valid, int idx, const void* safe) {
  constexpr int CPR = D / 8;
#pragma unroll
  for (int i = idx; i < ROWS_T * CPR; i += NT) {
    const int r = i / CPR, c = i - r * CPR;
    const bool ok = r < valid;
    cp_async16(dst + pan<D, R>(row_off + r, c * 8),
               ok ? static_cast<const void*>(src + r * ss + c * 8) : safe, ok);
  }
}

// shared-memory matrix descriptor for wgmma, 128-byte swizzle: start
// address, leading and stride byte offsets
__device__ __forceinline__ uint64_t gdesc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n wgmma.wait_group.sync.aligned 0;\n" ::
                   : "memory");
}
// the accumulator registers are read only after the wait above
template <int M>
__device__ __forceinline__ void reg_fence(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// generic-proxy writes (cp.async) made visible, before the async proxy
// (wgmma) reads them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 64 fp32, this thread's 32) = (acc: +=) A (64 x 16 bf16) x B (16 x 64
// bf16), both in shared memory, K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 128 fp32, this thread's 64) = (acc: +=) A (64 x 16 bf16) x B (16 x 128
// bf16), both in shared memory, K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64 fp32, this thread's 32) += A (64 x 16 bf16, registers) x B (16 x 64
// bf16, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 fp32, this thread's 64) += A (64 x 16 bf16, registers) x B (16 x 128
// bf16, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 192 fp32, this thread's 96) += A (64 x 16 bf16, registers) x B (16 x 192
// bf16, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %101, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256 fp32, this thread's 128) += A (64 x 16 bf16, registers) x B (16 x 256
// bf16, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, acc);
  else wgmma_ss_n128(d, da, db, acc);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (N == 192) wgmma_rs_n192(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// ---------------------------------------------------------------------------
// forward: one CTA per (128 query rows, b * n) of two warpgroups, 64 rows
// each; loops over BN-key blocks.  Any seq >= 1: rows and keys at or past
// seq load as zeros, those keys are masked to NEG_INF before the row max,
// and O and lse are stored for rows below seq only.
// ---------------------------------------------------------------------------

template <int D>
struct Fwd {
  static constexpr int BN = D == 128 ? 128 : 64;   // keys a block
  static constexpr int RING = D >= 256 ? 2 : STAGES;   // ring stages
  static constexpr int MIN_CTAS = D <= 64 ? 2 : 1;
  static constexpr size_t Q_BYTES = ROWS * D * 2;
  static constexpr size_t KV_BYTES = BN * D * 2;
  static constexpr size_t STAGE = 2 * KV_BYTES;   // K, then V
  // + the barriers, + slack to put the tiles on a 1024-byte boundary
  static constexpr size_t SMEM = Q_BYTES + RING * STAGE + 128 + 1024;
};

template <int D>
__global__ void __launch_bounds__(HTHREADS, Fwd<D>::MIN_CTAS) flash_fwd_bf16(const Args a) {
  using G = Fwd<D>;
  constexpr int BN = G::BN;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int n_q = (a.seq + ROWS - 1) / ROWS;
  const int qb = n_q - 1 - blockIdx.x;   // most KV blocks first
  const int bn = blockIdx.y, b = bn / a.heads, n = bn - b * a.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2;
  const int n_kv = (a.seq + BN - 1) / BN;
  const int kv_end = a.causal ? min(n_kv, (qb * ROWS + ROWS - 1) / BN + 1) : n_kv;
  unsigned char* ring = smem + G::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G::RING * G::STAGE);
  uint64_t* empty = full + G::RING;
  init_ring<G::RING>(full, empty);

  const int wrow0 = qb * ROWS + wg * 64;            // the warpgroup's first row
  const int row0 = wrow0 + (warp & 3) * 16;         // this warp's first row
  const bool active = wrow0 < a.seq;                // (uniform in a warpgroup)
  const int g = lane >> 2, t = lane & 3;
  const uint32_t q_s = smem_u32(smem);
  // each warp loads its 16 rows of Q (zeros past seq); the warpgroup's
  // products read all 64
  copy_pan<D, ROWS, 16, 32>(q_s, warp * 16, row_ptr<bf16>(a.t[Q], b, n, row0), a.t[Q].ss,
                            a.seq - row0, lane, a.t[Q].p);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  const float sl2 = a.scale * LOG2E;
  float o[D / 2] = {};
  float m2[2] = {NEG_INF, NEG_INF};   // running max of rows g, g + 8 (base 2)
  float l[2] = {0.f, 0.f};            // this thread's share of the row sums
  const Operand &k = a.t[K], &v = a.t[V];
  pipeline<G::RING>(full, empty, kv_end, [&](int s, int kb) {
    const uint32_t dst = smem_u32(ring + s * G::STAGE);
    const int valid = a.seq - kb * BN;
    copy_pan<D, BN, BN, HTHREADS>(dst, 0, row_ptr<bf16>(k, b, n, kb * BN), k.ss, valid,
                                  threadIdx.x, k.p);
    copy_pan<D, BN, BN, HTHREADS>(dst + G::KV_BYTES, 0, row_ptr<bf16>(v, b, n, kb * BN), v.ss,
                                  valid, threadIdx.x, v.p);
  }, [&](int s, int kb) {
      const int key0 = kb * BN;
      // causal: every key of the block above the warpgroup's rows
      if (!active || (a.causal && key0 > wrow0 + 63)) return;
      const uint32_t k_s = smem_u32(ring + s * G::STAGE), v_s = k_s + G::KV_BYTES;
      fence_proxy_async();
      // S = Q K^T: the warpgroup's 64 rows against the block's BN keys
      float sc[BN / 2] = {};
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN>(sc,
                     gdesc(q_s + (kk >> 2) * (ROWS * 128) + wg * 64 * 128 + (kk & 3) * 32, 16,
                           1024),
                     gdesc(k_s + (kk >> 2) * (BN * 128) + (kk & 3) * 32, 16, 1024), kk > 0);
      wg_commit_wait();
      reg_fence(sc);
      // sc[4 j + e]: row g + 8 (e / 2), key 8 j + 2 t + e % 2 of this warp's 16
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] *= sl2;
      // keys past seq and, causal, above the diagonal to NEG_INF
      if (key0 + BN > a.seq || (a.causal && key0 + BN - 1 > row0)) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int key = key0 + (i >> 2) * 8 + 2 * t + (i & 1);
          if (key >= a.seq || (a.causal && key > row0 + g + ((i >> 1) & 1) * 8)) sc[i] = NEG_INF;
        }
      }
      float mx[2] = {m2[0], m2[1]};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = exp2f(m2[h] - mx[h]);
        m2[h] = mx[h];
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const float p = exp2f(sc[i] - m2[(i >> 1) & 1]);
        l[(i >> 1) & 1] += p;   // the row sum of the unrounded P
        sc[i] = p;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      // O += P V: P rounded to bf16 in registers is the A operand
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)   // V: MN-major, panels BN * 128 bytes apart
        wgmma_rs<D>(o, pa[kk], gdesc(v_s + kk * 16 * 128, BN * 128, 1024));
      wg_commit_wait();
      reg_fence(o);
    });
  if (!active || row0 >= a.seq) return;
  float l_safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l_safe[h] = l[h] == 0.f ? 1.f : l[h];
    const int row = row0 + g + 8 * h;
    const float m = m2[h] == NEG_INF ? NEG_INF : m2[h] * LN2;
    if (t == 0 && row < a.seq) a.lse[(long long)bn * a.seq + row] = m + logf(l_safe[h]);
  }
  // O = acc / l, as bf16 through this warp's 16 rows of the Q tile (the
  // warpgroup's last product, which read them, is complete), then to
  // device memory 16 bytes a lane
  const int qr = warp * 16;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(smem + pan<D, ROWS>(qr + g + 8 * h, j * 8 + 2 * t)) =
          pack(o[4 * j + 2 * h] / l_safe[h], o[4 * j + 2 * h + 1] / l_safe[h]);
  __syncwarp();
  bf16* dst = const_cast<bf16*>(row_ptr<bf16>(a.t[O], b, n, row0));
  constexpr int CPR = D / 8;
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = i - r * CPR;
    if (row0 + r < a.seq)
      *reinterpret_cast<uint4*>(dst + r * a.t[O].ss + c * 8) =
          *reinterpret_cast<const uint4*>(smem + pan<D, ROWS>(qr + r, c * 8));
  }
}

// ---------------------------------------------------------------------------
// backward dK/dV: one CTA per (128 key rows, b * n); loops over BQ-row
// query blocks.  seq is a multiple of 64: a warp's 16 key rows lie wholly
// below seq or wholly past it (then it only keeps the ring turning).
// ---------------------------------------------------------------------------

template <int D, int BQ>
struct Dkv {
  static constexpr size_t KV_BYTES = ROWS * D * 2;
  static constexpr size_t QT = BQ * D * 2;            // Q, dO
  static constexpr size_t VEC = align128(BQ * 4);     // lse, delta
  static constexpr size_t STAGE = 2 * QT + 2 * VEC;
  static constexpr size_t SMEM = 2 * KV_BYTES + STAGES * STAGE + 128;
};

template <int D, int BQ>
__global__ void __launch_bounds__(HTHREADS, 1) flash_bwd_dkv_bf16(const Args a) {
  using G = Dkv<D, BQ>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int kb = blockIdx.x;   // causal: block 0 has most work
  const int bn = blockIdx.y, b = bn / a.heads, n = bn - b * a.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_q = a.seq / BQ;
  // causal: query blocks wholly before this key block see none of it
  const int qi0 = a.causal ? kb * ROWS / BQ : 0;
  unsigned char* ring = smem + 2 * G::KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * G::STAGE);
  uint64_t* empty = full + STAGES;
  const long long vec0 = (long long)bn * a.seq;
  init_ring(full, empty);

  const int key0 = kb * ROWS + warp * 16;   // this warp's first key row
  const bool active = key0 < a.seq;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* k_tile = smem + warp * 16 * D * 2;
  unsigned char* v_tile = k_tile + G::KV_BYTES;
  const uint32_t k_s = smem_u32(k_tile), v_s = smem_u32(v_tile);
  if (active) {
    load_own_rows<D>(k_s, a.t[K], b, n, key0, a.seq, lane);
    load_own_rows<D>(v_s, a.t[V], b, n, key0, a.seq, lane);
  }
  const Frag<D> fa = frag_a<D>(lane), fb = frag_b<D>(lane), ft = frag_bt<D>(lane);
  const float sl2 = a.scale * LOG2E;
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  const Operand &q = a.t[Q], &dout = a.t[DO];
  // the ring streams Q, dO, lse and delta of each query block
  pipeline(full, empty, n_q - qi0, [&](int s, int it) {
    const int qi = qi0 + it;
    const uint32_t dst = smem_u32(ring + s * G::STAGE);
    copy_tile<D, BQ, HTHREADS>(dst, row_ptr<bf16>(q, b, n, qi * BQ), q.ss, BQ, threadIdx.x, q.p);
    copy_tile<D, BQ, HTHREADS>(dst + G::QT, row_ptr<bf16>(dout, b, n, qi * BQ), dout.ss, BQ,
                               threadIdx.x, dout.p);
    for (int c = threadIdx.x; c < 2 * BQ / 4; c += HTHREADS) {
      const bool is_lse = c < BQ / 4;
      const int cc = is_lse ? c : c - BQ / 4;
      const float* src = (is_lse ? a.lse : a.delta) + vec0 + qi * BQ + cc * 4;
      cp_async16(dst + 2 * G::QT + (is_lse ? 0 : G::VEC) + cc * 16, src, true);
    }
  }, [&](int s, int it) {
      const int q0 = (qi0 + it) * BQ;
      // causal: every query of the block before this warp's keys
      if (!active || (a.causal && q0 + BQ - 1 < key0)) return;
      const uint32_t q_s = smem_u32(ring + s * G::STAGE), do_s = q_s + G::QT;
      const float* lse_s = reinterpret_cast<const float*>(ring + s * G::STAGE + 2 * G::QT);
      const float* dl_s = lse_s + G::VEC / 4;
      // S^T = K Q^T and dP^T = V dO^T, keys as rows
      float st[BQ / 8][4] = {}, dpt[BQ / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        ldsm4(ka, fa.at(k_s, 0, kk));
        ldsm4(va, fa.at(v_s, 0, kk));
#pragma unroll
        for (int nn = 0; nn < BQ / 16; ++nn) {
          uint32_t qf[4], df[4];
          ldsm4(qf, fb.at(q_s, nn, kk));
          mma(st[2 * nn], ka, qf[0], qf[1]);
          mma(st[2 * nn + 1], ka, qf[2], qf[3]);
          ldsm4(df, fb.at(do_s, nn, kk));
          mma(dpt[2 * nn], va, df[0], df[1]);
          mma(dpt[2 * nn + 1], va, df[2], df[3]);
        }
      }
      // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta); lse and delta
      // are per query, the column here
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[j][e] = exp2f(fmaf(st[j][e], sl2, -lse_s[j * 8 + 2 * t + (e & 1)] * LOG2E));
      if (a.causal && key0 + 15 > q0) {   // keys after the query: P = 0
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key0 + g + (e >> 1) * 8 > q0 + j * 8 + 2 * t + (e & 1)) st[j][e] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[j][e] = st[j][e] * (dpt[j][e] - dl_s[j * 8 + 2 * t + (e & 1)]);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], da[4];   // P^T and dS^T rounded to bf16
        a_frag(pa, st[2 * kk], st[2 * kk + 1]);
        a_frag(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t of[4], qf[4];
          ldsm4t(of, ft.at(do_s, kk, dn));   // dV += P^T dO
          mma(dv[2 * dn], pa, of[0], of[1]);
          mma(dv[2 * dn + 1], pa, of[2], of[3]);
          ldsm4t(qf, ft.at(q_s, kk, dn));    // dK += dS^T Q
          mma(dk[2 * dn], da, qf[0], qf[1]);
          mma(dk[2 * dn + 1], da, qf[2], qf[3]);
        }
      }
    });
  if (!active) return;
  store_rows<D>(k_tile, dk, a.scale,
                const_cast<bf16*>(row_ptr<bf16>(a.t[DK], b, n, key0)), a.t[DK].ss, 16, lane);
  store_rows<D>(v_tile, dv, 1.f, const_cast<bf16*>(row_ptr<bf16>(a.t[DV], b, n, key0)),
                a.t[DV].ss, 16, lane);
}

// ---------------------------------------------------------------------------
// backward dQ: one CTA per (128 query rows, b * n); loops over BN-key
// blocks; seq a multiple of 64, as in dK/dV
// ---------------------------------------------------------------------------

template <int D, int BN>
struct Dq {
  static constexpr size_t Q_BYTES = ROWS * D * 2;    // Q, dO
  static constexpr size_t KV_BYTES = BN * D * 2;
  static constexpr size_t STAGE = 2 * KV_BYTES;      // K, then V
  static constexpr size_t SMEM = 2 * Q_BYTES + STAGES * STAGE + 128;
};

template <int D, int BN>
__global__ void __launch_bounds__(HTHREADS, 1) flash_bwd_dq_bf16(const Args a) {
  using G = Dq<D, BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_q = (a.seq + ROWS - 1) / ROWS;
  const int qb = n_q - 1 - blockIdx.x;   // most KV blocks first
  const int bn = blockIdx.y, b = bn / a.heads, n = bn - b * a.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_kv = a.seq / BN;
  const int kv_end = a.causal ? min(n_kv, (qb * ROWS + ROWS - 1) / BN + 1) : n_kv;
  unsigned char* ring = smem + 2 * G::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * G::STAGE);
  uint64_t* empty = full + STAGES;
  init_ring(full, empty);

  const int row0 = qb * ROWS + warp * 16;
  const bool active = row0 < a.seq;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* q_tile = smem + warp * 16 * D * 2;
  const uint32_t q_s = smem_u32(q_tile), do_s = q_s + G::Q_BYTES;
  float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};   // rows g, g + 8
  if (active) {
    load_own_rows<D>(q_s, a.t[Q], b, n, row0, a.seq, lane);
    load_own_rows<D>(do_s, a.t[DO], b, n, row0, a.seq, lane);
    const long long r = (long long)bn * a.seq + row0 + g;
    lse2[0] = a.lse[r] * LOG2E;
    lse2[1] = a.lse[r + 8] * LOG2E;
    dl[0] = a.delta[r];
    dl[1] = a.delta[r + 8];
  }
  const Frag<D> fa = frag_a<D>(lane), fb = frag_b<D>(lane), ft = frag_bt<D>(lane);
  const float sl2 = a.scale * LOG2E;
  float dq[D / 8][4] = {};
  const Operand &k = a.t[K], &v = a.t[V];
  pipeline(full, empty, kv_end, [&](int s, int kb) {
    const uint32_t dst = smem_u32(ring + s * G::STAGE);
    copy_tile<D, BN, HTHREADS>(dst, row_ptr<bf16>(k, b, n, kb * BN), k.ss, BN, threadIdx.x, k.p);
    copy_tile<D, BN, HTHREADS>(dst + G::KV_BYTES, row_ptr<bf16>(v, b, n, kb * BN), v.ss, BN,
                               threadIdx.x, v.p);
  }, [&](int s, int kb) {
      const int key0 = kb * BN;
      if (!active || (a.causal && key0 > row0 + 15)) return;
      const uint32_t k_s = smem_u32(ring + s * G::STAGE), v_s = k_s + G::KV_BYTES;
      float sc[BN / 8][4] = {}, dp[BN / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {   // S = Q K^T, dP = dO V^T
        uint32_t qa[4], da[4];
        ldsm4(qa, fa.at(q_s, 0, kk));
        ldsm4(da, fa.at(do_s, 0, kk));
#pragma unroll
        for (int nn = 0; nn < BN / 16; ++nn) {
          uint32_t kf[4], vf[4];
          ldsm4(kf, fb.at(k_s, nn, kk));
          mma(sc[2 * nn], qa, kf[0], kf[1]);
          mma(sc[2 * nn + 1], qa, kf[2], kf[3]);
          ldsm4(vf, fb.at(v_s, nn, kk));
          mma(dp[2 * nn], da, vf[0], vf[1]);
          mma(dp[2 * nn + 1], da, vf[2], vf[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = exp2f(fmaf(sc[j][e], sl2, -lse2[e >> 1]));
      if (a.causal && key0 + BN - 1 > row0) {   // keys after the query: P = 0
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key0 + j * 8 + 2 * t + (e & 1) > row0 + g + (e >> 1) * 8) sc[j][e] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = sc[j][e] * (dp[j][e] - dl[e >> 1]);   // dS
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {   // dQ += dS K, dS rounded to bf16
        uint32_t dsa[4];
        a_frag(dsa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t kf[4];
          ldsm4t(kf, ft.at(k_s, kk, dn));
          mma(dq[2 * dn], dsa, kf[0], kf[1]);
          mma(dq[2 * dn + 1], dsa, kf[2], kf[3]);
        }
      }
    });
  if (!active) return;
  store_rows<D>(q_tile, dq, a.scale,
                const_cast<bf16*>(row_ptr<bf16>(a.t[DQ], b, n, row0)), a.t[DQ].ss, 16, lane);
}

}  // namespace hop

// ===========================================================================
// launch
// ===========================================================================

enum Which { FWD = 0, BWD_DKV = 1, BWD_DQ = 2 };

// a kernel and its launch geometry: one CTA per `rows` rows of each head
struct Kernel {
  void (*fn)(const Args);
  size_t smem;
  int threads, rows;
};

template <int D>
Kernel f32_kernel(int which) {
  if (which == FWD) return {flash_fwd_kernel<float, D>, FwdGeom<float, D>::SMEM, THREADS, BLK};
  if (which == BWD_DKV)
    return {flash_bwd_dkv_kernel<float, D>, DkvGeom<float, D>::SMEM, THREADS, BLK};
  return {flash_bwd_dq_kernel<float, D>, DqGeom<float, D>::SMEM, THREADS, BLK};
}

// the forward: two warpgroups on wgmma
template <int D>
Kernel bf16_fwd() {
  return {hop::flash_fwd_bf16<D>, hop::Fwd<D>::SMEM, hop::HTHREADS, hop::ROWS};
}

// the dK/dV kernel streams 64-row query blocks, the dQ kernel 64-key blocks
template <int D>
Kernel bf16_bwd(int which) {
  constexpr int BQ = 64;
  if (which == BWD_DKV)
    return {hop::flash_bwd_dkv_bf16<D, BQ>, hop::Dkv<D, BQ>::SMEM, hop::HTHREADS, hop::ROWS};
  return {hop::flash_bwd_dq_bf16<D, 64>, hop::Dq<D, 64>::SMEM, hop::HTHREADS, hop::ROWS};
}

// fp32: head_dim 64, 128; bf16: 64, 128, 192, 256 forward, 64, 128
// backward; anything else has no kernel (fn null)
Kernel select(int which, int dtype, int head_dim) {
  if (dtype == 0) {
    if (head_dim == 64) return f32_kernel<64>(which);
    if (head_dim == 128) return f32_kernel<128>(which);
  } else if (dtype == 1 && which == FWD) {
    if (head_dim == 64) return bf16_fwd<64>();
    if (head_dim == 128) return bf16_fwd<128>();
    if (head_dim == 192) return bf16_fwd<192>();
    if (head_dim == 256) return bf16_fwd<256>();
  } else if (dtype == 1) {
    if (head_dim == 64) return bf16_bwd<64>(which);
    if (head_dim == 128) return bf16_bwd<128>(which);
  }
  return {nullptr, 0, 0, 0};
}

cudaError_t allow_smem(const Kernel& k) {
  if (k.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k.smem);
}

int run(int which, int device, int dtype, int head_dim, int causal, int batch, int heads,
        int seq, float scale, const void* const* ptrs, const long long* strides,
        void* stream) {
  // the backward kernels take whole 64-row blocks; the forward any seq
  if (seq < 1 || (which != FWD && seq % BLK != 0) || batch < 1 || heads < 1 ||
      (long long)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Args a;
  for (int i = 0; i < NUM_OPERANDS; ++i)
    a.t[i] = Operand{ptrs[i], strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.lse = static_cast<float*>(const_cast<void*>(ptrs[NUM_OPERANDS]));
  a.delta = static_cast<const float*>(ptrs[NUM_OPERANDS + 1]);
  a.heads = heads;
  a.seq = seq;
  a.scale = scale;
  a.causal = causal;
  const Kernel k = select(which, dtype, head_dim);
  if (!k.fn) return (int)cudaErrorInvalidValue;
  e = allow_smem(k);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((seq + k.rows - 1) / k.rows, batch * heads);
  k.fn<<<grid, k.threads, k.smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// device: the CUDA device index every pointer lives on (this library links
// its own CUDA runtime, whose current device is not PyTorch's).  dtype:
// 0 = float32 (head_dim 64 or 128), 1 = bfloat16 (head_dim 64, 128, 192 or
// 256 for the forward, 64 or 128 for the backward); seq >= 1 for the
// forward, a multiple of 64 for the backward.
// ptrs: 10 device pointers in the order q, k, v, o, do, dq, dk, dv (each
// [batch, heads, seq, head_dim] through its strides), lse, delta ([batch *
// heads, seq] fp32, contiguous, 16-byte aligned); an entry a kernel does
// not use may be null.  strides: 24 element strides, (batch, head, row) for
// each of the eight operands in the same order.  Each returns a cudaError_t
// (0 on success).
//   forward: reads q, k, v; writes o and lse;
//   dK/dV:   reads q, k, v, do, lse, delta; writes dk, dv;
//   dQ:      reads q, k, v, do, lse, delta; writes dq.
int flash_attention_fwd(int device, int dtype, int head_dim, int causal, int batch,
                        int heads, int seq, float scale, const void* const* ptrs,
                        const long long* strides, void* stream) {
  return run(FWD, device, dtype, head_dim, causal, batch, heads, seq, scale, ptrs,
             strides, stream);
}

int flash_attention_bwd_dkv(int device, int dtype, int head_dim, int causal, int batch,
                            int heads, int seq, float scale, const void* const* ptrs,
                            const long long* strides, void* stream) {
  return run(BWD_DKV, device, dtype, head_dim, causal, batch, heads, seq, scale, ptrs,
             strides, stream);
}

int flash_attention_bwd_dq(int device, int dtype, int head_dim, int causal, int batch,
                           int heads, int seq, float scale, const void* const* ptrs,
                           const long long* strides, void* stream) {
  return run(BWD_DQ, device, dtype, head_dim, causal, batch, heads, seq, scale, ptrs,
             strides, stream);
}

// what a launch of kernel `which` (0 forward, 1 dK/dV, 2 dQ) at this dtype
// and head_dim runs: info[0] its dynamic shared memory per CTA (bytes),
// [1] registers per thread, [2] CTAs resident per SM, [3] threads per
// CTA, [4] local memory per thread (bytes; spills).  Returns a cudaError_t.
int flash_attention_kernel_info(int device, int which, int dtype, int head_dim, int* info) {
  const Kernel k = select(which, dtype, head_dim);
  if (!k.fn) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = allow_smem(k);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, k.fn);
  int ctas = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, k.fn, k.threads, k.smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = (int)k.smem;
  info[1] = attr.numRegs;
  info[2] = ctas;
  info[3] = k.threads;
  info[4] = (int)attr.localSizeBytes;
  return 0;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
