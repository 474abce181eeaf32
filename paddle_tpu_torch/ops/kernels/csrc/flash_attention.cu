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
//
// What bounds it on this card: operations.  At the trained shape (B 8,
// N 16, S 1024, D 128, bf16, causal) the forward does 34 GFLOP on 134 MB
// (about 256 operations per byte) and the backward, least work, 86 GFLOP
// on 268 MB: near or above the ~295 operations per byte where Hopper's
// bf16 tensor cores, not its memory, become the limit.  This first
// version is right and simple; its design:
//   - one CTA of 4 warps per (b * n, 64-row block): the forward and dQ
//     kernels own 64 query rows and loop over KV blocks, the dK/dV kernel
//     owns 64 key rows and loops over query blocks (64 rows in bf16, 32 in
//     fp32, to fit shared memory); nothing is carried between CTAs, so
//     the TPU grid's sequential accumulation becomes this inner loop;
//   - every tile is staged in shared memory; bf16 products run on the
//     tensor cores through WMMA 16x16x16 fragments (fp32 accumulate), fp32
//     products as register-blocked FMA; scores, probabilities and the
//     running O / dK / dV / dQ sums live in fp32 shared memory, so the
//     softmax and the dS arithmetic are plain per-element code;
//   - q, k, v, dO and every output are read and written through their
//     own (batch, head, row) strides, so the views into the fused QKV
//     output [B, S, 3, N, D] need no copy;
//   - causal CTAs with the most blocks are scheduled first.
// wgmma, TMA, register-resident accumulators and overlapping the next
// tile's loads with this tile's products are left for later work.
//
// Interface: plain C, loaded through ctypes by
// paddle_tpu_torch/ops/kernels/flash_attention.py.  Launches go on the
// caller's stream, allocate nothing and return the cudaError_t.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "vec16.cuh"

namespace {

constexpr int THREADS = 128;   // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int BLK = 64;        // rows of the block a CTA owns
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

template <typename T> struct Tr;
template <> struct Tr<float> {
  static constexpr int PAD = 4;    // shared-memory row padding (elements)
  static __device__ float from_f(float x) { return x; }
};
template <> struct Tr<__nv_bfloat16> {
  static constexpr int PAD = 8;
  static __device__ __nv_bfloat16 from_f(float x) { return __float2bfloat16(x); }
};

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
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

template <typename T>
__device__ __forceinline__ const T* row_ptr(const Operand& x, int b, int n, int row) {
  return static_cast<const T*>(x.p) + b * x.sb + n * x.sn + (long long)row * x.ss;
}

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

// bf16: tensor cores through WMMA 16x16x16 fragments, fp32 accumulate;
// the warps share out the 16x16 output tiles
template <int M, int N, int K, bool BT, bool ACC>
__device__ void mm(const __nv_bfloat16* a, int lda, const __nv_bfloat16* b, int ldb,
                   float* c, int ldc) {
  using namespace nvcuda;
  static_assert(M % 16 == 0 && N % 16 == 0 && K % 16 == 0, "wmma tiling");
  constexpr int TN = N / 16, TILES = (M / 16) * TN;
  using BLayout = typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < TILES; t += WARPS) {
    const int tm = t / TN, tn = t - tm * TN;
    float* cp = c + tm * 16 * ldc + tn * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (ACC)
      wmma::load_matrix_sync(acc, cp, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> fb;
      wmma::load_matrix_sync(fa, a + tm * 16 * lda + k, lda);
      wmma::load_matrix_sync(fb, BT ? b + tn * 16 * ldb + k : b + k * ldb + tn * 16, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(cp, acc, ldc, wmma::mem_row_major);
  }
}

// ---------------------------------------------------------------------------
// forward: one CTA per (64 query rows, b * n); loops over KV blocks.  Any
// seq >= 1: the last block's rows and keys at or past seq load as zeros,
// those keys are masked to NEG_INF before the row max, and O and lse are
// stored for rows below seq only.
// ---------------------------------------------------------------------------

template <typename T, int D>
struct FwdGeom {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int TS = D + Tr<T>::PAD;       // q/k/v row stride
  static constexpr int SS = BLK + 4;               // fp32 score row stride
  static constexpr int PS = F32 ? SS : BLK + 8;    // P row stride (T)
  static constexpr int OS = D + 4;                 // fp32 O row stride
  static constexpr size_t TILE = align128(sizeof(T) * BLK * TS);
  static constexpr size_t S_BYTES = align128(sizeof(float) * BLK * SS);
  static constexpr size_t O_BYTES = align128(sizeof(float) * BLK * OS);
  static constexpr size_t ROW = align128(sizeof(float) * BLK);
  // fp32: P overwrites S in place
  static constexpr size_t P_BYTES = F32 ? 0 : align128(sizeof(T) * BLK * PS);
  static constexpr size_t SMEM = 3 * TILE + S_BYTES + O_BYTES + 3 * ROW + P_BYTES;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Args a) {
  using G = FwdGeom<T, D>;
  constexpr int TS = G::TS, SS = G::SS, PS = G::PS, OS = G::OS;
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
  T* p_s = G::F32 ? reinterpret_cast<T*>(s_s)
                  : reinterpret_cast<T*>(smem + G::SMEM - G::P_BYTES);

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
        p_s[r * PS + lane + 32 * j] = Tr<T>::from_f(p);   // P in the V dtype
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
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int BQ = F32 ? 32 : 64;         // query rows per step
  static constexpr int TS = D + Tr<T>::PAD;
  static constexpr int STS = BQ + 4;               // fp32 S^T / dP^T stride
  static constexpr int PTS = F32 ? STS : BQ + 8;   // P^T / dS^T stride (T)
  static constexpr int OS = D + 4;
  static constexpr size_t KV_TILE = align128(sizeof(T) * BLK * TS);
  static constexpr size_t Q_TILE = align128(sizeof(T) * BQ * TS);
  static constexpr size_t ACC = align128(sizeof(float) * BLK * OS);
  static constexpr size_t ST = align128(sizeof(float) * BLK * STS);
  static constexpr size_t ROW = align128(sizeof(float) * BQ);
  // fp32: P^T and dS^T overwrite S^T and dP^T in place
  static constexpr size_t PT = F32 ? 0 : align128(sizeof(T) * BLK * PTS);
  static constexpr size_t SMEM = 2 * KV_TILE + 2 * ACC + 2 * Q_TILE + 2 * ST + 2 * ROW + 2 * PT;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(const Args a) {
  using G = DkvGeom<T, D>;
  constexpr int BQ = G::BQ, TS = G::TS, STS = G::STS, PTS = G::PTS, OS = G::OS;
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
  T* pt_s = G::F32 ? reinterpret_cast<T*>(st_s) : reinterpret_cast<T*>(at);
  T* dst_s = G::F32 ? reinterpret_cast<T*>(dpt_s) : reinterpret_cast<T*>(at + G::PT);

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
      pt_s[r * PTS + c] = Tr<T>::from_f(p);     // P in the dO dtype
      dst_s[r * PTS + c] = Tr<T>::from_f(ds);   // dS in the q dtype
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
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int TS = D + Tr<T>::PAD;
  static constexpr int SS = BLK + 4;
  static constexpr int PS = F32 ? SS : BLK + 8;
  static constexpr int OS = D + 4;
  static constexpr size_t TILE = align128(sizeof(T) * BLK * TS);
  static constexpr size_t ACC = align128(sizeof(float) * BLK * OS);
  static constexpr size_t S_BYTES = align128(sizeof(float) * BLK * SS);
  static constexpr size_t ROW = align128(sizeof(float) * BLK);
  // fp32: dS overwrites dP in place
  static constexpr size_t DS = F32 ? 0 : align128(sizeof(T) * BLK * PS);
  static constexpr size_t SMEM = 4 * TILE + ACC + 2 * S_BYTES + 2 * ROW + DS;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const Args a) {
  using G = DqGeom<T, D>;
  constexpr int TS = G::TS, SS = G::SS, PS = G::PS, OS = G::OS;
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
  T* ds_s = G::F32 ? reinterpret_cast<T*>(dp_s) : reinterpret_cast<T*>(at);

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
      ds_s[r * PS + c] = Tr<T>::from_f(p * (dp_s[r * SS + c] - dl_s[r]));  // in the k dtype
    }
    __syncthreads();
    mm<BLK, D, BLK, false, true>(ds_s, PS, k_s, TS, dq_s, OS);     // dQ += dS K
  }
  __syncthreads();
  store_tile<T, D>(const_cast<T*>(row_ptr<T>(a.t[DQ], b, n, qb * BLK)), a.t[DQ].ss, dq_s,
                   OS, BLK, a.scale, nullptr);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum Which { FWD = 0, BWD_DKV = 1, BWD_DQ = 2 };

template <typename T, int D>
int launch(int which, const Args& a, int bn, cudaStream_t stream) {
  void (*kernel)(const Args);
  size_t smem;
  if (which == FWD) {
    kernel = flash_fwd_kernel<T, D>;
    smem = FwdGeom<T, D>::SMEM;
  } else if (which == BWD_DKV) {
    kernel = flash_bwd_dkv_kernel<T, D>;
    smem = DkvGeom<T, D>::SMEM;
  } else {
    kernel = flash_bwd_dq_kernel<T, D>;
    smem = DqGeom<T, D>::SMEM;
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((a.seq + BLK - 1) / BLK, bn);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_head_dim(int head_dim, int which, const Args& a, int bn, cudaStream_t s) {
  switch (head_dim) {
    case 64: return launch<T, 64>(which, a, bn, s);
    case 128: return launch<T, 128>(which, a, bn, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_head_dim<float>(head_dim, which, a, batch * heads, s);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16>(head_dim, which, a, batch * heads, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// device: the CUDA device index every pointer lives on (this library links
// its own CUDA runtime, whose current device is not PyTorch's).  dtype:
// 0 = float32, 1 = bfloat16; head_dim 64 or 128; seq >= 1 for the
// forward, a multiple of 64 for the backward.
// ptrs: 10 device pointers in the order q, k, v, o, do, dq, dk, dv (each
// [batch, heads, seq, head_dim] through its strides), lse, delta ([batch *
// heads, seq] fp32, contiguous); an entry a kernel does not use may be
// null.  strides: 24 element strides, (batch, head, row) for each of the
// eight operands in the same order.  Each returns a cudaError_t (0 on
// success).
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

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
