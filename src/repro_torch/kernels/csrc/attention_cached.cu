// Attention over a KV cache with per-row positions, for Hopper (sm_90a).
//
// No TPU kernel stands behind this one: the reference computes it in XLA
// (`_sdpa_chunked` with `kv_positions` / `kv_valid`,
// src/repro/models/layers.py:126-176), on the decode and ring-buffer paths
// of `attention` (:204-256). The port's flash kernel cannot express it: its
// queries always sit at the tail of one shared key range and its rows have
// no per-row length. This kernel computes exactly
// `ref.attention_positions_ref`:
// * q (B, H, Sq, D), k and v (B, Hkv, Sk, D) views with any strides whose
//   last dimension is contiguous; q_pos (B, Sq) and kv_pos (B, Sk) int32.
// * Key slot j is visible to query i of row b when kv_pos[b, j] >= 0, and
//   rel = q_pos[b, i] - kv_pos[b, j] >= 0 if causal, and rel < window if
//   window > 0.
// * Scores, running max, sum and accumulator in f32, scale 1/sqrt(D); GQA:
//   q head h reads kv head h / G. The output takes q's type. A row with no
//   visible key comes out as 0.
//
// What bounds it on an H100: a decode step reads the valid K and V of every
// (b, kv head) once and does 4*G*D operations per key and kv head: at
// granite-3-2b's decode (B = 8, Hkv = 8, G = 4, D = 64, bf16) that is 8
// operations per byte, far under the ridge, so it is bound by bytes: 8.4 MB
// of K and V at a mean length of 512 take 2.5 us at 3.35 TB/s. A ring
// prefill chunk (G * Sq = 1200 rows a kv head) does ~1200 operations a
// byte but over few keys a row: still bytes, at well under a microsecond.
//
// Two kernels, chosen by the input type:
// * bf16 (every serving path): tensor cores, mma.sync m16n8k16 with f32
//   accumulation (helpers and fragment layouts: tensor_core.cuh).
//   - Rows. A block of four warps owns up to 64 rows of one (b, kv head)
//     and one key range: row r is query head kvh*G + r / Sq at query
//     r % Sq, so every decode shape (G * Sq <= 64) reads its K and V once;
//     a ring prefill of 1200 rows a kv head reads them 19 times. Each 16
//     rows are one row group. With 16 or fewer rows (every decode shape
//     but granite-34b's G = 48) the four warps share the one row group and
//     each takes 16 of a tile's 64 keys; with 17-32 rows two warps share
//     each of two row groups (32 keys each); above, each warp owns a row
//     group and all 64 keys (KS, the key slices, is 4, 2 or 1). Each warp
//     keeps its own (m, l, O); the block merges its warps' through shared
//     memory at the end. (The other design, keys on the mma's 16-row side
//     and rows on its 8-wide side, would put P in the transposed layout
//     of P.V's A operand: a trip through shared memory a tile.)
//   - Tiles. A block first reads the positions of its key range, 32 tiles
//     of 64 slots at a time, and keeps each tile's count of valid slots and
//     the min and max of their positions. A tile that no row of the block
//     can see is never copied: a ragged cache's empty tail costs one read
//     of its positions. Each warp then classifies each copied tile for its
//     own rows (`tile_class`, mirrored by `tile_class` in
//     kernels/attention_cached.py): skip (no pair visible), full (every
//     slot valid and every pair visible: no mask test) or masked (each pair
//     tested in the fragment layout). Only min and max are used: a wrapped
//     ring's slots are not in position order.
//   - Staging. K and V tiles arrive by 16-byte cp.async (slots past Sk
//     zero-filled) with the tile's 64 positions in the same copy group,
//     into a ring of NST = 2 bf16 stages whose row pitch, D + 8 elements,
//     keeps the ldmatrix reads free of bank conflicts; the next tile's
//     copies are in flight while this one is multiplied. Q arrives once,
//     the same way. Three or four stages (NST - 1 tiles in flight) timed
//     within a microsecond of two at every check shape: a block's time
//     is its chain of steps (barrier, products, softmax), ~0.6 us a tile
//     at decode, not the copies' latency (PERF.md §6, PR 19).
//   - Products. S = Q.K^T takes Q's A fragments and K's B fragments by
//     ldmatrix, V's B fragments for P.V by ldmatrix.trans from the same
//     row-major tile. P goes from the S accumulators straight into P.V's A
//     fragments, as a hi + lo pair of bf16 (tc::split2) through two mma:
//     P.V then adds no rounding beyond the output's, and the kernel, bound
//     by bytes, does not feel the second product. Q.K^T from bf16 operands
//     with f32 sums is the plain version's upcast product.
//   - Softmax: f32 registers, base 2, the scale folded into one FMA before
//     ex2; masked pairs score -inf; a row with no visible key yet keeps
//     m = -inf and p = 0.
//   - Key splits. Keys of five tiles or more split into n_split ranges of
//     whole tiles (grid z) so that a decode step fills the card
//     (`split_plan` in kernels/attention_cached.py). With n_split > 1 each
//     block leaves its merged, unnormalised (m, l, O) in f32 scratch and a
//     second kernel merges the splits (~3 us). Merging in the last block
//     of each (b, kv head, row block) instead, counted in global memory,
//     gains ~1 us at D = 64 decode and loses up to 15 us where a block
//     holds many rows: that one block then merges them all.
//   - Registers: a warp holds D / 2 output accumulators a thread; the wide
//     heads (160, 192) take `min_blocks` = 1 as flash's do.
// * f32 (only the decode == forward checks): CUDA cores, one block of four
//   warps per 16 rows, f32 staging of K and V, scores one (row, key) pair a
//   thread, per-tile skipping by positions; the same splits, merged by the
//   second kernel.
//
// Head dims: 16, 32, 64 (granite-3-2b, granite-moe), 80, 112 (zamba2-7b's
// shared block), 128 (yi-34b, grok-1, granite-34b), 160 (pixtral-12b), 192
// (nemotron-4-340b). The wrapper checks 16-byte aligned K/V bases and
// strides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "tensor_core.cuh"
#include "launch_plan.cuh"

namespace {

using tc::cp_async;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::cp_async_wait_all;
using tc::ex2;
using tc::ldsm_x4;
using tc::ldsm_x4_t;
using tc::mma_bf16;
using tc::smem_u32;
using tc::split2;
using bf16 = __nv_bfloat16;

constexpr int BK = 64;        // key slots per tile
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 32;     // tiles whose positions a block reads at once
constexpr int NST = 2;        // stages of the bf16 K/V ring
constexpr int SIMT_ROWS = 16; // query rows per block of the f32 kernel
constexpr float NEG_INF = -INFINITY;

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c,
                                       float d) {
  uint2 u;
  u.x = tc::pack_bf16(a, b);
  u.y = tc::pack_bf16(c, d);
  *reinterpret_cast<uint2*>(p) = u;
}

// --- f32: CUDA cores --------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
cached_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const int* __restrict__ q_pos,
                   const int* __restrict__ kv_pos, float* __restrict__ o,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   Strides sq, Strides sk, Strides sv, Strides so, int H,
                   int Hkv, int Sq, int Sk, int keys_per_split, int n_split,
                   float qscale, int causal, int window) {
  constexpr int ROWS = SIMT_ROWS;
  constexpr int CH = D / 4;             // 16-byte chunks per row
  constexpr int KP = D + 1;             // K's row pitch in shared memory
  constexpr int OPT = ROWS * D / THREADS;  // accumulators per thread
  static_assert(D % 8 == 0 && ROWS * D % THREADS == 0, "head dim");

  extern __shared__ float smem[];
  float* Qs = smem;                     // [ROWS][D]
  float* Ks = Qs + ROWS * D;            // [BK][D + 1]
  float* Vs = Ks + BK * KP;             // [BK][D]
  float* Ss = Vs + BK * D;              // [ROWS][BK]: scores, then P
  __shared__ int qp_s[ROWS];
  __shared__ int kvp_s[BK];
  __shared__ float m_s[ROWS], l_s[ROWS], alpha_s[ROWS];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int G = H / Hkv;
  const int R = G * Sq;
  const int r0 = blockIdx.y * ROWS;
  const int nrows = min(ROWS, R - r0);
  const int split = blockIdx.z;
  const int k_begin = split * keys_per_split;
  const int k_end = min(Sk, k_begin + keys_per_split);

  // the rows' queries, pre-scaled, and their positions
  for (int idx = tid; idx < ROWS * D; idx += THREADS) {
    const int row = idx / D, c = idx % D;
    float x = 0.f;
    if (row < nrows) {
      const int r = r0 + row;
      const int h = kvh * G + r / Sq, i = r % Sq;
      x = q[b * sq.b + h * sq.h + i * sq.s + c] * qscale;
    }
    Qs[idx] = x;
  }
  if (tid < ROWS) {
    qp_s[tid] = tid < nrows ? q_pos[(long long)b * Sq + (r0 + tid) % Sq] : 0;
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  int qmin = qp_s[0], qmax = qp_s[0];
  for (int row = 1; row < nrows; ++row) {
    qmin = min(qmin, qp_s[row]);
    qmax = max(qmax, qp_s[row]);
  }

  float acc[OPT];
#pragma unroll
  for (int j = 0; j < OPT; ++j) acc[j] = 0.f;

  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;
  for (int kt = k_begin; kt < k_end; kt += BK) {
    const int nk = min(BK, k_end - kt);
    // the tile's slots: skip it when none can be visible to a row here
    int any = 0;
    if (tid < BK) {
      const int kp = tid < nk ? kv_pos[(long long)b * Sk + kt + tid] : -1;
      kvp_s[tid] = kp;
      any = kp >= 0 && (!causal || kp <= qmax) &&
            (window <= 0 || qmin - kp < window);
    }
    if (!__syncthreads_or(any)) continue;

    for (int idx = tid; idx < BK * CH; idx += THREADS) {
      const int key = idx / CH, c = idx % CH;
      float4 kf = make_float4(0.f, 0.f, 0.f, 0.f), vf = kf;
      if (key < nk) {
        kf = *reinterpret_cast<const float4*>(
            kb + (long long)(kt + key) * sk.s + c * 4);
        vf = *reinterpret_cast<const float4*>(
            vb + (long long)(kt + key) * sv.s + c * 4);
      }
      float* kd = Ks + key * KP + c * 4;
      kd[0] = kf.x;
      kd[1] = kf.y;
      kd[2] = kf.z;
      kd[3] = kf.w;
      *reinterpret_cast<float4*>(Vs + key * D + c * 4) = vf;
    }
    __syncthreads();

    // scores: one (row, key) pair a thread at a time
    for (int p = tid; p < nrows * BK; p += THREADS) {
      const int row = p / BK, key = p % BK;
      const int kp = kvp_s[key];
      const int rel = qp_s[row] - kp;
      const bool vis = kp >= 0 && (!causal || rel >= 0) &&
                       (window <= 0 || rel < window);
      float s = NEG_INF;
      if (vis) {
        const float* qr = Qs + row * D;
        const float* kr = Ks + key * KP;
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 2) {
          a0 = fmaf(qr[d], kr[d], a0);
          a1 = fmaf(qr[d + 1], kr[d + 1], a1);
        }
        s = a0 + a1;
      }
      Ss[row * BK + key] = s;
    }
    __syncthreads();

    // online softmax, base 2: warp w owns rows w, w + 4, ...
    for (int row = warp; row < nrows; row += WARPS) {
      const float s0 = Ss[row * BK + lane], s1 = Ss[row * BK + lane + 32];
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      float p0 = 0.f, p1 = 0.f, a = 1.f;
      if (m_new != NEG_INF) {
        p0 = exp2f(s0 - m_new);       // exp2f(-inf) = 0
        p1 = exp2f(s1 - m_new);
        a = exp2f(m_old - m_new);
      }
      const float sum = warp_sum(p0 + p1);
      Ss[row * BK + lane] = p0;
      Ss[row * BK + lane + 32] = p1;
      if (lane == 0) {
        l_s[row] = l_s[row] * a + sum;
        m_s[row] = m_new;
        alpha_s[row] = a;
      }
    }
    __syncthreads();

    // P.V into the thread's accumulators
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      const int oi = tid + THREADS * j;
      const int row = oi / D, d = oi % D;
      if (row < nrows) {
        const float* pr = Ss + row * BK;
        float s = 0.f;
        for (int key = 0; key < nk; ++key)
          s = fmaf(pr[key], Vs[key * D + d], s);
        acc[j] = acc[j] * alpha_s[row] + s;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < OPT; ++j) {
    const int oi = tid + THREADS * j;
    const int row = oi / D, d = oi % D;
    if (row >= nrows) continue;
    const int r = r0 + row;
    const int h = kvh * G + r / Sq, i = r % Sq;
    if (n_split == 1) {
      const float l = l_s[row];
      o[b * so.b + h * so.h + i * so.s + d] = l > 0.f ? acc[j] / l : 0.f;
    } else {
      const long long grow = ((long long)b * H + h) * Sq + i;
      const long long nr = (long long)gridDim.x / Hkv * H * Sq;
      part_acc[(split * nr + grow) * D + d] = acc[j];
      if (d == 0) {
        part_ml[(split * nr + grow) * 2] = m_s[row];
        part_ml[(split * nr + grow) * 2 + 1] = l_s[row];
      }
    }
  }
}

// --- merging key splits -----------------------------------------------------

// The second kernel, one block per output row grow = (b * H + h) * Sq + i:
// merges the n_split partial results (unnormalised O, and (m, l) in base 2)
// into o; 0 where no split saw a key.
template <typename T, int D>
__global__ void __launch_bounds__(32)
combine_kernel(const float* __restrict__ part_acc,
               const float* __restrict__ part_ml, T* __restrict__ o,
               Strides so, int H, int Sq, long long n_rows, int n_split) {
  const long long grow = blockIdx.x;
  const int b = static_cast<int>(grow / ((long long)H * Sq));
  const int h = static_cast<int>(grow / Sq % H);
  const int i = static_cast<int>(grow % Sq);
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + grow;
  float M = NEG_INF;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, ml[s * n_rows].x);
  for (int c = 4 * threadIdx.x; c < D; c += 4 * 32) {
    float L = 0.f;
    float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
    if (M != NEG_INF) {
#pragma unroll 4
      for (int s = 0; s < n_split; ++s) {
        const float2 x = ml[s * n_rows];
        if (x.x == NEG_INF) continue;
        const float w = ex2(x.x - M);
        const float4 a = *reinterpret_cast<const float4*>(
            part_acc + (s * n_rows + grow) * D + c);
        L += w * x.y;
        O.x += w * a.x;
        O.y += w * a.y;
        O.z += w * a.z;
        O.w += w * a.w;
      }
    }
    const float inv = L > 0.f ? 1.f / L : 0.f;
    store4(o + b * so.b + h * so.h + i * so.s + c, O.x * inv, O.y * inv,
           O.z * inv, O.w * inv);
  }
}

// --- bf16: tensor cores -----------------------------------------------------

constexpr int SKIP = 0, FULL = 1, MASKED = 2;

// The class of a tile for rows whose positions span [q_lo, q_hi] (q_lo >
// q_hi: no row), from the tile's count of valid slots and their min and
// max position (`tile_class` in kernels/attention_cached.py).
__device__ __forceinline__ int tile_class(int n_valid, int k_min, int k_max,
                                          int q_lo, int q_hi, int causal,
                                          int window) {
  if (n_valid == 0 || q_lo > q_hi) return SKIP;
  if ((causal && k_min > q_hi) || (window > 0 && q_lo - k_max >= window))
    return SKIP;
  if (n_valid == BK && (!causal || k_max <= q_lo) &&
      (window <= 0 || q_hi - k_min < window))
    return FULL;
  return MASKED;
}

// Copies of bf16 rows between global memory and a shared tile of pitch
// D + 8, in 16-byte chunks: LPR lanes per row (the power of two at or above
// D / 8), 128 / LPR rows per pass; a lane whose chunk column is past D / 8
// idles.
template <int D>
struct TileCopy {
  static constexpr int CH = D / 8;
  static constexpr int LPR =
      CH <= 2 ? 2 : CH <= 4 ? 4 : CH <= 8 ? 8 : CH <= 16 ? 16 : 32;
  static constexpr int RPP = THREADS / LPR;   // rows per pass
  int c, r0;
  bool active;
  __device__ explicit TileCopy(int t)
      : c(t % LPR), r0(t / LPR), active(t % LPR < CH) {}
};

// blocks an SM that the register budget is set for (as flash's)
constexpr int min_blocks(int D) { return D <= 128 ? 3 : 1; }

// KS: the warps that share a row group, each taking BK / KS keys of a tile
template <int D, int KS>
__global__ void __launch_bounds__(THREADS, min_blocks(D))
cached_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ q_pos,
                  const int* __restrict__ kv_pos, bf16* __restrict__ o,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  Strides sq, Strides sk, Strides sv, Strides so, int H,
                  int Hkv, int Sq, int Sk, int keys_per_split, int n_split,
                  float scale_log2, int causal, int window) {
  constexpr int RPB = 16 * WARPS / KS;    // rows per block
  constexpr int KW = BK / KS;             // keys of a tile per warp
  constexpr int KD = D / 16;              // k-steps of Q.K^T
  constexpr int ND = D / 8;               // n-tiles of P.V
  constexpr int NKW = KW / 8;             // n-tiles of Q.K^T
  constexpr int DP = D + 8;               // row pitch (bf16 elements)
  constexpr int OP = D + 4;               // row pitch of the f32 O merge
  using Copy = TileCopy<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [RPB][DP]
  bf16* Ks = Qs + RPB * DP;                       // NST x [BK][DP]
  bf16* Vs = Ks + NST * BK * DP;                  // NST x [BK][DP]
  int* kvp = reinterpret_cast<int*>(Vs + NST * BK * DP);  // NST x [BK]
  __shared__ int qp_s[RPB];
  __shared__ int t_n[CHUNK], t_min[CHUNK], t_max[CHUNK];
  __shared__ float m_s[WARPS][16], l_s[WARPS][16];

  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int rg = warp / KS, kq = warp % KS;
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int G = H / Hkv;
  const int R = G * Sq;
  const int r0 = blockIdx.y * RPB;
  const int nrows = min(RPB, R - r0);
  const int split = blockIdx.z;
  const int k_begin = split * keys_per_split;
  const int k_end = min(Sk, k_begin + keys_per_split);
  const Copy cp(t);

  // Q rows (zero past nrows), in flight during the position reads below
  if (cp.active) {
    for (int r = cp.r0; r < RPB; r += Copy::RPP) {
      const int rr = r0 + r;
      const bf16* src = q;
      if (r < nrows)
        src = q + b * sq.b + (kvh * G + rr / Sq) * sq.h +
              (long long)(rr % Sq) * sq.s + 8 * cp.c;
      cp_async<16>(smem_u32(Qs + r * DP + 8 * cp.c), src, r < nrows ? 16 : 0);
    }
  }
  cp_async_commit();
  const int qp_t = t < nrows ? __ldg(q_pos + (long long)b * Sq + (r0 + t) % Sq)
                             : 0;
  // the positions spanned by the block's rows and by this warp's row group
  // (set once the first chunk's summaries are written)
  int bq_lo = INT_MAX, bq_hi = INT_MIN, wq_lo = INT_MAX, wq_hi = INT_MIN;
  int qp0 = 0, qp1 = 0;

  const int* kvb = kv_pos + (long long)b * Sk;
  const bf16* kb = k + b * sk.b + kvh * sk.h + 8 * cp.c;
  const bf16* vb = v + b * sv.b + kvh * sv.h + 8 * cp.c;

  // the K, V and position copies of the tile at key kt into stage st:
  // slots past Sk are zero (K, V) and -1 (positions)
  auto issue = [&](int kt, int st) {
    if (cp.active) {
      const uint32_t kd = smem_u32(Ks + st * BK * DP + 8 * cp.c);
      const uint32_t vd = smem_u32(Vs + st * BK * DP + 8 * cp.c);
#pragma unroll
      for (int i = 0; i < BK / Copy::RPP; ++i) {
        const int r = cp.r0 + i * Copy::RPP;
        const bool ok = kt + r < Sk;
        const long long key = ok ? kt + r : 0;
        cp_async<16>(kd + 2 * r * DP, kb + key * sk.s, ok ? 16 : 0);
        cp_async<16>(vd + 2 * r * DP, vb + key * sv.s, ok ? 16 : 0);
      }
    }
    if (t < BK) {
      if (kt + t < Sk)
        cp_async<4>(smem_u32(kvp + st * BK + t), kvb + kt + t, 4);
      else
        kvp[st * BK + t] = -1;
    }
  };

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // running max (of scores times scale * log2 e) and sum of rows g, g + 8
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const bf16* qw = Qs + 16 * rg * DP;

  for (int c0 = k_begin; c0 < k_end; c0 += CHUNK * BK) {
    const int nt = min(CHUNK, (k_end - c0 + BK - 1) / BK);
    __syncthreads();  // the previous chunk's tiles and summaries are read
    // each tile's valid slots, their min and max position; warp w takes
    // tiles w, w + 4, ... (loads first, then the reductions)
    int pv[CHUNK / WARPS][2];
#pragma unroll
    for (int jj = 0; jj < CHUNK / WARPS; ++jj) {
      const int kt = c0 + (warp + WARPS * jj) * BK;
      const bool in = warp + WARPS * jj < nt;
      pv[jj][0] = in && kt + lane < Sk ? __ldg(kvb + kt + lane) : -1;
      pv[jj][1] = in && kt + lane + 32 < Sk ? __ldg(kvb + kt + lane + 32) : -1;
    }
    if (c0 == k_begin && t < RPB) qp_s[t] = qp_t;   // after issuing those
#pragma unroll
    for (int jj = 0; jj < CHUNK / WARPS; ++jj) {
      const int j = warp + WARPS * jj;
      if (j >= nt) break;
      const bool v0 = pv[jj][0] >= 0, v1 = pv[jj][1] >= 0;
      const int n = __popc(__ballot_sync(0xffffffffu, v0)) +
                    __popc(__ballot_sync(0xffffffffu, v1));
      int lo = min(v0 ? pv[jj][0] : INT_MAX, v1 ? pv[jj][1] : INT_MAX);
      int hi = max(v0 ? pv[jj][0] : INT_MIN, v1 ? pv[jj][1] : INT_MIN);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      }
      if (lane == 0) {
        t_n[j] = n;
        t_min[j] = lo;
        t_max[j] = hi;
      }
    }
    __syncthreads();
    if (c0 == k_begin) {
      // rows lane and lane + 32 for the block, 16 * rg + lane % 16 for the
      // warp's row group
      const int ra = lane, rb = lane + 32, rw = 16 * rg + lane % 16;
      bq_lo = min(ra < nrows ? qp_s[ra] : INT_MAX,
                  rb < nrows ? qp_s[rb] : INT_MAX);
      bq_hi = max(ra < nrows ? qp_s[ra] : INT_MIN,
                  rb < nrows ? qp_s[rb] : INT_MIN);
      wq_lo = rw < nrows ? qp_s[rw] : INT_MAX;
      wq_hi = rw < nrows ? qp_s[rw] : INT_MIN;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        bq_lo = min(bq_lo, __shfl_xor_sync(0xffffffffu, bq_lo, off));
        bq_hi = max(bq_hi, __shfl_xor_sync(0xffffffffu, bq_hi, off));
        if (off < 16) {
          wq_lo = min(wq_lo, __shfl_xor_sync(0xffffffffu, wq_lo, off));
          wq_hi = max(wq_hi, __shfl_xor_sync(0xffffffffu, wq_hi, off));
        }
      }
      qp0 = qp_s[16 * rg + g];
      qp1 = qp_s[16 * rg + g + 8];
    }
    // the tiles some row of the block may see, one bit each
    const unsigned vis = __ballot_sync(
        0xffffffffu, lane < nt && tile_class(t_n[lane], t_min[lane],
                                             t_max[lane], bq_lo, bq_hi,
                                             causal, window) != SKIP);
    const int n_vis = __popc(vis);
    unsigned to_issue = vis, to_do = vis;
    // the first NST - 1 of them, one copy group each (empty past the last)
#pragma unroll
    for (int st = 0; st < NST - 1; ++st) {
      if (to_issue) {
        issue(c0 + (__ffs(to_issue) - 1) * BK, st);
        to_issue &= to_issue - 1;
      }
      cp_async_commit();
    }

    for (int idx = 0; idx < n_vis; ++idx) {
      cp_async_wait<NST - 2>();
      __syncthreads();  // step idx has landed; step idx - 1 is read by all
      if (to_issue) {   // into the stage that step idx - 1 read
        issue(c0 + (__ffs(to_issue) - 1) * BK, (idx + NST - 1) % NST);
        to_issue &= to_issue - 1;
      }
      cp_async_commit();
      const int j = __ffs(to_do) - 1;
      to_do &= to_do - 1;
      const int cls = tile_class(t_n[j], t_min[j], t_max[j], wq_lo, wq_hi,
                                 causal, window);
      if (cls == SKIP) continue;
      const int st = idx % NST;
      const bf16* kt = Ks + (st * BK + kq * KW) * DP;   // this warp's keys
      const bf16* vt = Vs + (st * BK + kq * KW) * DP;
      const int* kp = kvp + st * BK + kq * KW;

      // S = Q.K^T: K rows are keys with D contiguous, so ldmatrix gives B
      // fragments of two n-tiles
      float s[NKW][4];
#pragma unroll
      for (int n = 0; n < NKW; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KD; ++ks) {
        uint32_t qa[4];
        ldsm_x4(qa,
                smem_u32(qw + (lane % 16) * DP + 16 * ks + 8 * (lane / 16)));
#pragma unroll
        for (int np = 0; np < NKW / 2; ++np) {
          uint32_t bfr[4];
          ldsm_x4(bfr,
                  smem_u32(kt + (16 * np + lane % 8 + 8 * (lane / 16)) * DP +
                           16 * ks + 8 * ((lane / 8) % 2)));
          mma_bf16(s[2 * np], qa, bfr[0], bfr[1]);
          mma_bf16(s[2 * np + 1], qa, bfr[2], bfr[3]);
        }
      }
      // masked tiles test each pair: rows g, g + 8, keys 8n + 2tq (+ 1)
      if (cls == MASKED) {
#pragma unroll
        for (int n = 0; n < NKW; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = kp[8 * n + 2 * tq + (e & 1)];
            const int rel = (e < 2 ? qp0 : qp1) - p;
            if (!(p >= 0 && (!causal || rel >= 0) &&
                  (window <= 0 || rel < window)))
              s[n][e] = NEG_INF;
          }
        }
      }
      // online softmax in base 2: p = 2^(s * scale log2 e - m)
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int n = 0; n < NKW; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * scale_log2);
      const float mn1 = fmaxf(m1, mx1 * scale_log2);
      // a row with no visible key yet keeps m = -inf: offset 0 keeps p = 0
      const float o0 = mn0 == NEG_INF ? 0.f : mn0;
      const float o1 = mn1 == NEG_INF ? 0.f : mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < NKW; ++n) {
        s[n][0] = ex2(fmaf(s[n][0], scale_log2, -o0));
        s[n][1] = ex2(fmaf(s[n][1], scale_log2, -o0));
        s[n][2] = ex2(fmaf(s[n][2], scale_log2, -o1));
        s[n][3] = ex2(fmaf(s[n][3], scale_log2, -o1));
        ps0 += s[n][0] + s[n][1];
        ps1 += s[n][2] + s[n][3];
      }
      const float al0 = ex2(m0 - o0), al1 = ex2(m1 - o1);
      l0 = al0 * l0 + ps0;   // each lane's share; summed over the quad below
      l1 = al1 * l1 + ps1;
      m0 = mn0;
      m1 = mn1;
      // rescale O only when some row of the warp has a new maximum
      if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          acc[n][0] *= al0;
          acc[n][1] *= al0;
          acc[n][2] *= al1;
          acc[n][3] *= al1;
        }
      }
      // O += P.V, P as hi + lo bf16 A fragments (16 keys each); V rows are
      // keys with D contiguous, so ldmatrix.trans gives B fragments of two
      // n-tiles
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          uint32_t bfr[4];
          ldsm_x4_t(bfr, smem_u32(vt + (16 * kk + lane % 8 +
                                         8 * ((lane / 8) % 2)) * DP +
                                  16 * dp + 8 * (lane / 16)));
          mma_bf16(acc[2 * dp], ph, bfr[0], bfr[1]);
          mma_bf16(acc[2 * dp], pl, bfr[0], bfr[1]);
          mma_bf16(acc[2 * dp + 1], ph, bfr[2], bfr[3]);
          mma_bf16(acc[2 * dp + 1], pl, bfr[2], bfr[3]);
        }
      }
    }
  }

  // merge the warps of each row group through shared memory (the ring is
  // free now): (m, l) per row, O in f32
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  cp_async_wait_all();
  __syncthreads();
  float* Of = reinterpret_cast<float*>(Ks);       // [WARPS][16][OP]
  if (tq == 0) {
    m_s[warp][g] = m0;
    m_s[warp][g + 8] = m1;
    l_s[warp][g] = l0;
    l_s[warp][g + 8] = l1;
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    float* p = Of + (warp * 16 + g) * OP + 8 * n + 2 * tq;
    *reinterpret_cast<float2*>(p) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(p + 8 * OP) = make_float2(acc[n][2], acc[n][3]);
  }
  __syncthreads();
  const long long nr = (long long)gridDim.x / Hkv * H * Sq;  // B * H * Sq
  for (int idx = t; idx < nrows * (D / 4); idx += THREADS) {
    const int row = idx / (D / 4), c = 4 * (idx % (D / 4));
    const int w0 = row / 16 * KS, rr = row % 16;
    float M = NEG_INF;
#pragma unroll
    for (int j = 0; j < KS; ++j) M = fmaxf(M, m_s[w0 + j][rr]);
    float L = 0.f;
    float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
    if (M != NEG_INF) {
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const float mj = m_s[w0 + j][rr];
        if (mj == NEG_INF) continue;
        const float f = ex2(mj - M);
        const float4 a = *reinterpret_cast<const float4*>(
            Of + ((w0 + j) * 16 + rr) * OP + c);
        L += f * l_s[w0 + j][rr];
        O.x += f * a.x;
        O.y += f * a.y;
        O.z += f * a.z;
        O.w += f * a.w;
      }
    }
    const int r = r0 + row;
    const int h = kvh * G + r / Sq, i = r % Sq;
    if (n_split == 1) {
      const float inv = L > 0.f ? 1.f / L : 0.f;
      store4(o + b * so.b + h * so.h + i * so.s + c, O.x * inv, O.y * inv,
             O.z * inv, O.w * inv);
    } else {
      const long long grow = ((long long)b * H + h) * Sq + i;
      store4(part_acc + (split * nr + grow) * D + c, O.x, O.y, O.z, O.w);
      if (c == 0)
        *reinterpret_cast<float2*>(part_ml + (split * nr + grow) * 2) =
            make_float2(M, L);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const int *q_pos, *kv_pos;
  void* o;
  float *part_acc, *part_ml;
  Strides sq, sk, sv, so;
  int B, H, Hkv, Sq, Sk, causal, window, keys_per_split, n_split;
  float scale_log2;
};

template <typename T, int D>
int combine(const Args& a, cudaStream_t stream) {
  const long long n_rows = (long long)a.B * a.H * a.Sq;
  COVER(0, n_rows, 1);
  LAUNCH((combine_kernel<T, D>), static_cast<unsigned>(n_rows), 32, 0, stream,
      a.part_acc, a.part_ml, static_cast<T*>(a.o), a.so, a.H, a.Sq, n_rows,
      a.n_split);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (SIMT_ROWS * D + BK * (D + 1) +
                                           BK * D + SIMT_ROWS * BK);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        cached_simt_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int R = a.H / a.Hkv * a.Sq;
  const dim3 grid(a.B * a.Hkv, (R + SIMT_ROWS - 1) / SIMT_ROWS, a.n_split);
  if (grid.y > 65535u || grid.z > 65535u)
    return static_cast<int>(cudaErrorInvalidValue);
  // the f32 kernel scales q by scale * log2 e as it loads it
  COVER(0, (long long)a.B * a.Hkv, 1);
  COVER(1, R, SIMT_ROWS);
  COVER(2, a.Sk, a.keys_per_split);
  LAUNCH((cached_simt_kernel<D>), grid, THREADS, smem, stream,
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.q_pos, a.kv_pos,
      static_cast<float*>(a.o), a.part_acc, a.part_ml, a.sq, a.sk, a.sv, a.so,
      a.H, a.Hkv, a.Sq, a.Sk, a.keys_per_split, a.n_split, a.scale_log2,
      a.causal, a.window);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return static_cast<int>(err);
  return combine<float, D>(a, stream);
}

template <int D, int KS>
int launch_mma(const Args& a, cudaStream_t stream) {
  constexpr int RPB = 16 * WARPS / KS;
  constexpr size_t smem = sizeof(bf16) * (D + 8) * (RPB + 2 * NST * BK) +
                          sizeof(int) * NST * BK;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        cached_mma_kernel<D, KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(cached_mma_kernel<D, KS>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int R = a.H / a.Hkv * a.Sq;
  const dim3 grid(a.B * a.Hkv, (R + RPB - 1) / RPB, a.n_split);
  if (grid.y > 65535u || grid.z > 65535u)
    return static_cast<int>(cudaErrorInvalidValue);
  COVER(0, (long long)a.B * a.Hkv, 1);
  COVER(1, R, RPB);
  COVER(2, a.Sk, a.keys_per_split);
  LAUNCH((cached_mma_kernel<D, KS>), grid, THREADS, smem, stream,
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.q_pos, a.kv_pos,
      static_cast<bf16*>(a.o), a.part_acc, a.part_ml, a.sq, a.sk, a.sv, a.so,
      a.H, a.Hkv, a.Sq, a.Sk, a.keys_per_split, a.n_split, a.scale_log2,
      a.causal, a.window);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return static_cast<int>(err);
  return combine<bf16, D>(a, stream);
}

// the key slices by the rows of a kv head's group (block_rows in
// kernels/attention_cached.py): 16 rows or fewer, 32, more
template <int D>
int launch_bf16(const Args& a, cudaStream_t s) {
  const int R = a.H / a.Hkv * a.Sq;
  if (R <= 16) return launch_mma<D, 4>(a, s);
  if (R <= 32) return launch_mma<D, 2>(a, s);
  return launch_mma<D, 1>(a, s);
}

template <int D>
int launch(int dtype, const Args& a, cudaStream_t s) {
  if (dtype == 0) return launch_f32<D>(a, s);
  if (dtype == 1) return launch_bf16<D>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, H, Sq, D), k and v (B, Hkv, Sk, D), o (B, H, Sq, D): element
// (b, h, i, c) of each lies at base + b*st[0] + h*st[1] + i*st[2] + c, the
// strides (in elements) given for q, k, v, o in that order in st[12].
// q_pos (B, Sq) and kv_pos (B, Sk) are contiguous int32. dtype 0 is f32,
// 1 is bf16; D is one of 16, 32, 64, 80, 112, 128, 160, 192;
// H % Hkv == 0. The keys split into n_split ranges of keys_per_split slots
// (a multiple of 64); with n_split > 1, part_acc holds n_split * B*H*Sq * D
// floats and part_ml n_split * B*H*Sq * 2, and a second kernel merges them
// into o.
// Returns cudaGetLastError() (cudaErrorInvalidValue for another D or dtype).
extern "C" int attention_cached_launch(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* kv_pos, void* o, float* part_acc, float* part_ml,
    const long long* st, int dtype, int B, int H, int Hkv, int Sq, int Sk,
    int D, int causal, int window, int keys_per_split, int n_split,
    void* stream) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const Args a{q, k, v, q_pos, kv_pos, o, part_acc, part_ml,
               Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
               Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
               B, H, Hkv, Sq, Sk, causal, window, keys_per_split, n_split,
               scale * 1.4426950408889634f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(dtype, a, s);
    case 32: return launch<32>(dtype, a, s);
    case 64: return launch<64>(dtype, a, s);
    case 80: return launch<80>(dtype, a, s);
    case 112: return launch<112>(dtype, a, s);
    case 128: return launch<128>(dtype, a, s);
    case 160: return launch<160>(dtype, a, s);
    case 192: return launch<192>(dtype, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
