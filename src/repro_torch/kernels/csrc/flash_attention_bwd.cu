// Backward of the flash attention forward for Hopper (sm_90a): dQ, dK and dV
// of O = softmax(Q K^T * scale + mask) V, the FlashAttention-2 algorithm.
//
// No TPU kernel answers to it: the reference differentiates its XLA
// attention (`_sdpa_chunked`, src/repro/models/layers.py) by autodiff. The
// port's forward is csrc/flash_attention.cu, which writes each row's
// logsumexp (lse, natural log, over the scaled scores) beside O, so that
// the backward recomputes P = exp(S * scale - lse) tile by tile and never
// stores the (Sq, Sk) matrix. The masks are the forward's: queries at the
// tail of the keys (q_pos = i + Sk - Sq), causal, sliding `window`,
// bidirectional `prefix`; GQA (q head h reads kv head h / G).
//
// Three launches, in order on one stream:
// 1. `rowdot_kernel`: D_i = sum_c dO[i, c] * O[i, c] in f32, one warp a row.
// 2. dK and dV: one block per (b, kv head, 64-key tile). The block walks,
//    for each of the G query heads of the group, the 64-query tiles that
//    see the tile (`query_tiles`, mirrored by
//    flash_attention.query_tile_range): dV += P^T dO, dK += dS^T Q, with
//    dS = P * (dP - D_i), dP = dO V^T. The group's heads are summed inside
//    the block: no atomics, and the result does not depend on the order
//    blocks run in. Blocks run key tile by key tile, so under a causal mask
//    the first key tiles, which walk the most query tiles, start first.
// 3. dQ: one block per (b, head, 64-query tile), walking the key tiles the
//    forward visits (`key_tiles`, as key_tile_range), dQ = dS K; the query
//    tiles with the most key tiles start first. Deterministic too.
// dK and dQ take the scale once, at the end. Rows with no visible key (lse
// = -inf) give P = 0, so their dQ is 0 and they add nothing to dK, dV.
// Masked pairs are never exponentiated.
//
// What bounds it on an H100: at granite-3-2b's training shape (B = 8, 32
// query heads over 8 kv heads, S = 1024 causal, D = 64, bf16) the five
// products over the visible pairs are 86 GFLOP against 50 MB of inputs
// and gradients: operations, 0.087 ms at the bf16 tensor-core peak. The
// two kernels recompute S and dP once each (seven products, ~128 GFLOP
// over the 64 x 64 tiles they visit), which FlashAttention-2 trades for
// keeping every product on chip.
//
// Two routes, chosen by the input type:
// * bf16 (every training path): tensor cores, mma.sync m16n8k16 with f32
//   accumulation, four warps a block.
//   - Staging. Tiles stay bf16 in shared memory, copied by 16-byte
//     cp.async into row-major tiles of pitch D + 8 elements (an odd
//     multiple of 16 bytes: ldmatrix reads without bank conflicts); rows
//     past Sq or Sk are zero-filled. In the dK/dV kernel K and V of the
//     key tile stay resident, and Q, dO and their lse and D_i rows come
//     through a ring of two stages, the next query tile in flight during
//     the products. In the dQ kernel Q and dO stay, K and V come through
//     the ring.
//   - dK/dV products. Warp w owns keys 16w .. 16w + 15. For QS queries at
//     a time (`q_step`: 32 at D = 80 .. 128, 16 otherwise, so that S^T and
//     dP^T stay in registers beside the D f32 accumulators of dK and dV)
//     it computes S^T = K Q^T and dP^T = V dO^T (K and V as A
//     fragments by ldmatrix, Q and dO as B fragments by ldmatrix), forms
//     P^T and dS^T in registers, and turns the accumulators straight into
//     the A fragments of dV += P^T dO and dK += dS^T Q, whose B fragments
//     are dO and Q by ldmatrix.trans from the same row-major tiles (the
//     forward does this with P.V). P^T and dS^T never go through shared
//     memory.
//   - dQ products. Warp w owns query rows 16w .. 16w + 15: S = Q K^T and
//     dP = dO V^T as in the forward, then dQ += dS K with dS as A
//     fragments and K by ldmatrix.trans.
//   - Softmax: f32 registers, base 2, the scale folded into one FMA before
//     ex2.approx. P and dS are rounded to bf16 only as operands of the next
//     product; dK, dV and dQ accumulate in f32 and are rounded to bf16
//     once, on the way out, through shared memory in 16-byte stores.
//   - Tile skipping: a block walks only the tiles above; a warp skips the
//     (key strip, query step) or (query strip, key tile) pieces in which no
//     pair is visible (`some_visible`) and tests pairs only in those where
//     not every pair is (`all_visible`); kernels/flash_attention_bwd.py
//     mirrors both (`piece_visibility`).
// * f32 (the checks only): CUDA cores, f32 throughout. Tiles of [64][D + 1]
//   f32 in shared memory (an odd pitch, so the 16 rows a half-warp reads
//   sit in distinct banks), 256 threads, each owning a 4 x 4 patch of a
//   64 x 64 score tile and, for the accumulations, 4 rows x D / 16
//   columns. At D = 192 its dK/dV block takes 231 424 B of shared memory,
//   under the 232 448 B a block may opt into.
//
// Layout: q, k, v, o, dO, dq, dk, dv are (B, heads, S, D) views with any
// strides whose last dimension is contiguous; lse and D_i are (B, H, Sq)
// contiguous f32. The bf16 kernels need 16-byte aligned bases and row, head
// and batch strides (the wrapper checks them). Head dims 16, 32, 64, 80,
// 112, 128, 160 (pixtral-12b) and 192 (nemotron-4-340b).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tensor_core.cuh"
#include "launch_plan.cuh"

namespace {

using tc::cp_async;
using tc::cp_async_commit;
using tc::cp_async_wait_all;
using tc::ex2;
using tc::ldsm_x4;
using tc::ldsm_x4_t;
using tc::mma_bf16;
using tc::pack_bf16;
using tc::smem_u32;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;        // queries per tile
constexpr int BKV = 64;       // keys per tile
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bool visible(int q_pos, int kp, int Sk, int causal,
                                        int window, int prefix) {
  const int rel = q_pos - kp;
  bool ok = true;
  if (causal) ok = ok && rel >= 0;
  if (window > 0) ok = ok && rel < window;
  if (prefix > 0) ok = ok || kp < prefix;
  return ok && kp < Sk;
}

// The key tiles that query rows i0 .. i1 visit: [0, n_pre) then [lo, hi).
// The forward's arithmetic (key_tile_range in kernels/flash_attention.py).
__device__ __forceinline__ void key_tiles(int i0, int i1, int Sq, int Sk,
                                          int causal, int window, int prefix,
                                          int& n_pre, int& lo, int& hi) {
  const int qf = i0 + Sk - Sq, ql = i1 + Sk - Sq;
  const int k_lo = window > 0 ? max(0, qf - window + 1) : 0;
  const int k_hi = causal ? min(Sk - 1, ql) : Sk - 1;
  const int p_end = prefix > 0 ? (min(prefix, Sk) + BKV - 1) / BKV : 0;
  int t_end = 0;
  lo = 0;
  if (k_hi >= k_lo) {
    lo = k_lo / BKV;
    t_end = k_hi / BKV + 1;
  }
  n_pre = min(p_end, lo);
  hi = max(t_end, p_end);
}

// The query tiles [lo, hi) that hold a row seeing a key of key tile kt
// (query_tile_range in kernels/flash_attention.py). A tile with a prefix
// key is seen by every row; otherwise causal gives the first row (the one
// at the tile's first key) and `window` the last (the one window - 1 past
// the tile's last key).
__device__ __forceinline__ void query_tiles(int kt, int Sq, int Sk,
                                            int causal, int window,
                                            int prefix, int& lo, int& hi) {
  const int k0 = kt * BKV, kl = min(Sk, k0 + BKV) - 1, off = Sk - Sq;
  if (prefix > 0 && k0 < prefix) {
    lo = 0;
    hi = (Sq + BQ - 1) / BQ;
    return;
  }
  const int q_lo = causal ? max(0, k0 - off) : 0;
  const int q_hi = window > 0 ? min(Sq - 1, kl + window - 1 - off) : Sq - 1;
  lo = hi = 0;
  if (q_hi >= q_lo) {
    lo = q_lo / BQ;
    hi = q_hi / BQ + 1;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
rowdot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
              float* __restrict__ di, Strides so, Strides sdo, int D, int H,
              int Sq, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long bh = row / Sq;
  const int i = static_cast<int>(row % Sq);
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  const T* op = o + b * so.b + h * so.h + (long long)i * so.s;
  const T* dp = dout + b * sdo.b + h * sdo.h + (long long)i * sdo.s;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f(op[c]), to_f(dp[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) di[row] = acc;
}

// --- f32: CUDA cores -------------------------------------------------------

constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int SP = BKV + 1;   // pitch of the score tiles

// rows r0 .. r0 + 63 of a (b, head) slice into a [64][D + 1] tile; rows at
// or past n are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long rs, int r0, int n) {
#pragma unroll 4
  for (int e = threadIdx.x; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = r0 + r < n ? src[(long long)(r0 + r) * rs + c] : 0.f;
  }
}

// s = A B^T and dp = A2 B2^T for rows 4 ty + a of A, A2 and rows tx + 16 j
// of B, B2 (a, j < 4), over the D columns of [64][D + 1] tiles
template <int D>
__device__ __forceinline__ void two_products(const float* A, const float* B,
                                             const float* A2,
                                             const float* B2, int ty, int tx,
                                             float (&s)[4][4],
                                             float (&dp)[4][4]) {
  constexpr int P = D + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[a][j] = dp[a][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float x[4], y[4], x2[4], y2[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      x[a] = A[(4 * ty + a) * P + c];
      x2[a] = A2[(4 * ty + a) * P + c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      y[j] = B[(tx + 16 * j) * P + c];
      y2[j] = B2[(tx + 16 * j) * P + c];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[a][j] = fmaf(x[a], y[j], s[a][j]);
        dp[a][j] = fmaf(x2[a], y2[j], dp[a][j]);
      }
  }
}

// P = exp(S * scale - lse) on visible pairs, else 0, and dS = P (dP - D_i),
// for the thread's 4 x 4 patch of the tile at query row q0, key k0
__device__ __forceinline__ void softmax_grad(
    float (&s)[4][4], float (&dp)[4][4], const float* lse_s,
    const float* di_s, int ty, int tx, int q0, int k0, int Sq, int Sk,
    float scale, int causal, int window, int prefix) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = 4 * ty + a;
    const float l = lse_s[i], di = di_s[i];
    const int q_pos = q0 + i + Sk - Sq;
    const bool row_ok = q0 + i < Sq && l != -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kp = k0 + tx + 16 * j;
      const bool ok =
          row_ok && visible(q_pos, kp, Sk, causal, window, prefix);
      const float p = ok ? expf(fmaf(s[a][j], scale, -l)) : 0.f;
      s[a][j] = p;
      dp[a][j] = p * (dp[a][j] - di);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
dkdv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 float* __restrict__ dk, float* __restrict__ dv, Strides sq,
                 Strides sk, Strides sv, Strides sdo, Strides sdk,
                 Strides sdv, int H, int Hkv, int Sq, int Sk, float scale,
                 int causal, int window, int prefix) {
  constexpr int P = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BKV * P;
  float* Qs = Vs + BKV * P;
  float* dOs = Qs + BQ * P;
  float* Ps = dOs + BQ * P;
  float* dSs = Ps + BQ * SP;
  float* lse_s = dSs + BQ * SP;
  float* di_s = lse_s + BQ;

  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv, G = H / Hkv;
  const int kt = blockIdx.y, k0 = kt * BKV;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  load_tile<D>(Ks, k + b * sk.b + hk * sk.h, sk.s, k0, Sk);
  load_tile<D>(Vs, v + b * sv.b + hk * sv.h, sv.s, k0, Sk);

  float adk[4][NC], adv[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int m = 0; m < NC; ++m) adk[a][m] = adv[a][m] = 0.f;
  int lo, hi;
  query_tiles(kt, Sq, Sk, causal, window, prefix, lo, hi);

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const float* lse_h = lse + ((long long)b * H + h) * Sq;
    const float* di_h = di + ((long long)b * H + h) * Sq;
    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's reads are done
      load_tile<D>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
      load_tile<D>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq);
      if (t < BQ) {
        lse_s[t] = q0 + t < Sq ? lse_h[q0 + t] : -INFINITY;
        di_s[t] = q0 + t < Sq ? di_h[q0 + t] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      two_products<D>(Qs, Ks, dOs, Vs, ty, tx, s, dp);
      softmax_grad(s, dp, lse_s, di_s, ty, tx, q0, k0, Sq, Sk, scale, causal,
                   window, prefix);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Ps[(4 * ty + a) * SP + tx + 16 * j] = s[a][j];
          dSs[(4 * ty + a) * SP + tx + 16 * j] = dp[a][j];
        }
      __syncthreads();
      // dV[j] += sum_i P[i, j] dO[i], dK[j] += sum_i dS[i, j] Q[i] for the
      // thread's keys j = 4 ty + a and columns tx + 16 m
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float pv[4], ds[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pv[a] = Ps[i * SP + 4 * ty + a];
          ds[a] = dSs[i * SP + 4 * ty + a];
        }
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          const float od = dOs[i * P + tx + 16 * m];
          const float qv = Qs[i * P + tx + 16 * m];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            adv[a][m] = fmaf(pv[a], od, adv[a][m]);
            adk[a][m] = fmaf(ds[a], qv, adk[a][m]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kp = k0 + 4 * ty + a;
    if (kp >= Sk) continue;
    float* kd = dk + b * sdk.b + hk * sdk.h + (long long)kp * sdk.s;
    float* vd = dv + b * sdv.b + hk * sdv.h + (long long)kp * sdv.s;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      kd[tx + 16 * m] = adk[a][m] * scale;
      vd[tx + 16 * m] = adv[a][m];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ di,
               float* __restrict__ dq, Strides sq, Strides sk, Strides sv,
               Strides sdo, Strides sdq, int H, int Hkv, int Sq, int Sk,
               float scale, int causal, int window, int prefix) {
  constexpr int P = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BKV * P;
  float* Qs = Vs + BKV * P;
  float* dOs = Qs + BQ * P;
  float* dSs = dOs + BQ * P;
  float* lse_s = dSs + BQ * SP;
  float* di_s = lse_s + BQ;

  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q0 = blockIdx.y * BQ;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  load_tile<D>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
  load_tile<D>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq);
  if (t < BQ) {
    const long long r = ((long long)b * H + h) * Sq + q0 + t;
    lse_s[t] = q0 + t < Sq ? lse[r] : -INFINITY;
    di_s[t] = q0 + t < Sq ? di[r] : 0.f;
  }
  int n_pre, lo, hi;
  key_tiles(q0, min(Sq, q0 + BQ) - 1, Sq, Sk, causal, window, prefix, n_pre,
            lo, hi);
  const int n_vis = n_pre + hi - lo;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;

  float adq[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int m = 0; m < NC; ++m) adq[a][m] = 0.f;

  for (int idx = 0; idx < n_vis; ++idx) {
    const int k0 = (idx < n_pre ? idx : lo + idx - n_pre) * BKV;
    __syncthreads();  // the previous tile's reads are done
    load_tile<D>(Ks, kb, sk.s, k0, Sk);
    load_tile<D>(Vs, vb, sv.s, k0, Sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    two_products<D>(Qs, Ks, dOs, Vs, ty, tx, s, dp);
    softmax_grad(s, dp, lse_s, di_s, ty, tx, q0, k0, Sq, Sk, scale, causal,
                 window, prefix);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) dSs[(4 * ty + a) * SP + tx + 16 * j] = dp[a][j];
    __syncthreads();
    // dQ[i] += sum_j dS[i, j] K[j] for rows i = 4 ty + a, columns tx + 16 m
#pragma unroll 2
    for (int j = 0; j < BKV; ++j) {
      float ds[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ds[a] = dSs[(4 * ty + a) * SP + j];
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const float kv = Ks[j * P + tx + 16 * m];
#pragma unroll
        for (int a = 0; a < 4; ++a) adq[a][m] = fmaf(ds[a], kv, adq[a][m]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + 4 * ty + a;
    if (i >= Sq) continue;
    float* qd = dq + b * sdq.b + h * sdq.h + (long long)i * sdq.s;
#pragma unroll
    for (int m = 0; m < NC; ++m) qd[tx + 16 * m] = adq[a][m] * scale;
  }
}

// --- bf16: tensor cores ----------------------------------------------------

constexpr int MMA_THREADS = 128;   // four warps
constexpr int NST = 2;             // stages of the ring

// Whether some / every pair of query rows qa .. qb and keys ka .. kb is
// visible (piece_visibility in kernels/flash_attention_bwd.py). Rows past
// Sq and keys past Sk see nothing; the keys below `prefix` are seen by
// every row; otherwise a pair is seen when rel = q_pos - k lies in
// [0 if causal, window - 1 if window], and rel over the piece spans
// [qa + off - kb, qb + off - ka].
__device__ __forceinline__ bool some_visible(int qa, int qb, int ka, int kb,
                                             int Sq, int Sk, int causal,
                                             int window, int prefix) {
  qb = min(qb, Sq - 1);
  kb = min(kb, Sk - 1);
  if (qa > qb || ka > kb) return false;
  if (ka < prefix) return true;
  const int off = Sk - Sq;
  if (causal && qb + off - ka < 0) return false;
  return !(window > 0 && qa + off - kb >= window);
}

__device__ __forceinline__ bool all_visible(int qa, int qb, int ka, int kb,
                                            int Sq, int Sk, int causal,
                                            int window, int prefix) {
  if (qb >= Sq || kb >= Sk) return false;
  if (kb < prefix) return true;
  const int off = Sk - Sq, kf = max(ka, prefix);
  if (causal && qa + off - kb < 0) return false;
  return !(window > 0 && qb + off - kf >= window);
}

// Copies of a [rows][D] bf16 tile from global rows (stride `gs` elements)
// into a shared tile of pitch D + 8, in 16-byte chunks: LPR lanes per row
// (the power of two at or above D / 8), 128 / LPR rows per pass; a lane
// whose chunk column is past D / 8 idles. Rows at or past n are zero-filled.
template <int D>
struct TileCopy {
  static constexpr int CH = D / 8;
  static constexpr int LPR =
      CH <= 2 ? 2 : CH <= 4 ? 4 : CH <= 8 ? 8 : CH <= 16 ? 16 : 32;
  static constexpr int RPP = MMA_THREADS / LPR;   // rows per pass
  int c, r0;
  bool active;
  __device__ explicit TileCopy(int t)
      : c(t % LPR), r0(t / LPR), active(t % LPR < CH) {}
  __device__ __forceinline__ void rows(bf16* dst, const bf16* src,
                                       long long gs, int first, int n,
                                       int count) const {
    if (!active) return;
    for (int r = r0; r < count; r += RPP) {
      const int i = first + r;
      const bool ok = i < n;
      cp_async<16>(smem_u32(dst + r * (D + 8) + 8 * c),
                   src + (long long)(ok ? i : 0) * gs + 8 * c, ok ? 16 : 0);
    }
  }
  // rows of a shared tile out to global rows first .. n - 1
  __device__ __forceinline__ void store(bf16* dst, long long gs,
                                        const bf16* src, int first, int n,
                                        int count) const {
    if (!active) return;
    for (int r = r0; r < count; r += RPP)
      if (first + r < n)
        *reinterpret_cast<uint4*>(dst + (long long)(first + r) * gs + 8 * c) =
            *reinterpret_cast<const uint4*>(src + r * (D + 8) + 8 * c);
  }
};

// Queries a dK/dV warp takes at once: S^T and dP^T hold QS / 2 f32 each a
// thread beside the D accumulators of dK and dV. At D = 64, 16 (163
// registers: three blocks an SM) ran 7 % faster than 32 or 64 (190, 220).
__host__ __device__ constexpr int q_step(int D) {
  return D <= 64 ? 16 : D <= 128 ? 32 : 16;
}

// (Fragment layouts: tensor_core.cuh.) Shared memory: K, V [BKV][D + 8],
// then NST stages of Q and of dO [BQ][D + 8], then NST stages of the lse
// and of D_i rows [BQ] f32. Step j of the block's (head, query tile) walk
// uses stage j % NST; its copies are in flight while step j - 1 is
// multiplied. Two blocks an SM: up to 255 registers (with no block count
// given, ptxas spilled at D = 32 to fit three).
template <int D>
__global__ void __launch_bounds__(MMA_THREADS, 2)
dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ di,
                bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq,
                Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                int H, int Hkv, int Sq, int Sk, float scale_log2, float scale,
                int causal, int window, int prefix) {
  constexpr int KD = D / 16;       // k-steps of S^T; column pairs of dK, dV
  constexpr int ND = D / 8;        // n-tiles of dK, dV
  constexpr int QS = q_step(D);
  constexpr int NQ = QS / 8;       // n-tiles of S^T
  constexpr int DP = D + 8;
  static_assert(MMA_THREADS == 2 * BQ, "one lse or D_i copy a thread");
  using Copy = TileCopy<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BKV * DP;
  bf16* Qs = Vs + BKV * DP;
  bf16* dOs = Qs + NST * BQ * DP;
  float* Ls = reinterpret_cast<float*>(dOs + NST * BQ * DP);
  float* Ds = Ls + NST * BQ;

  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv, G = H / Hkv;
  const int k0 = blockIdx.y * BKV;
  int lo, hi;
  query_tiles(blockIdx.y, Sq, Sk, causal, window, prefix, lo, hi);
  const int nqt = hi - lo, n_steps = G * nqt;
  const Copy cp(t);

  // the Q, dO, lse and D_i rows of step idx (head hk G + idx / nqt, query
  // tile lo + idx % nqt) into stage st
  auto issue = [&](int idx, int st) {
    const int h = hk * G + idx / nqt, q0 = (lo + idx % nqt) * BQ;
    cp.rows(Qs + st * BQ * DP, q + b * sq.b + h * sq.h, sq.s, q0, Sq, BQ);
    cp.rows(dOs + st * BQ * DP, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq,
            BQ);
    const int r = t % BQ;
    const bool ok = q0 + r < Sq;
    const float* src = (t < BQ ? lse : di) + ((long long)b * H + h) * Sq +
                       (ok ? q0 + r : 0);
    cp_async<4>(smem_u32((t < BQ ? Ls : Ds) + st * BQ + r), src, ok ? 4 : 0);
  };

  cp.rows(Ks, k + b * sk.b + hk * sk.h, sk.s, k0, Sk, BKV);
  cp.rows(Vs, v + b * sv.b + hk * sv.h, sv.s, k0, Sk, BKV);
  if (n_steps > 0) issue(0, 0);
  cp_async_commit();

  const int kw0 = k0 + 16 * warp;   // the warp's first key
  const bf16* kw = Ks + 16 * warp * DP;
  const bf16* vw = Vs + 16 * warp * DP;
  float adk[ND][4], adv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

#pragma unroll 1
  for (int idx = 0; idx < n_steps; ++idx) {
    cp_async_wait_all();
    __syncthreads();  // step idx has landed; step idx - 1 is read by all
    if (idx + 1 < n_steps) issue(idx + 1, (idx + 1) % NST);
    cp_async_commit();
    const int st = idx % NST;
    const int q0 = (lo + idx % nqt) * BQ;
    const bf16* qt = Qs + st * BQ * DP;
    const bf16* ot = dOs + st * BQ * DP;
    const float* lt = Ls + st * BQ;
    const float* dt = Ds + st * BQ;

#pragma unroll 1
    for (int qs0 = 0; qs0 < BQ; qs0 += QS) {
      const int qa = q0 + qs0, qb = qa + QS - 1;
      if (!some_visible(qa, qb, kw0, kw0 + 15, Sq, Sk, causal, window,
                        prefix))
        continue;
      const bool full =
          all_visible(qa, qb, kw0, kw0 + 15, Sq, Sk, causal, window, prefix);

      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys and QS queries:
      // K and V rows give A fragments, Q and dO rows (D contiguous) B
      // fragments of two n-tiles each
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KD; ++ks) {
        uint32_t ka[4], va[4];
        const int ac = (lane % 16) * DP + 16 * ks + 8 * (lane / 16);
        ldsm_x4(ka, smem_u32(kw + ac));
        ldsm_x4(va, smem_u32(vw + ac));
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          const int bo = (qs0 + 16 * np + lane % 8 + 8 * (lane / 16)) * DP +
                         16 * ks + 8 * ((lane / 8) % 2);
          uint32_t bq[4], bd[4];
          ldsm_x4(bq, smem_u32(qt + bo));
          ldsm_x4(bd, smem_u32(ot + bo));
          mma_bf16(s[2 * np], ka, bq[0], bq[1]);
          mma_bf16(s[2 * np + 1], ka, bq[2], bq[3]);
          mma_bf16(dp[2 * np], va, bd[0], bd[1]);
          mma_bf16(dp[2 * np + 1], va, bd[2], bd[3]);
        }
      }
      // P^T = 2^(S^T scale log2 e - lse log2 e) on visible pairs, dS^T =
      // P^T (dP^T - D_i), in place; element e of n-tile n is key
      // kw0 + g + 8 (e / 2), query qs0 + 8 n + 2 tq + e % 2 of the tile
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int c = qs0 + 8 * n + 2 * tq;
        const float2 l2 = *reinterpret_cast<const float2*>(lt + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dt + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok =
              full || (q0 + c + (e & 1) < Sq &&
                       visible(q0 + c + (e & 1) + Sk - Sq,
                               kw0 + g + 8 * (e >> 1), Sk, causal, window,
                               prefix));
          const float l = (e & 1) ? l2.y : l2.x;
          const float p =
              ok ? ex2(fmaf(s[n][e], scale_log2, -l * LOG2E)) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - ((e & 1) ? d2.y : d2.x));
        }
      }
      // dV += P^T dO and dK += dS^T Q: P^T and dS^T, rounded to bf16, are
      // the A fragments of 16 queries; dO and Q rows (queries, D
      // contiguous) give B fragments of two n-tiles by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < QS / 16; ++kk) {
        uint32_t pa[4], sa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        sa[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
        sa[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
        sa[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        sa[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int cp2 = 0; cp2 < KD; ++cp2) {
          const int bo = (qs0 + 16 * kk + lane % 8 + 8 * ((lane / 8) % 2)) *
                             DP + 16 * cp2 + 8 * (lane / 16);
          uint32_t bd[4], bq[4];
          ldsm_x4_t(bd, smem_u32(ot + bo));
          ldsm_x4_t(bq, smem_u32(qt + bo));
          mma_bf16(adv[2 * cp2], pa, bd[0], bd[1]);
          mma_bf16(adv[2 * cp2 + 1], pa, bd[2], bd[3]);
          mma_bf16(adk[2 * cp2], sa, bq[0], bq[1]);
          mma_bf16(adk[2 * cp2 + 1], sa, bq[2], bq[3]);
        }
      }
    }
  }

  // dK (scaled) and dV to bf16 through the warp's own rows of the K and V
  // tiles, then 16-byte stores of the keys below Sk
  cp_async_wait_all();
  __syncthreads();  // every copy has landed and every read is done
  bf16* kr = Ks + 16 * warp * DP;
  bf16* vr = Vs + 16 * warp * DP;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = 8 * n + 2 * tq;
    *reinterpret_cast<uint32_t*>(kr + g * DP + c) =
        pack_bf16(adk[n][0] * scale, adk[n][1] * scale);
    *reinterpret_cast<uint32_t*>(kr + (g + 8) * DP + c) =
        pack_bf16(adk[n][2] * scale, adk[n][3] * scale);
    *reinterpret_cast<uint32_t*>(vr + g * DP + c) =
        pack_bf16(adv[n][0], adv[n][1]);
    *reinterpret_cast<uint32_t*>(vr + (g + 8) * DP + c) =
        pack_bf16(adv[n][2], adv[n][3]);
  }
  __syncthreads();
  cp.store(dk + b * sdk.b + hk * sdk.h, sdk.s, Ks, k0, Sk, BKV);
  cp.store(dv + b * sdv.b + hk * sdv.h, sdv.s, Vs, k0, Sk, BKV);
}

// Shared memory: Q, dO [BQ][D + 8], then NST stages of K and of V
// [BKV][D + 8]; step j of the block's key tiles uses stage j % NST, its
// copies in flight while step j - 1 is multiplied.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              bf16* __restrict__ dq, Strides sq, Strides sk, Strides sv,
              Strides sdo, Strides sdq, int H, int Hkv, int Sq, int Sk,
              float scale_log2, float scale, int causal, int window,
              int prefix) {
  constexpr int KD = D / 16;       // k-steps of S; column pairs of dQ
  constexpr int ND = D / 8;        // n-tiles of dQ
  constexpr int NK = BKV / 8;      // n-tiles of S
  constexpr int DP = D + 8;
  using Copy = TileCopy<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BQ * DP;
  bf16* Ks = dOs + BQ * DP;
  bf16* Vs = Ks + NST * BKV * DP;

  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  int n_pre, lo, hi;
  key_tiles(q0, min(Sq, q0 + BQ) - 1, Sq, Sk, causal, window, prefix, n_pre,
            lo, hi);
  const int n_vis = n_pre + hi - lo;
  const Copy cp(t);
  const bf16* kb = k + b * sk.b + hk * sk.h;
  const bf16* vb = v + b * sv.b + hk * sv.h;
  auto tile_of = [&](int idx) { return idx < n_pre ? idx : lo + idx - n_pre; };
  auto issue = [&](int idx, int st) {
    const int k0 = tile_of(idx) * BKV;
    cp.rows(Ks + st * BKV * DP, kb, sk.s, k0, Sk, BKV);
    cp.rows(Vs + st * BKV * DP, vb, sv.s, k0, Sk, BKV);
  };
  if (n_vis > 0) {
    cp.rows(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq, BQ);
    cp.rows(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq, BQ);
    issue(0, 0);
  }
  cp_async_commit();

  // the warp's rows g and g + 8: lse (times log2 e) and D_i
  const int wi0 = q0 + 16 * warp, r0 = wi0 + g, r1 = r0 + 8;
  const long long rb = ((long long)b * H + h) * Sq;
  const float l0 = r0 < Sq ? lse[rb + r0] * LOG2E : 0.f;
  const float l1 = r1 < Sq ? lse[rb + r1] * LOG2E : 0.f;
  const float d0 = r0 < Sq ? di[rb + r0] : 0.f;
  const float d1 = r1 < Sq ? di[rb + r1] : 0.f;
  const bf16* qw = Qs + 16 * warp * DP;
  const bf16* ow = dOs + 16 * warp * DP;
  float adq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.f;

#pragma unroll 1
  for (int idx = 0; idx < n_vis; ++idx) {
    cp_async_wait_all();
    __syncthreads();  // step idx has landed; step idx - 1 is read by all
    if (idx + 1 < n_vis) issue(idx + 1, (idx + 1) % NST);
    cp_async_commit();
    const int k0 = tile_of(idx) * BKV;
    if (!some_visible(wi0, wi0 + 15, k0, k0 + BKV - 1, Sq, Sk, causal, window,
                      prefix))
      continue;
    const bool full = all_visible(wi0, wi0 + 15, k0, k0 + BKV - 1, Sq, Sk,
                                  causal, window, prefix);
    const bf16* kt = Ks + (idx % NST) * BKV * DP;
    const bf16* vt = Vs + (idx % NST) * BKV * DP;

    // S = Q K^T and dP = dO V^T: Q and dO rows give A fragments, K and V
    // rows (keys, D contiguous) B fragments of two n-tiles each
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      uint32_t qa[4], oa[4];
      const int ac = (lane % 16) * DP + 16 * ks + 8 * (lane / 16);
      ldsm_x4(qa, smem_u32(qw + ac));
      ldsm_x4(oa, smem_u32(ow + ac));
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        const int bo = (16 * np + lane % 8 + 8 * (lane / 16)) * DP + 16 * ks +
                       8 * ((lane / 8) % 2);
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, smem_u32(kt + bo));
        ldsm_x4(bv, smem_u32(vt + bo));
        mma_bf16(s[2 * np], qa, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
        mma_bf16(dp[2 * np], oa, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], oa, bv[2], bv[3]);
      }
    }
    // dS = P (dP - D_i), P = 2^(S scale log2 e - lse log2 e) on visible
    // pairs; element e of n-tile n is row wi0 + g + 8 (e / 2), key
    // k0 + 8 n + 2 tq + e % 2
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = (e >> 1) ? r1 : r0;
        const bool ok =
            full || (i < Sq && visible(i + Sk - Sq, k0 + 8 * n + 2 * tq +
                                       (e & 1), Sk, causal, window, prefix));
        const float p =
            ok ? ex2(fmaf(s[n][e], scale_log2, -((e >> 1) ? l1 : l0))) : 0.f;
        dp[n][e] = p * (dp[n][e] - ((e >> 1) ? d1 : d0));
      }
    }
    // dQ += dS K: dS, rounded to bf16, is the A fragment of 16 keys; K rows
    // (keys, D contiguous) give B fragments of two n-tiles by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t sa[4];
      sa[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      sa[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      sa[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      sa[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int cp2 = 0; cp2 < KD; ++cp2) {
        uint32_t bk[4];
        ldsm_x4_t(bk, smem_u32(kt + (16 * kk + lane % 8 + 8 * ((lane / 8) % 2)) *
                                        DP + 16 * cp2 + 8 * (lane / 16)));
        mma_bf16(adq[2 * cp2], sa, bk[0], bk[1]);
        mma_bf16(adq[2 * cp2 + 1], sa, bk[2], bk[3]);
      }
    }
  }

  // dQ (scaled) to bf16 through the warp's own rows of the Q tile, then
  // 16-byte stores of the rows below Sq
  cp_async_wait_all();
  __syncthreads();  // every copy has landed and every read is done
  bf16* qr = Qs + 16 * warp * DP;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = 8 * n + 2 * tq;
    *reinterpret_cast<uint32_t*>(qr + g * DP + c) =
        pack_bf16(adq[n][0] * scale, adq[n][1] * scale);
    *reinterpret_cast<uint32_t*>(qr + (g + 8) * DP + c) =
        pack_bf16(adq[n][2] * scale, adq[n][3] * scale);
  }
  __syncthreads();
  cp.store(dq + b * sdq.b + h * sdq.h, sdq.s, Qs, q0, Sq, BQ);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* di;
  void *dq, *dk, *dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int B, H, Hkv, Sq, Sk, D, causal, window, prefix;
  float scale;
};

template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// D_i, then the grid checks shared by both routes; false if too large
template <typename T>
bool rowdot(const Args& a, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.H * a.Sq;
  const long long row_blocks = (rows + 7) / 8;
  const int nq = (a.Sq + BQ - 1) / BQ, nk = (a.Sk + BKV - 1) / BKV;
  if (row_blocks > 2147483647LL || nq > 65535 || nk > 65535 ||
      (long long)a.B * a.H > 2147483647LL)
    return false;
  COVER(0, rows, 8);
  LAUNCH((rowdot_kernel<T>), static_cast<unsigned>(row_blocks), 256, 0, stream,
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.di, a.so,
      a.sdo, a.D, a.H, a.Sq, rows);
  return true;
}

template <int D>
int launch_f32(const Args& a, cudaStream_t stream) {
  constexpr int P = D + 1;
  constexpr size_t smem_kv =
      sizeof(float) * (4 * BQ * P + 2 * BQ * SP + 2 * BQ);
  constexpr size_t smem_q = sizeof(float) * (4 * BQ * P + BQ * SP + 2 * BQ);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(dkdv_simt_kernel<D>, smem_kv);
    if (err == cudaSuccess) err = allow_smem(dq_simt_kernel<D>, smem_q);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (!rowdot<float>(a, stream))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nq = (a.Sq + BQ - 1) / BQ, nk = (a.Sk + BKV - 1) / BKV;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  COVER(0, (long long)a.B * a.Hkv, 1);
  COVER(1, a.Sk, BKV);
  LAUNCH((dkdv_simt_kernel<D>), dim3(a.B * a.Hkv, nk), THREADS, smem_kv, stream,
      q, k, v, dout, a.lse, a.di, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.H,
      a.Hkv, a.Sq, a.Sk, a.scale, a.causal, a.window, a.prefix);
  COVER(0, (long long)a.B * a.H, 1);
  COVER(1, a.Sq, BQ);
  LAUNCH((dq_simt_kernel<D>), dim3(a.B * a.H, nq), THREADS, smem_q, stream,
      q, k, v, dout, a.lse, a.di, static_cast<float*>(a.dq), a.sq, a.sk,
      a.sv, a.sdo, a.sdq, a.H, a.Hkv, a.Sq, a.Sk, a.scale, a.causal,
      a.window, a.prefix);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const Args& a, cudaStream_t stream) {
  constexpr size_t smem_q = sizeof(bf16) * (D + 8) * (2 * BQ + 2 * NST * BKV);
  constexpr size_t smem_kv = smem_q + sizeof(float) * 2 * NST * BQ;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(dkdv_mma_kernel<D>, smem_kv);
    if (err == cudaSuccess) err = allow_smem(dq_mma_kernel<D>, smem_q);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (!rowdot<bf16>(a, stream))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nq = (a.Sq + BQ - 1) / BQ, nk = (a.Sk + BKV - 1) / BKV;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const float scale_log2 = a.scale * LOG2E;
  COVER(0, (long long)a.B * a.Hkv, 1);
  COVER(1, a.Sk, BKV);
  LAUNCH((dkdv_mma_kernel<D>), dim3(a.B * a.Hkv, nk), MMA_THREADS, smem_kv, stream,
      q, k, v, dout, a.lse, a.di, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.H,
      a.Hkv, a.Sq, a.Sk, scale_log2, a.scale, a.causal, a.window, a.prefix);
  COVER(0, (long long)a.B * a.H, 1);
  COVER(1, a.Sq, BQ);
  LAUNCH((dq_mma_kernel<D>), dim3(a.B * a.H, nq), MMA_THREADS, smem_q, stream,
      q, k, v, dout, a.lse, a.di, static_cast<bf16*>(a.dq), a.sq, a.sk, a.sv,
      a.sdo, a.sdq, a.H, a.Hkv, a.Sq, a.Sk, scale_log2, a.scale, a.causal,
      a.window, a.prefix);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const Args& a, cudaStream_t s) {
  if (dtype == 0) return launch_f32<D>(a, s);
  if (dtype == 1) return launch_bf16<D>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, o, dout, dq (B, H, Sq, D); k, v, dk, dv (B, Hkv, Sk, D): element
// (b, h, i, c) of each lies at base + b*st[0] + h*st[1] + i*st[2] + c, with
// the strides (in elements) of q, k, v, o, dout, dq, dk, dv in that order in
// st[24]. lse (B, H, Sq) is the forward's f32 row logsumexp; di is an f32
// workspace of B*H*Sq (D_i). dtype 0 is f32, 1 bf16 (16-byte aligned bases
// and strides); D one of 16, 32, 64, 80, 112, 128, 160, 192; H % Hkv == 0.
// Returns cudaGetLastError() (cudaErrorInvalidValue for another D or dtype,
// or a grid too large).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* di, void* dq, void* dk,
    void* dv, const long long* st, int dtype, int B, int H, int Hkv, int Sq,
    int Sk, int D, int causal, int window, int prefix, void* stream) {
  auto S = [&](int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; };
  const Args a{q, k, v, o, dout, lse, di, dq, dk, dv,
               S(0), S(1), S(2), S(3), S(4), S(5), S(6), S(7),
               B, H, Hkv, Sq, Sk, D, causal, window, prefix,
               static_cast<float>(1.0 / sqrt(static_cast<double>(D)))};
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
