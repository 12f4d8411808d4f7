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
// 2. `dkdv_kernel`: one block per (b, kv head, 64-key tile). K and V of the
//    tile stay in shared memory; the block walks, for each of the G query
//    heads of the group, the 64-query tiles that see the tile
//    (`query_tiles`, mirrored by flash_attention.query_tile_range) and
//    accumulates dV += P^T dO and dK += dS^T Q, dS = P * (dO V^T - D_i),
//    in f32 registers. The group's heads are summed inside the block: no
//    atomics, and the result does not depend on the order blocks run in.
// 3. `dq_kernel`: one block per (b, head, 64-query tile), walking the key
//    tiles that the forward visits (`key_tiles`, as key_tile_range), with
//    dQ = dS K accumulated in registers; deterministic too.
// dK and dQ take the scale once, at the end.
//
// A simple design, right first: CUDA-core f32 arithmetic for both input
// types (bf16 inputs are widened as they are staged), tiles of [64][D + 1]
// f32 in shared memory (an odd pitch, so the 16 rows a half-warp reads sit
// in distinct banks), 256 threads, each owning a 4 x 4 patch of a 64 x 64
// score tile and, for the accumulations, 4 rows x D / 16 columns. S and dP
// are computed once in each of kernels 2 and 3 (the FlashAttention-2
// recomputation). Not tensor cores, not a cp.async ring: that is the
// redesign's work.
//
// Rows with no visible key (lse = -inf) give P = 0, so their dQ is 0 and
// they add nothing to dK, dV. Masked pairs are never exponentiated.
//
// Layout: q, k, v, o, dO, dq, dk, dv are (B, heads, S, D) views with any
// strides whose last dimension is contiguous; lse and D_i are (B, H, Sq)
// contiguous f32. Head dims 16, 32, 64, 80, 112, 128. At D = 128 a block
// holds four f32 tiles and two 64 x 64 score tiles: 162 KB of shared
// memory, one block an SM; at D = 64, 100 KB, two.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int BQ = 64;        // queries per tile
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int SP = BKV + 1;   // pitch of the score tiles

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

// rows r0 .. r0 + 63 of a (b, head) slice into a [64][D + 1] f32 tile;
// rows at or past n are zero
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long rs, int r0, int n) {
#pragma unroll 4
  for (int e = threadIdx.x; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] =
        r0 + r < n ? to_f(src[(long long)(r0 + r) * rs + c]) : 0.f;
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

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
rowdot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
              float* __restrict__ di, Strides so, Strides sdo, int H, int Sq,
              long long rows) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) +
                        threadIdx.x / 32;
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

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ di,
            T* __restrict__ dk, T* __restrict__ dv, Strides sq, Strides sk,
            Strides sv, Strides sdo, Strides sdk, Strides sdv, int H,
            int Hkv, int Sq, int Sk, float scale, int causal, int window,
            int prefix) {
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
    T* kd = dk + b * sdk.b + hk * sdk.h + (long long)kp * sdk.s;
    T* vd = dv + b * sdv.b + hk * sdv.h + (long long)kp * sdv.s;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      kd[tx + 16 * m] = from_f<T>(adk[a][m] * scale);
      vd[tx + 16 * m] = from_f<T>(adv[a][m]);
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ di,
          T* __restrict__ dq, Strides sq, Strides sk, Strides sv,
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
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

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
    T* qd = dq + b * sdq.b + h * sdq.h + (long long)i * sdq.s;
#pragma unroll
    for (int m = 0; m < NC; ++m) qd[tx + 16 * m] = from_f<T>(adq[a][m] * scale);
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* di;
  void *dq, *dk, *dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int B, H, Hkv, Sq, Sk, causal, window, prefix;
  float scale;
};

template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D, typename T>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int P = D + 1;
  constexpr size_t smem_kv =
      sizeof(float) * (4 * BQ * P + 2 * BQ * SP + 2 * BQ);
  constexpr size_t smem_q = sizeof(float) * (4 * BQ * P + BQ * SP + 2 * BQ);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(dkdv_kernel<D, T>, smem_kv);
    if (err == cudaSuccess) err = allow_smem(dq_kernel<D, T>, smem_q);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long rows = (long long)a.B * a.H * a.Sq;
  const long long row_blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  const int nq = (a.Sq + BQ - 1) / BQ, nk = (a.Sk + BKV - 1) / BKV;
  if (row_blocks > 2147483647LL || nq > 65535 || nk > 65535 ||
      (long long)a.B * a.H > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  rowdot_kernel<D, T><<<static_cast<unsigned>(row_blocks), THREADS, 0,
                        stream>>>(static_cast<const T*>(a.o), dout, a.di,
                                  a.so, a.sdo, a.H, a.Sq, rows);
  dkdv_kernel<D, T><<<dim3(a.B * a.Hkv, nk), THREADS, smem_kv, stream>>>(
      q, k, v, dout, a.lse, a.di, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.H,
      a.Hkv, a.Sq, a.Sk, a.scale, a.causal, a.window, a.prefix);
  dq_kernel<D, T><<<dim3(a.B * a.H, nq), THREADS, smem_q, stream>>>(
      q, k, v, dout, a.lse, a.di, static_cast<T*>(a.dq), a.sq, a.sk, a.sv,
      a.sdo, a.sdq, a.H, a.Hkv, a.Sq, a.Sk, a.scale, a.causal, a.window,
      a.prefix);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dtype(int dtype, const Args& a, cudaStream_t s) {
  if (dtype == 0) return launch<D, float>(a, s);
  if (dtype == 1) return launch<D, __nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, o, dout, dq (B, H, Sq, D); k, v, dk, dv (B, Hkv, Sk, D): element
// (b, h, i, c) of each lies at base + b*st[0] + h*st[1] + i*st[2] + c, with
// the strides (in elements) of q, k, v, o, dout, dq, dk, dv in that order in
// st[24]. lse (B, H, Sq) is the forward's f32 row logsumexp; di is an f32
// workspace of B*H*Sq (D_i). dtype 0 is f32, 1 bf16; D one of 16, 32, 64, 80,
// 112, 128; H % Hkv == 0. Returns cudaGetLastError() (cudaErrorInvalidValue
// for another D or dtype, or a grid too large).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* di, void* dq, void* dk,
    void* dv, const long long* st, int dtype, int B, int H, int Hkv, int Sq,
    int Sk, int D, int causal, int window, int prefix, void* stream) {
  auto S = [&](int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; };
  const Args a{q, k, v, o, dout, lse, di, dq, dk, dv,
               S(0), S(1), S(2), S(3), S(4), S(5), S(6), S(7),
               B, H, Hkv, Sq, Sk, causal, window, prefix,
               static_cast<float>(1.0 / sqrt(static_cast<double>(D)))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dtype<16>(dtype, a, s);
    case 32: return launch_dtype<32>(dtype, a, s);
    case 64: return launch_dtype<64>(dtype, a, s);
    case 80: return launch_dtype<80>(dtype, a, s);
    case 112: return launch_dtype<112>(dtype, a, s);
    case 128: return launch_dtype<128>(dtype, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
