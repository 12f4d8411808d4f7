// Backward of the RWKV6 (WKV6) recurrence for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of
// `wkv6_chunked` (src/repro/models/rwkv.py:53). The forward is
//     out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t   = diag(w_t) S_{t-1} + k_t v_t^T,        w_t = exp(lw_t) <= 1
// with an f32 state S of Dh x Dh per (b, h). Given the output gradient
// do and the final-state gradient dS_T (null: zero), this computes
//     dr_t  = S_{t-1} do_t + u * k_t (v_t . do_t)
//     dk_t  = G_t v_t + u * r_t (v_t . do_t)
//     dv_t  = G_t^T k_t + (r_t . (u * k_t)) do_t
//     du    = sum_{b,t} r_t * k_t (v_t . do_t),        dS0 = G_{-1}
//     dlw_t = w_t * rowsum(G_t * S_{t-1})
// where G_t, the gradient of S_t, runs backwards from G_{T-1} = dS_T:
//     G_{t-1} = diag(w_t) G_t + r_t do_t^T.
//
// dlw pairs S_{t-1} with G_t, which run in opposite directions. Per row d
// of the state, <G_{t-1}, S_{t-1}> = r_t dr~_t + dlw_t and <G_t, S_t> =
// dlw_t + k_t dk~_t (dr~, dk~: dr and dk without their u terms), so
//     dlw_{t+1} = dlw_t + k_t dk~_t - r_{t+1} dr~_{t+1},
// a prefix sum of products of the outputs (ref.wkv6_dlw_prefix). It
// cancels: where the decay is strong (lw near -8) dlw is ~w of the terms
// it is the difference of.
//
// Two routes, chosen by the input type.
//
// * bf16 (the training path): the chunked form on the tensor cores
//   (mma.sync m16n8k16, f32 accumulation), in chunks of L = 64 steps (the
//   kernel's own, whatever the model's chunk) that run in parallel.
//   Within a chunk, in log2 units, cw = cumsum(lw) (inclusive), cwp[i] =
//   cw[i-1] (0 at the chunk's first step), cwl = cw[L-1]; S0 is the state
//   before the chunk and Ge the gradient of its last state. Then
//       dr~_i = sum_{j<i} (do_i . v_j) k_j 2^(cwp_i - cw_j) + 2^cwp_i S0 do_i
//       dk~_j = sum_{i>j} (do_i . v_j) r_i 2^(cwp_i - cw_j) + 2^(cwl - cw_j) Ge v_j
//       dv_j  = sum_{i>=j} A[i,j] do_i + (k_j 2^(cwl - cw_j))^T Ge
//   with A the forward's matrix (csrc/wkv6.cu; its diagonal the bonus
//   r . (u k)). Four launches on the caller's stream, no atomics: two
//   calls give the same bits.
//   1. chunk states, one block of four warps per (chunk, b, h): the
//      chunk's own dS = (k 2^(cwl - cw))^T v and dG = (r 2^cwp)^T do, and
//      cwl, to f32 scratch (B, H, chunks, 64, 64); warp w owns state rows
//      16w .. 16w + 15.
//   2. the boundary scan, one block of 256 threads per (b, h), four a
//      state row: S0 of every chunk (S0' = 2^cwl S0 + dS) over the dS
//      scratch, Ge of every chunk (going back: G = 2^cwl G + dG) over the
//      dG scratch, dS0, and each chunk's first dlw,
//      <G_{c0-1} - r_{c0} do_{c0}^T, S_{c0-1}> per row, exact in f32.
//   3. the outputs, one block of four warps per (chunk, b, h); warp w owns
//      the steps 16w .. 16w + 15. do v^T (rows i) and dr~, v do^T (rows j)
//      and dk~, their diagonal quadrants, then dr and dk, the prefix of
//      dlw, then A^T (rows j) and dv. The decay is per channel, so each
//      product's decay is split around a reference step so that both
//      factors are <= 1 (csrc/wkv6.cu's device): the step tiles before a
//      warp's rows at cwp of its first step (dr~), the tiles after them at
//      cw of its last step (dk~, A^T), the quadrant of its diagonal tile
//      below the diagonal at cw of its step 7. The two 8 x 8 diagonal
//      quadrants take the exact pairwise exponent on the CUDA cores: for
//      dr~ and dk~ in one pass a quadrant, each lane owning two state
//      columns so that each exponent serves both, through shared memory
//      (the same sums in the fragments' layout, unrolled per element, took
//      half the phase: PERF.md section 6); for A one pair a lane. Every
//      factor is <= 1, at any lw.
//      dlw is re-anchored at each chunk: it starts from phase 2's first
//      dlw and adds the chunk's products only, and the pairs of adjacent
//      steps (j = i - 1), which the two terms of each step of the prefix
//      hold alike and which cancel exactly, leave the products: they are
//      added to dr and dk exactly (f32, CUDA cores) and never enter the
//      prefix. What is left in it carries at least one decay factor w, so
//      its rounding is ~w of the terms as dlw is (tests/
//      test_torch_recurrent_bwd_chunks.py: a prefix over all of T, or one
//      that keeps the adjacent pairs, lands 150-590x past the tolerance at
//      lw = -8 with these products). Each product's f32 operands (the
//      decayed r and k, do v^T, A, the boundary states) enter as one bf16
//      rounding: that emulation holds every gradient within 0.45 of the
//      1e-2 x max tolerance with no hi + lo split.
//      du: each (b, chunk, h)'s share.
//   4. du: the shares summed over b (and chunks) in order.
//   Rows past T are zero-filled (lw = 0 there) and Dh below 64 is
//   zero-padded in shared memory.
// * f32 (only the checks run it): two step sweeps on the CUDA cores,
//   accumulating in f64, since the prefix sum over all of T cancels (f32
//   puts dlw ~2e-3 of its max off at lw = -8, a CPU emulation).
//   1. reverse sweep, one block of 8 * Dh threads per (b, h): G in
//      registers twice, once row-owned (thread (d, q) holds G[d, q + 4i],
//      so dk~[d] = sum_e G[d, e] v[e] is a sum over the four lanes of a
//      quad) and once column-owned (thread (e, q) holds G[q + 4i, e], so
//      dv[e] is a quad sum too). Writes dk, dv, dS0, each (b, h)'s share
//      of du, and to f64 scratch k_t * dk~_t and each row's <s0, dS0>.
//   2. forward sweep, 4 * Dh threads per (b, h), S row-owned: dr, and dlw
//      from the running <G, S> started at <s0, dS0>.
//   3. du: the per-(b, h) shares summed over b in order.
//   Per tile of TC steps a block stages r, k, v, do and exp(lw) in shared
//   memory (f32), then every thread steps through the tile.
//
// What bounds it on an H100: at rwkv6-3b's training shape (B=8, H=40,
// T=1024, Dh=64; bf16 r/k/v/do/dr/dk/dv, f32 lw and dlw) the function
// moves ~0.46 GB, 0.14 ms at the data sheet's 3.35 TB/s; the chunked
// products take less on the tensor cores. The bf16 route moves the two
// boundary-state scratches besides (84 MB each, written in phase 1,
// rewritten in phase 2, read in phase 3: ~0.15 ms more). The step sweeps,
// run on bf16 inputs, took 2.34 ms, bound by each block's chain of 1024
// dependent steps over 320 blocks; here a block's chain is one chunk, and
// 5 120 chunk blocks fill the card (PERF.md section 6 has both in turns). Phase 3 takes most of the time (PERF.md section 6):
// 224-254 registers a thread and 111 KB of shared memory hold it to two
// blocks, eight warps, an SM, too few to hide its latencies.
//
// Layout: r, k, v, lw, do, dr, dk, dv and dlw are (B, H, T, Dh) views with
// any strides whose last dimension is contiguous (bf16: 16-byte aligned
// rows); u (H, Dh), s0, dS_T and dS0 (B, H, Dh, Dh) are contiguous f32.

#include "recurrence.cuh"
#include "tensor_core.cuh"
#include "launch_plan.cuh"

#include <cstdint>

namespace {

constexpr int TC = 16;  // steps staged in shared memory per tile

using recurrence::Acc;
using recurrence::Strides;
using recurrence::from_f32;
using recurrence::mad;
using recurrence::quad_sum;
using recurrence::to_f32;
using recurrence::warp_sum;

// Stage TC steps of r, k, v, do and exp(lw) as f32; then each warp takes
// v . do (and, given `ruk`, r . (u * k)) of every (NT / 32)-th step.
template <typename T, int DH, int NT>
__device__ __forceinline__ void stage(
    float (&rs)[TC][DH], float (&ks)[TC][DH], float (&vs)[TC][DH],
    float (&ds)[TC][DH], float (&ws)[TC][DH], float* vdo, float* ruk,
    const float* us, const T* rb, const T* kb, const T* vb, const float* wb,
    const T* db, Strides sr, Strides sk, Strides sv, Strides sw, Strides sdo,
    int t0, int nt) {
  const int t = threadIdx.x;
  for (int idx = t; idx < nt * DH; idx += NT) {
    const int tt = idx / DH, d = idx % DH;
    const long long st = t0 + tt;
    rs[tt][d] = to_f32(rb[st * sr.t + d]);
    ks[tt][d] = to_f32(kb[st * sk.t + d]);
    vs[tt][d] = to_f32(vb[st * sv.t + d]);
    ds[tt][d] = to_f32(db[st * sdo.t + d]);
    ws[tt][d] = expf(wb[st * sw.t + d]);
  }
  __syncthreads();
  const int warp = t / 32, lane = t % 32;
  for (int tt = warp; tt < nt; tt += NT / 32) {
    float a = 0.f, c = 0.f;
    for (int d = lane; d < DH; d += 32) {
      a = fmaf(vs[tt][d], ds[tt][d], a);
      if (ruk) c = fmaf(rs[tt][d] * us[d], ks[tt][d], c);
    }
    a = warp_sum(a);
    if (ruk) c = warp_sum(c);
    if (lane == 0) {
      vdo[tt] = a;
      if (ruk) ruk[tt] = c;
    }
  }
  __syncthreads();
}

template <typename T, int DH>
__global__ void __launch_bounds__(8 * DH)
wkv6_bwd_reverse(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ lw,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 const T* __restrict__ dout, const float* __restrict__ dsT,
                 T* __restrict__ dk, T* __restrict__ dv,
                 typename Acc<T>::type* __restrict__ kdk,
                 typename Acc<T>::type* __restrict__ c0,
                 float* __restrict__ ds0, float* __restrict__ du_part,
                 Strides sr, Strides sk, Strides sv, Strides sw, Strides sdo,
                 Strides sdk, Strides sdv, int H, int Tn) {
  using A = typename Acc<T>::type;
  constexpr int RPT = DH / 4;   // state elements a thread holds
  constexpr int HALF = 4 * DH;  // threads of each ownership (whole warps)
  constexpr int NT = 2 * HALF;
  __shared__ float rs[TC][DH], ks[TC][DH], vs[TC][DH], ds[TC][DH],
      ws[TC][DH], dks[TC][DH], dvs[TC][DH];
  __shared__ A kdks[TC][DH];
  __shared__ float vdo[TC], ruk[TC], us[DH];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int t = threadIdx.x;
  const bool by_col = t >= HALF;  // the column-owned copy of G
  const int own = (t % HALF) / 4, q = t % 4;

  A G[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int idx = by_col ? (q + 4 * i) * DH + own : own * DH + q + 4 * i;
    G[i] = dsT ? dsT[(long long)bh * DH * DH + idx] : 0.f;
  }
  if (t < DH) us[t] = u[h * DH + t];
  const float uu = u[h * DH + own];
  float du_acc = 0.f;

  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* wb = lw + b * sw.b + h * sw.h;
  const T* db = dout + b * sdo.b + h * sdo.h;
  T* dkb = dk + b * sdk.b + h * sdk.h;
  T* dvb = dv + b * sdv.b + h * sdv.h;
  A* kdkb = kdk + (long long)bh * Tn * DH;

  for (int tile = (Tn - 1) / TC; tile >= 0; --tile) {
    const int t0 = tile * TC, nt = min(TC, Tn - t0);
    __syncthreads();  // the previous tile's outputs have left, us is set
    stage<T, DH, NT>(rs, ks, vs, ds, ws, vdo, ruk, us, rb, kb, vb, wb, db,
                     sr, sk, sv, sw, sdo, t0, nt);

#pragma unroll 1
    for (int tt = nt - 1; tt >= 0; --tt) {
      if (!by_col) {  // row d = own: dk~[d] = sum_e G[d, e] v[e]
        A acc = 0;
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          acc = mad(G[i], A(vs[tt][q + 4 * i]), acc);
        acc = quad_sum(acc);
        const A rd = rs[tt][own], wd = ws[tt][own];
        if (q == 0) {
          const float kd = ks[tt][own];
          dks[tt][own] = fmaf(uu * float(rd), vdo[tt], float(acc));
          kdks[tt][own] = A(kd) * acc;
          du_acc = fmaf(float(rd) * kd, vdo[tt], du_acc);
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          G[i] = mad(wd, G[i], rd * A(ds[tt][q + 4 * i]));
      } else {  // column e = own: dv[e] = sum_d G[d, e] k[d]
        A acc = 0;
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          acc = mad(G[i], A(ks[tt][q + 4 * i]), acc);
        acc = quad_sum(acc);
        const A de = ds[tt][own];
        if (q == 0) dvs[tt][own] = fmaf(ruk[tt], float(de), float(acc));
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          G[i] = mad(A(ws[tt][q + 4 * i]), G[i], A(rs[tt][q + 4 * i]) * de);
      }
    }
    __syncthreads();
    for (int idx = t; idx < nt * DH; idx += NT) {
      const int tt = idx / DH, d = idx % DH;
      const long long st = t0 + tt;
      dkb[st * sdk.t + d] = from_f32<T>(dks[tt][d]);
      dvb[st * sdv.t + d] = from_f32<T>(dvs[tt][d]);
      kdkb[st * DH + d] = kdks[tt][d];
    }
  }

  if (!by_col) {  // dS0 = G_{-1}; <s0, dS0> of row d
    const long long row = (long long)bh * DH * DH + own * DH;
    A c = 0;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      ds0[row + q + 4 * i] = float(G[i]);
      c = mad(A(s0[row + q + 4 * i]), G[i], c);
    }
    c = quad_sum(c);
    if (q == 0) {
      c0[bh * DH + own] = c;
      du_part[bh * DH + own] = du_acc;
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(4 * DH)
wkv6_bwd_forward(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ lw,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 const T* __restrict__ dout,
                 const typename Acc<T>::type* __restrict__ kdk,
                 const typename Acc<T>::type* __restrict__ c0,
                 T* __restrict__ dr, float* __restrict__ dlw, Strides sr,
                 Strides sk, Strides sv, Strides sw, Strides sdo,
                 Strides sdr, Strides sdlw, int H, int Tn) {
  using A = typename Acc<T>::type;
  constexpr int RPT = DH / 4;
  constexpr int NT = 4 * DH;
  __shared__ float rs[TC][DH], ks[TC][DH], vs[TC][DH], ds[TC][DH],
      ws[TC][DH], drs[TC][DH], dls[TC][DH];
  __shared__ A kdks[TC][DH];
  __shared__ float vdo[TC];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int t = threadIdx.x;
  const int d = t / 4, q = t % 4;  // row d, columns q + 4i

  A S[RPT];
  const float* s0p = s0 + (long long)bh * DH * DH + d * DH;
#pragma unroll
  for (int i = 0; i < RPT; ++i) S[i] = s0p[q + 4 * i];
  A P = c0[bh * DH + d];  // <G_{t-1}, S_{t-1}> of row d, from <s0, dS0>
  const float uu = u[h * DH + d];

  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* wb = lw + b * sw.b + h * sw.h;
  const T* db = dout + b * sdo.b + h * sdo.h;
  const A* kdkb = kdk + (long long)bh * Tn * DH;
  T* drb = dr + b * sdr.b + h * sdr.h;
  float* dlb = dlw + b * sdlw.b + h * sdlw.h;

  for (int t0 = 0; t0 < Tn; t0 += TC) {
    const int nt = min(TC, Tn - t0);
    __syncthreads();  // the previous tile's outputs have left
    for (int idx = t; idx < nt * DH; idx += NT)
      kdks[idx / DH][idx % DH] = kdkb[(long long)t0 * DH + idx];
    stage<T, DH, NT>(rs, ks, vs, ds, ws, vdo, nullptr, nullptr, rb, kb, vb,
                     wb, db, sr, sk, sv, sw, sdo, t0, nt);

#pragma unroll 1
    for (int tt = 0; tt < nt; ++tt) {
      A acc = 0;  // dr~[d] = sum_e S[d, e] do[e]
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        acc = mad(S[i], A(ds[tt][q + 4 * i]), acc);
      acc = quad_sum(acc);
      const A rd = rs[tt][d], kd = ks[tt][d], wd = ws[tt][d];
      const A dl = mad(-rd, acc, P);
      P = dl + kdks[tt][d];
      if (q == 0) {
        drs[tt][d] = fmaf(uu * float(kd), vdo[tt], float(acc));
        dls[tt][d] = float(dl);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        S[i] = mad(wd, S[i], kd * A(vs[tt][q + 4 * i]));
    }
    __syncthreads();
    for (int idx = t; idx < nt * DH; idx += NT) {
      const int tt = idx / DH, dd = idx % DH;
      const long long st = t0 + tt;
      drb[st * sdr.t + dd] = from_f32<T>(drs[tt][dd]);
      dlb[st * sdlw.t + dd] = dls[tt][dd];
    }
  }
}

// du[h, d] = sum_p du_part[p, h, d], p in order: (b) for the sweeps,
// (b, chunk) for the chunked route.
__global__ void wkv6_bwd_du(const float* __restrict__ du_part,
                            float* __restrict__ du, int parts, int HD) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HD) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += du_part[(long long)p * HD + i];
  du[i] = s;
}

// --- bf16: the chunked form on the tensor cores ---------------------------

using bf16 = __nv_bfloat16;
using tc::cp_async;
using tc::cp_async_commit;
using tc::cp_async_wait_all;
using tc::ex2;
using tc::mma_bf16;
using tc::pack_bf16;
using tc::smem_u32;

constexpr int L = 64;        // steps per chunk
constexpr int DP = 64;       // head dim padded
constexpr int XP = DP + 8;   // bf16 row pitch (an odd multiple of 16 B)
constexpr int WP = DP + 4;   // f32 row pitch of lw / cw and of the prefix
constexpr int DT = 16 + 1;   // row pitch of a warp's 16 x 16 diagonal tile
constexpr int XS = L * XP, WS = L * WP;
constexpr int NTH = 128;     // four warps
constexpr int SCAN_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;
// phase 1: r, k, v, do [L][XP] and lw [L][WP]
constexpr size_t SMEM1 = sizeof(bf16) * 4 * XS + sizeof(float) * WS;
// phase 3: r, k, v, do [L][XP]; S0, Ge [DP][XP]; cw, dr~ and the prefix,
// dk~ [L][WP];
// four diagonal tiles [16][DT]; v . do and the adjacent do_i . v_{i-1}
// [L]; u, the first dlw, du's two halves, the prefix's first half [DP]
constexpr size_t SMEM3 = sizeof(bf16) * 6 * XS +
                         sizeof(float) * (3 * WS + 4 * 16 * DT + 2 * L + 5 * DP);

__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float bf1(const bf16* p) {
  return __bfloat162float(*p);
}
// cwp at step i, column d (0 at the chunk's first step)
__device__ __forceinline__ float cwp1(const float* w, int i, int d) {
  return i > 0 ? w[(i - 1) * WP + d] : 0.f;
}
__device__ __forceinline__ float2 cwp2(const float* w, int i, int d) {
  return i > 0 ? f2(w + (i - 1) * WP + d) : make_float2(0.f, 0.f);
}

// (Fragment layouts: tensor_core.cuh.) A fragment of rows m0 .. m0 + 15,
// columns k0 .. k0 + 15 of a row-major [m][k] bf16 tile
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* base,
                                     int m0, int k0) {
  const int lane = threadIdx.x % 32;
  tc::ldsm_x4(a, smem_u32(base + (m0 + lane % 16) * XP + k0 + 8 * (lane / 16)));
}
// B fragments of the n-tiles n0 and n0 + 8 over k0 .. k0 + 15 of a tile
// stored [n][k] (b[0], b[1] of the first, b[2], b[3] of the second)
__device__ __forceinline__ void ld_b_nk(uint32_t (&b)[4], const bf16* base,
                                        int n0, int k0) {
  const int lane = threadIdx.x % 32;
  tc::ldsm_x4(b, smem_u32(base + (n0 + lane % 8 + 8 * (lane / 16)) * XP + k0 +
                          8 * ((lane / 8) % 2)));
}
// ... of a tile stored [k][n]
__device__ __forceinline__ void ld_b_kn(uint32_t (&b)[4], const bf16* base,
                                        int k0, int n0) {
  const int lane = threadIdx.x % 32;
  tc::ldsm_x4_t(b, smem_u32(base + (k0 + lane % 8 + 8 * ((lane / 8) % 2)) * XP +
                            n0 + 8 * (lane / 16)));
}
// the A fragment of k-step J from the C fragments of n-tiles 2J, 2J + 1
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}
template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}
// acc[n-tiles 0..7] += a x (B fragments of a 16 x 64 tile in four pairs)
__device__ __forceinline__ void mma_row(float (&acc)[8][4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[4][4]) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    mma_bf16(acc[2 * p], a, b[p][0], b[p][1]);
    mma_bf16(acc[2 * p + 1], a, b[p][2], b[p][3]);
  }
}

// Chunk c of r, k, v, do (bf16) and lw (f32) into shared memory by
// cp.async, rows past T zero-filled.
__device__ __forceinline__ void load_chunk(bf16* Rs, bf16* Ks, bf16* Vs, bf16* Ds,
                                           float* Ws, const bf16* rb, const bf16* kb,
                                           const bf16* vb, const bf16* db,
                                           const float* wb, Strides sr, Strides sk,
                                           Strides sv, Strides sd, Strides sw,
                                           int c, int Tn, int Dh) {
  const int t = threadIdx.x;
  const int pc = Dh / 8, wc = Dh / 4;  // 16-byte pieces of a row
  for (int e = t; e < L * pc; e += NTH) {
    const int row = e / pc, kk = e % pc;
    const int tt = c * L + row;
    const bool ok = tt < Tn;
    const long long src = ok ? tt : 0;
    const int off = row * XP + 8 * kk;
    cp_async<16>(smem_u32(Rs + off), rb + src * sr.t + 8 * kk, ok ? 16 : 0);
    cp_async<16>(smem_u32(Ks + off), kb + src * sk.t + 8 * kk, ok ? 16 : 0);
    cp_async<16>(smem_u32(Vs + off), vb + src * sv.t + 8 * kk, ok ? 16 : 0);
    cp_async<16>(smem_u32(Ds + off), db + src * sd.t + 8 * kk, ok ? 16 : 0);
  }
  for (int e = t; e < L * wc; e += NTH) {
    const int row = e / wc, kk = e % wc;
    const int tt = c * L + row;
    const bool ok = tt < Tn;
    cp_async<16>(smem_u32(Ws + row * WP + 4 * kk),
                 wb + (long long)(ok ? tt : 0) * sw.t + 4 * kk, ok ? 16 : 0);
  }
  cp_async_commit();
}

// cw = cumsum(lw log2 e) over the chunk, in place: thread (d, half) scans
// 32 steps, then the second half adds the first half's total.
__device__ __forceinline__ void scan_cw(float* Ws) {
  const int t = threadIdx.x;
  const int d = t % DP, half = t / DP;
  float* p = Ws + 32 * half * WP + d;
  float x[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = p[i * WP];
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    run = fmaf(x[i], LOG2E, run);
    x[i] = run;
  }
  if (half == 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i * WP] = x[i];
  }
  __syncthreads();
  if (half == 1) {
    const float base = Ws[31 * WP + d];
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i * WP] = x[i] + base;
  }
  __syncthreads();
}

// Zero `bytes` of shared memory from `base` (a multiple of 16): the
// padding columns Dh .. DP - 1 stay zero, the copies write only the real
// ones.
__device__ __forceinline__ void zero_smem(void* base, size_t bytes) {
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (size_t e = threadIdx.x; e < bytes / 16; e += NTH)
    reinterpret_cast<uint4*>(base)[e] = z;
}

struct ChunkArgs {
  const bf16 *r, *k, *v, *dout;
  const float *lw, *u, *s0, *dsT;
  bf16 *dr, *dk, *dv;
  float *dlw, *du, *ds0;
  float *dS, *dG, *cwl, *first, *du_part;  // scratch
  Strides sr, sk, sv, sw, sd, sdr, sdk, sdv, sdlw;
  int B, H, Tn, Dh, nc;
};

// Phase 1: the chunk's own dS = kdec^T v, dG = rdec^T do and its cwl.
__global__ void __launch_bounds__(NTH)
wkv6_bwd_chunk_states(ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Rs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Rs + XS;
  bf16* Vs = Ks + XS;
  bf16* Ds = Vs + XS;
  float* Ws = reinterpret_cast<float*>(Ds + XS);
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int T0 = 16 * warp;  // this warp's state rows

  if (a.Dh < DP) {
    zero_smem(smem_raw, SMEM1);
    __syncthreads();
  }
  load_chunk(Rs, Ks, Vs, Ds, Ws, a.r + b * a.sr.b + h * a.sr.h,
             a.k + b * a.sk.b + h * a.sk.h, a.v + b * a.sv.b + h * a.sv.h,
             a.dout + b * a.sd.b + h * a.sd.h, a.lw + b * a.sw.b + h * a.sw.h,
             a.sr, a.sk, a.sv, a.sd, a.sw, c, a.Tn, a.Dh);
  cp_async_wait_all();
  __syncthreads();
  scan_cw(Ws);

  // rows d = T0 + g (+8) of the A fragments kdec^T and rdec^T over the
  // steps s = 16J + 2tq (+1) (+8), by ldmatrix.trans of k and r
  const float cl0 = Ws[(L - 1) * WP + T0 + g], cl1 = Ws[(L - 1) * WP + T0 + g + 8];
  float sacc[8][4], gacc[8][4];
  zero(sacc);
  zero(gacc);
#pragma unroll
  for (int J = 0; J < L / 16; ++J) {
    uint32_t kr[4], rr[4], kd[4], rd[4];
    const uint32_t off = (16 * J + lane % 8 + 8 * (lane / 16)) * XP + T0 + 8 * ((lane / 8) % 2);
    tc::ldsm_x4_t(kr, smem_u32(Ks + off));
    tc::ldsm_x4_t(rr, smem_u32(Rs + off));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = T0 + g + 8 * (i & 1), s = 16 * J + 2 * tq + 8 * (i >> 1);
      const float cl = (i & 1) ? cl1 : cl0;
      const float2 kv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&kr[i]));
      const float2 rv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rr[i]));
      kd[i] = pack_bf16(kv.x * ex2(cl - Ws[s * WP + d]), kv.y * ex2(cl - Ws[(s + 1) * WP + d]));
      rd[i] = pack_bf16(rv.x * ex2(cwp1(Ws, s, d)), rv.y * ex2(Ws[s * WP + d]));
    }
    uint32_t bv[4][4], bd[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      ld_b_kn(bv[p], Vs, 16 * J, 16 * p);
      ld_b_kn(bd[p], Ds, 16 * J, 16 * p);
    }
    mma_row(sacc, kd, bv);
    mma_row(gacc, rd, bd);
  }
  const long long base = ((long long)bh * a.nc + c) * DP * DP;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf) {
      const long long idx = base + (T0 + g + 8 * hlf) * DP + 8 * j + 2 * tq;
      *reinterpret_cast<float2*>(a.dS + idx) =
          make_float2(sacc[j][2 * hlf], sacc[j][2 * hlf + 1]);
      *reinterpret_cast<float2*>(a.dG + idx) =
          make_float2(gacc[j][2 * hlf], gacc[j][2 * hlf + 1]);
    }
  }
  if (t < DP) a.cwl[((long long)bh * a.nc + c) * DP + t] = Ws[(L - 1) * WP + t];
}

// Phase 2: the boundary scan, in place over the scratch: dS -> S0 of each
// chunk, dG -> Ge of each chunk; dS0; each chunk's first dlw. Thread t
// owns the float4 t + 256 m (m < 4) of each 64 x 64 matrix: row
// t / 16 + 16 m, columns 4 (t % 16) .. + 3, so a warp's loads and stores
// are whole 512-byte runs; the next chunk's loads are issued before this
// chunk's stores.
__global__ void __launch_bounds__(SCAN_THREADS)
wkv6_bwd_chunk_scan(ChunkArgs a) {
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int t = threadIdx.x, row0 = t / 16, col = 4 * (t % 16);
  const int Dh = a.Dh, nc = a.nc;
  const long long sbase = (long long)bh * Dh * Dh;
  const float4* dS4 = reinterpret_cast<const float4*>(a.dS);
  const float4* dG4 = reinterpret_cast<const float4*>(a.dG);
  auto at = [&](int c, int m) { return ((long long)bh * nc + c) * (DP * DP / 4) + t + 256 * m; };
  auto init = [&](const float* src, float (&X)[4][4]) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = row0 + 16 * m, e = col + i;
        X[m][i] = src && d < Dh && e < Dh ? src[sbase + d * Dh + e] : 0.f;
      }
    }
  };
  float X[4][4];
  init(a.s0, X);
  float4 nx[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) nx[m] = dS4[at(0, m)];
  for (int c = 0; c < nc; ++c) {
    float4 x[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) x[m] = nx[m];
    if (c + 1 < nc) {
#pragma unroll
      for (int m = 0; m < 4; ++m) nx[m] = dS4[at(c + 1, m)];
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float w = ex2(a.cwl[((long long)bh * nc + c) * DP + row0 + 16 * m]);
      reinterpret_cast<float4*>(a.dS)[at(c, m)] = make_float4(X[m][0], X[m][1], X[m][2], X[m][3]);
      X[m][0] = fmaf(w, X[m][0], x[m].x);
      X[m][1] = fmaf(w, X[m][1], x[m].y);
      X[m][2] = fmaf(w, X[m][2], x[m].z);
      X[m][3] = fmaf(w, X[m][3], x[m].w);
    }
  }
  init(a.dsT, X);  // now the gradient
  const bf16* rb = a.r + b * a.sr.b + h * a.sr.h;
  const bf16* db = a.dout + b * a.sd.b + h * a.sd.h;
  float4 ng[4], ns[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    ng[m] = dG4[at(nc - 1, m)];
    ns[m] = dS4[at(nc - 1, m)];
  }
  for (int c = nc - 1; c >= 0; --c) {
    float4 x[4], s[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      x[m] = ng[m];
      s[m] = ns[m];
    }
    if (c > 0) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        ng[m] = dG4[at(c - 1, m)];
        ns[m] = dS4[at(c - 1, m)];
      }
    }
    const long long t0 = (long long)c * L;
    float2 d01 = make_float2(0.f, 0.f), d23 = d01;  // do_{c0}, columns col..
    if (col < Dh) {
      d01 = bf2(db + t0 * a.sd.t + col);
      d23 = bf2(db + t0 * a.sd.t + col + 2);
    }
    const float de[4] = {d01.x, d01.y, d23.x, d23.y};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int d = row0 + 16 * m;
      const float w = ex2(a.cwl[((long long)bh * nc + c) * DP + d]);
      const float r0 = d < Dh ? bf1(rb + t0 * a.sr.t + d) : 0.f;
      reinterpret_cast<float4*>(a.dG)[at(c, m)] = make_float4(X[m][0], X[m][1], X[m][2], X[m][3]);
      X[m][0] = fmaf(w, X[m][0], x[m].x);
      X[m][1] = fmaf(w, X[m][1], x[m].y);
      X[m][2] = fmaf(w, X[m][2], x[m].z);
      X[m][3] = fmaf(w, X[m][3], x[m].w);
      // <G_{c0-1} - r_{c0} do_{c0}^T, S_{c0-1}> over the row: the first
      // dlw, diag(w_{c0}) G_{c0} against S_{c0-1}
      const float sv[4] = {s[m].x, s[m].y, s[m].z, s[m].w};
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc = fmaf(fmaf(-r0, de[i], X[m][i]), sv[i], acc);
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (t % 16 == 0) a.first[((long long)bh * nc + c) * DP + d] = acc;
    }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = row0 + 16 * m, e = col + i;
      if (d < Dh && e < Dh) a.ds0[sbase + d * Dh + e] = X[m][i];
    }
  }
}

// Phase 3: the outputs of one chunk.
__global__ void __launch_bounds__(NTH, 2)
wkv6_bwd_chunk_grads(ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Rs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Rs + XS;
  bf16* Vs = Ks + XS;
  bf16* Ds = Vs + XS;
  bf16* Ss = Ds + XS;   // S0 [d][e]
  bf16* Gs = Ss + XS;   // Ge [d][e]
  float* Ws = reinterpret_cast<float*>(Gs + XS);
  float* Zs = Ws + WS;  // dr~, then the prefix of dlw [L][WP]
  float* Xk = Zs + WS;  // dk~ [L][WP]
  float* Bd = Xk + WS;  // four [16][DT] diagonal tiles: do v^T, then A^T
  float* vdo = Bd + 4 * 16 * DT;
  float* adj = vdo + L;   // adj[i] = do_i . v_{i-1}
  float* Us = adj + L;
  float* first = Us + DP;
  float* duh = first + DP;  // [2][DP]: du's share, by half
  float* tot = duh + 2 * DP;

  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int T0 = 16 * warp;  // this warp's steps
  const int Dh = a.Dh, Tn = a.Tn;
  float* bd = Bd + warp * 16 * DT;

  if (Dh < DP) {
    zero_smem(smem_raw, sizeof(bf16) * 4 * XS);
    zero_smem(Ws, sizeof(float) * WS);
    __syncthreads();
  }
  const bf16* rb = a.r + b * a.sr.b + h * a.sr.h;
  const bf16* kb = a.k + b * a.sk.b + h * a.sk.h;
  const bf16* vb = a.v + b * a.sv.b + h * a.sv.h;
  const bf16* db = a.dout + b * a.sd.b + h * a.sd.h;
  load_chunk(Rs, Ks, Vs, Ds, Ws, rb, kb, vb, db, a.lw + b * a.sw.b + h * a.sw.h,
             a.sr, a.sk, a.sv, a.sd, a.sw, c, Tn, Dh);
  {  // the boundary states as bf16, u and the first dlw
    const long long base = ((long long)bh * a.nc + c) * DP * DP;
    const float4* sp = reinterpret_cast<const float4*>(a.dS + base);
    const float4* gp = reinterpret_cast<const float4*>(a.dG + base);
    constexpr int PER = DP * DP / 4 / NTH;  // float4s a thread, all loads first
    float4 s4[PER], g4[PER];
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      s4[m] = sp[t + NTH * m];
      g4[m] = gp[t + NTH * m];
    }
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int e = t + NTH * m, row = e / (DP / 4), col = 4 * (e % (DP / 4));
      *reinterpret_cast<uint2*>(Ss + row * XP + col) =
          make_uint2(pack_bf16(s4[m].x, s4[m].y), pack_bf16(s4[m].z, s4[m].w));
      *reinterpret_cast<uint2*>(Gs + row * XP + col) =
          make_uint2(pack_bf16(g4[m].x, g4[m].y), pack_bf16(g4[m].z, g4[m].w));
    }
    if (t < DP) {
      Us[t] = t < Dh ? a.u[h * Dh + t] : 0.f;
      first[t] = a.first[((long long)bh * a.nc + c) * DP + t];
    }
  }
  cp_async_wait_all();
  __syncthreads();
  scan_cw(Ws);
  {  // v_i . do_i and do_i . v_{i-1}, exact in f32
    const int i = t % L;
    const bf16* dp = Ds + i * XP;
    const bf16* vp = Vs + (t < L ? i : i - 1) * XP;
    float acc0 = 0.f, acc1 = 0.f;
    if (t < L || i > 0) {
#pragma unroll 8
      for (int e = 0; e < DP; e += 2) {
        const float2 x = bf2(dp + e), y = bf2(vp + e);
        acc0 = fmaf(x.x, y.x, acc0);
        acc1 = fmaf(x.y, y.y, acc1);
      }
    }
    (t < L ? vdo : adj)[i] = acc0 + acc1;
  }
  __syncthreads();

  // this lane's C-fragment rows and columns: row T0 + g + 8 (e >> 1),
  // column 8 nt + 2 tq + (e & 1)
  const float* cwl = Ws + (L - 1) * WP;
  auto out_row_ok = [&](int i) { return c * L + i < Tn; };

  // ---- do v^T (rows i) and dr ------------------------------------------
  {
    float bm[8][4];
    zero(bm);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t af[4];
      ld_a(af, Ds, T0, 16 * ks);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p > warp) break;
        uint32_t bx[4];
        ld_b_nk(bx, Vs, 16 * p, 16 * ks);
        mma_bf16(bm[2 * p], af, bx[0], bx[1]);
        mma_bf16(bm[2 * p + 1], af, bx[2], bx[3]);
      }
    }
    // the diagonal tile, f32, for the exact quadrants
#pragma unroll
    for (int J = 0; J < 4; ++J) {
      if (J != warp) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          bd[(g + 8 * (e >> 1)) * DT + 8 * nt + 2 * tq + (e & 1)] = bm[2 * J + nt][e];
      }
    }
    // keep j <= i - 2 only: the adjacent pairs go in exactly, below
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = T0 + g + 8 * (e >> 1), j = 8 * nt + 2 * tq + (e & 1);
        if (j > i - 2) bm[nt][e] = 0.f;
      }
    }
    float res[8][4], acc[8][4];
    zero(res);
    // the step tiles before this warp's rows, at the reference cwp[T0]:
    // kr = k 2^(cwp[T0] - cw[j]) as B fragments (rows j, columns d)
    if (warp > 0) {
      zero(acc);
#pragma unroll
      for (int J = 0; J < 3; ++J) {
        if (J >= warp) break;
        uint32_t af[4];
        c_to_a(af, bm[2 * J], bm[2 * J + 1]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int d = 8 * nt + g;
          const float rf = Ws[(T0 - 1) * WP + d];
          uint32_t bb[2];
#pragma unroll
          for (int kh = 0; kh < 2; ++kh) {
            const int j = 16 * J + 2 * tq + 8 * kh;
            bb[kh] = pack_bf16(bf1(Ks + j * XP + d) * ex2(rf - Ws[j * WP + d]),
                               bf1(Ks + (j + 1) * XP + d) * ex2(rf - Ws[(j + 1) * WP + d]));
          }
          mma_bf16(acc[nt], af, bb[0], bb[1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = T0 + g + 8 * (e >> 1), d = 8 * nt + 2 * tq + (e & 1);
          res[nt][e] = acc[nt][e] * ex2(Ws[(i - 1) * WP + d] - Ws[(T0 - 1) * WP + d]);
        }
      }
    }
    // the diagonal tile's quadrant i >= T0 + 8 > j, at cw[T0 + 7]
    {
      zero(acc);
      uint32_t af[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int J = 0; J < 4; ++J)
        if (J == warp) af[1] = pack_bf16(bm[2 * J][2], bm[2 * J][3]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int d = 8 * nt + g, j = T0 + 2 * tq;
        const float rf = Ws[(T0 + 7) * WP + d];
        const uint32_t b0 = pack_bf16(bf1(Ks + j * XP + d) * ex2(rf - Ws[j * WP + d]),
                                      bf1(Ks + (j + 1) * XP + d) * ex2(rf - Ws[(j + 1) * WP + d]));
        mma_bf16(acc[nt], af, b0, 0u);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 2; e < 4; ++e) {
          const int i = T0 + g + 8, d = 8 * nt + 2 * tq + (e & 1);
          res[nt][e] += acc[nt][e] * ex2(Ws[(i - 1) * WP + d] - Ws[(T0 + 7) * WP + d]);
        }
      }
    }
    // the state before the chunk: 2^cwp[i] (do S0^T)
    zero(acc);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t af[4], bx[4][4];
      ld_a(af, Ds, T0, 16 * ks);
#pragma unroll
      for (int p = 0; p < 4; ++p) ld_b_nk(bx[p], Ss, 16 * p, 16 * ks);
      mma_row(acc, af, bx);
    }
    // dr~ without its diagonal quadrants, to this warp's rows of Zs
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int hl = 0; hl < 2; ++hl) {
        const int i = T0 + g + 8 * hl, d = 8 * nt + 2 * tq;
        const float2 ci = cwp2(Ws, i, d);
        *reinterpret_cast<float2*>(Zs + i * WP + d) =
            make_float2(res[nt][2 * hl] + acc[nt][2 * hl] * ex2(ci.x),
                        res[nt][2 * hl + 1] + acc[nt][2 * hl + 1] * ex2(ci.y));
      }
    }
  }

  // ---- v do^T (rows j) and dk~ without its diagonal quadrants, to this
  // warp's rows of Xk
  {
    float bm[8][4];  // (do_i . v_j) as rows j, columns i
    zero(bm);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t af[4];
      ld_a(af, Vs, T0, 16 * ks);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p < warp) continue;
        uint32_t bx[4];
        ld_b_nk(bx, Ds, 16 * p, 16 * ks);
        mma_bf16(bm[2 * p], af, bx[0], bx[1]);
        mma_bf16(bm[2 * p + 1], af, bx[2], bx[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = T0 + g + 8 * (e >> 1), i = 8 * nt + 2 * tq + (e & 1);
        if (i < j + 2) bm[nt][e] = 0.f;
      }
    }
    float res[8][4], acc[8][4];
    zero(res);
    // the step tiles after this warp's rows, at the reference cw[T0 + 15]:
    // rk = r 2^(cwp[i] - cw[T0+15]) as B fragments (rows i, columns d)
    if (warp < 3) {
      zero(acc);
#pragma unroll
      for (int J = 1; J < 4; ++J) {
        if (J <= warp) continue;
        uint32_t af[4];
        c_to_a(af, bm[2 * J], bm[2 * J + 1]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int d = 8 * nt + g;
          const float rf = Ws[(T0 + 15) * WP + d];
          uint32_t bb[2];
#pragma unroll
          for (int kh = 0; kh < 2; ++kh) {
            const int i = 16 * J + 2 * tq + 8 * kh;
            bb[kh] = pack_bf16(bf1(Rs + i * XP + d) * ex2(Ws[(i - 1) * WP + d] - rf),
                               bf1(Rs + (i + 1) * XP + d) * ex2(Ws[i * WP + d] - rf));
          }
          mma_bf16(acc[nt], af, bb[0], bb[1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = T0 + g + 8 * (e >> 1), d = 8 * nt + 2 * tq + (e & 1);
          res[nt][e] = acc[nt][e] * ex2(Ws[(T0 + 15) * WP + d] - Ws[j * WP + d]);
        }
      }
    }
    // the diagonal tile's quadrant j < T0 + 8 <= i, at cw[T0 + 7]
    {
      zero(acc);
      uint32_t af[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int J = 0; J < 4; ++J)
        if (J == warp) af[2] = pack_bf16(bm[2 * J + 1][0], bm[2 * J + 1][1]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int d = 8 * nt + g, i = T0 + 8 + 2 * tq;
        const float rf = Ws[(T0 + 7) * WP + d];
        const uint32_t b1 = pack_bf16(bf1(Rs + i * XP + d) * ex2(Ws[(i - 1) * WP + d] - rf),
                                      bf1(Rs + (i + 1) * XP + d) * ex2(Ws[i * WP + d] - rf));
        mma_bf16(acc[nt], af, 0u, b1);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = T0 + g, d = 8 * nt + 2 * tq + e;
          res[nt][e] += acc[nt][e] * ex2(Ws[(T0 + 7) * WP + d] - Ws[j * WP + d]);
        }
      }
    }
    // the gradient after the chunk: 2^(cwl - cw[j]) (v Ge^T)
    zero(acc);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t af[4], bx[4][4];
      ld_a(af, Vs, T0, 16 * ks);
#pragma unroll
      for (int p = 0; p < 4; ++p) ld_b_nk(bx[p], Gs, 16 * p, 16 * ks);
      mma_row(acc, af, bx);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int hl = 0; hl < 2; ++hl) {
        const int j = T0 + g + 8 * hl, d = 8 * nt + 2 * tq;
        const float2 cj = f2(Ws + j * WP + d), cl = f2(cwl + d);
        *reinterpret_cast<float2*>(Xk + j * WP + d) =
            make_float2(res[nt][2 * hl] + acc[nt][2 * hl] * ex2(cl.x - cj.x),
                        res[nt][2 * hl + 1] + acc[nt][2 * hl + 1] * ex2(cl.y - cj.y));
      }
    }
  }
  __syncwarp();

  // ---- the two 8 x 8 diagonal quadrants of dr~ and dk~, pairs j <= i - 2
  // (the adjacent ones go in exactly below), with the exact pairwise
  // exponent: lane l owns the columns 2l, 2l + 1 and each exponent serves
  // both
  {
    const int d = 2 * lane;
#pragma unroll 1
    for (int o = 0; o < 16; o += 8) {
      const int s0 = T0 + o;
      float2 rq[8], kq[8], cq[8], pq[8], xr[8], xk[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        rq[q] = bf2(Rs + (s0 + q) * XP + d);
        kq[q] = bf2(Ks + (s0 + q) * XP + d);
        cq[q] = f2(Ws + (s0 + q) * WP + d);
        pq[q] = cwp2(Ws, s0 + q, d);
        xr[q] = f2(Zs + (s0 + q) * WP + d);
        xk[q] = f2(Xk + (s0 + q) * WP + d);
      }
#pragma unroll
      for (int i = 2; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j <= i - 2; ++j) {
          const float m = bd[(o + i) * DT + o + j];
          const float e0 = ex2(pq[i].x - cq[j].x), e1 = ex2(pq[i].y - cq[j].y);
          xr[i].x = fmaf(m * kq[j].x, e0, xr[i].x);
          xr[i].y = fmaf(m * kq[j].y, e1, xr[i].y);
          xk[j].x = fmaf(m * rq[i].x, e0, xk[j].x);
          xk[j].y = fmaf(m * rq[i].y, e1, xk[j].y);
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        *reinterpret_cast<float2*>(Zs + (s0 + q) * WP + d) = xr[q];
        *reinterpret_cast<float2*>(Xk + (s0 + q) * WP + d) = xk[q];
      }
    }
  }
  __syncwarp();

  // ---- dr out: dr~ + the adjacent pair + the bonus; -r dr~ (0 at the
  // chunk's first step) to the prefix's row i
  {
    bf16* drb = a.dr + b * a.sdr.b + h * a.sdr.h;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int hl = 0; hl < 2; ++hl) {
        const int i = T0 + g + 8 * hl, d = 8 * nt + 2 * tq;
        float2* zp = reinterpret_cast<float2*>(Zs + i * WP + d);
        const float2 x = *zp;
        const float2 rr = bf2(Rs + i * XP + d), kk = bf2(Ks + i * XP + d);
        const float2 uu = f2(Us + d);
        *zp = i > 0 ? make_float2(-rr.x * x.x, -rr.y * x.y) : make_float2(0.f, 0.f);
        float y0 = fmaf(uu.x * kk.x, vdo[i], x.x), y1 = fmaf(uu.y * kk.y, vdo[i], x.y);
        if (i > 0) {
          const float2 kp = bf2(Ks + (i - 1) * XP + d);
          y0 = fmaf(adj[i], kp.x, y0);
          y1 = fmaf(adj[i], kp.y, y1);
        }
        if (out_row_ok(i) && d < Dh)
          *reinterpret_cast<__nv_bfloat162*>(drb + (long long)(c * L + i) * a.sdr.t + d) =
              __floats2bfloat162_rn(y0, y1);
      }
    }
  }
  __syncthreads();  // every row of the prefix holds -r dr~

  // ---- dk out: dk~ + the adjacent pair + the bonus; k dk~ to the prefix's
  // row j + 1
  {
    bf16* dkb = a.dk + b * a.sdk.b + h * a.sdk.h;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int hl = 0; hl < 2; ++hl) {
        const int j = T0 + g + 8 * hl, d = 8 * nt + 2 * tq;
        const float2 x = f2(Xk + j * WP + d);
        const float2 rr = bf2(Rs + j * XP + d), kk = bf2(Ks + j * XP + d);
        const float2 uu = f2(Us + d);
        float y0 = fmaf(uu.x * rr.x, vdo[j], x.x), y1 = fmaf(uu.y * rr.y, vdo[j], x.y);
        if (j < L - 1) {
          float2* zp = reinterpret_cast<float2*>(Zs + (j + 1) * WP + d);
          const float2 z = *zp;
          *zp = make_float2(fmaf(kk.x, x.x, z.x), fmaf(kk.y, x.y, z.y));
          const float2 rn = bf2(Rs + (j + 1) * XP + d);
          y0 = fmaf(adj[j + 1], rn.x, y0);
          y1 = fmaf(adj[j + 1], rn.y, y1);
        }
        if (out_row_ok(j) && d < Dh)
          *reinterpret_cast<__nv_bfloat162*>(dkb + (long long)(c * L + j) * a.sdk.t + d) =
              __floats2bfloat162_rn(y0, y1);
      }
    }
  }
  __syncthreads();

  // ---- dlw_i = the first dlw + sum_{m < i} k_m dk~_m - sum_{m <= i} r_m
  // dr~_m (the adjacent pairs out, step 0's term in the first dlw): the
  // inclusive prefix of the rows; du's share. Thread (d, half) scans 32
  // steps of column d.
  {
    const int d = t % DP, half = t / DP;
    float* p = Zs + 32 * half * WP + d;
    float run = 0.f, dus = 0.f;
#pragma unroll 8
    for (int i = 0; i < 32; ++i) {
      run += p[i * WP];
      p[i * WP] = run;
      const int s = 32 * half + i;
      dus = fmaf(bf1(Rs + s * XP + d) * bf1(Ks + s * XP + d), vdo[s], dus);
    }
    duh[half * DP + d] = dus;
    if (half == 0) tot[d] = run;
    __syncthreads();
    if (half == 1) {
      const float base = tot[d];
#pragma unroll 8
      for (int i = 0; i < 32; ++i) p[i * WP] += base;
    }
    __syncthreads();
    if (t < Dh)
      a.du_part[(((long long)b * a.nc + c) * a.H + h) * Dh + t] = duh[t] + duh[DP + t];
  }
  float* dlb = a.dlw + b * a.sdlw.b + h * a.sdlw.h;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int hl = 0; hl < 2; ++hl) {
      const int i = T0 + g + 8 * hl, d = 8 * nt + 2 * tq;
      const float2 z = f2(Zs + i * WP + d);
      if (out_row_ok(i) && d < Dh)
        *reinterpret_cast<float2*>(dlb + (long long)(c * L + i) * a.sdlw.t + d) =
            make_float2(first[d] + z.x, first[d + 1] + z.y);
    }
  }

  // ---- A^T (rows j, columns i >= j) and dv ----------------------------
  {
    float at[8][4];
    zero(at);
    // the tiles after this warp's rows, at the reference cw[T0 + 15]:
    // kt = k 2^(cw[T0+15] - cw[j]) (A fragments), rt = r 2^(cwp[i] - cw[T0+15])
    if (warp < 3) {
      uint32_t kt[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = T0 + g + 8 * (i & 1), d = 16 * ks + 2 * tq + 8 * (i >> 1);
          const float2 rf = f2(Ws + (T0 + 15) * WP + d), cj = f2(Ws + j * WP + d);
          const float2 kk = bf2(Ks + j * XP + d);
          kt[ks][i] = pack_bf16(kk.x * ex2(rf.x - cj.x), kk.y * ex2(rf.y - cj.y));
        }
      }
#pragma unroll
      for (int J = 1; J < 4; ++J) {
        if (J <= warp) continue;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            uint32_t bb[2];
            const int i = 16 * J + 8 * nt + g;
#pragma unroll
            for (int kh = 0; kh < 2; ++kh) {
              const int d = 16 * ks + 2 * tq + 8 * kh;
              const float2 rf = f2(Ws + (T0 + 15) * WP + d), ci = cwp2(Ws, i, d);
              const float2 rr = bf2(Rs + i * XP + d);
              bb[kh] = pack_bf16(rr.x * ex2(ci.x - rf.x), rr.y * ex2(ci.y - rf.y));
            }
            mma_bf16(at[2 * J + nt], kt[ks], bb[0], bb[1]);
          }
        }
      }
    }
    // the diagonal tile's quadrant j < T0 + 8 <= i at the reference
    // cw[T0 + 7]: rows g of the A fragment, rows g + 8 zero
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t af[4] = {0u, 0u, 0u, 0u}, bb[2];
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const int d = 16 * ks + 2 * tq + 8 * kh;
        const float2 rf = f2(Ws + (T0 + 7) * WP + d);
        const int j = T0 + g, i = T0 + 8 + g;
        const float2 cj = f2(Ws + j * WP + d), ci = f2(Ws + (i - 1) * WP + d);
        const float2 kk = bf2(Ks + j * XP + d), rr = bf2(Rs + i * XP + d);
        af[2 * kh] = pack_bf16(kk.x * ex2(rf.x - cj.x), kk.y * ex2(rf.y - cj.y));
        bb[kh] = pack_bf16(rr.x * ex2(ci.x - rf.x), rr.y * ex2(ci.y - rf.y));
      }
#pragma unroll
      for (int J = 0; J < 4; ++J)
        if (J == warp) mma_bf16(at[2 * J + 1], af, bb[0], bb[1]);
    }
    // ... and its two 8 x 8 diagonal quadrants, one pair (i > j) a lane,
    // with the exact exponent; the bonus r . (u k) on the diagonal
    int ti = 1, si = lane;
    while (si >= ti) si -= ti++;
    if (lane < 28) {
#pragma unroll
      for (int o = 0; o < 16; o += 8) {
        const int i = T0 + o + ti, j = T0 + o + si;
        const bf16* rp = Rs + i * XP;
        const bf16* kp = Ks + j * XP;
        const float* ci = Ws + (i - 1) * WP;
        const float* cj = Ws + j * WP;
        float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 8
        for (int d = 0; d < DP; d += 2) {
          const float2 rr = bf2(rp + d), kk = bf2(kp + d);
          const float2 x = f2(ci + d), y = f2(cj + d);
          acc0 = fmaf(rr.x * kk.x, ex2(x.x - y.x), acc0);
          acc1 = fmaf(rr.y * kk.y, ex2(x.y - y.y), acc1);
        }
        bd[(o + si) * DT + o + ti] = acc0 + acc1;
      }
    }
    if (lane < 16) {
      const bf16* rp = Rs + (T0 + lane) * XP;
      const bf16* kp = Ks + (T0 + lane) * XP;
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 8
      for (int d = 0; d < DP; d += 2) {
        const float2 rr = bf2(rp + d), kk = bf2(kp + d), uu = f2(Us + d);
        acc0 = fmaf(rr.x * kk.x, uu.x, acc0);
        acc1 = fmaf(rr.y * kk.y, uu.y, acc1);
      }
      bd[lane * DT + lane] = acc0 + acc1;
    }
    __syncwarp();
#pragma unroll
    for (int J = 0; J < 4; ++J) {
      if (J != warp) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = g + 8 * (e >> 1), ii = 8 * nt + 2 * tq + (e & 1);
          float& x = at[2 * J + nt][e];
          x = ii < jj ? 0.f : (jj < 8 && ii >= 8 ? x : bd[jj * DT + ii]);
        }
      }
    }
    // dv = A^T do over the step tiles from this warp's on, + kdec Ge
    float acc[8][4];
    zero(acc);
#pragma unroll
    for (int J = 0; J < 4; ++J) {
      if (J < warp) continue;
      uint32_t af[4], bx[4][4];
      c_to_a(af, at[2 * J], at[2 * J + 1]);
#pragma unroll
      for (int p = 0; p < 4; ++p) ld_b_kn(bx[p], Ds, 16 * J, 16 * p);
      mma_row(acc, af, bx);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t af[4], bx[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = T0 + g + 8 * (i & 1), d = 16 * ks + 2 * tq + 8 * (i >> 1);
        const float2 cl = f2(cwl + d), cj = f2(Ws + j * WP + d);
        const float2 kk = bf2(Ks + j * XP + d);
        af[i] = pack_bf16(kk.x * ex2(cl.x - cj.x), kk.y * ex2(cl.y - cj.y));
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) ld_b_kn(bx[p], Gs, 16 * ks, 16 * p);
      mma_row(acc, af, bx);
    }
    bf16* dvb = a.dv + b * a.sdv.b + h * a.sdv.h;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int hl = 0; hl < 2; ++hl) {
        const int j = T0 + g + 8 * hl, e = 8 * nt + 2 * tq;
        if (out_row_ok(j) && e < Dh)
          *reinterpret_cast<__nv_bfloat162*>(dvb + (long long)(c * L + j) * a.sdv.t + e) =
              __floats2bfloat162_rn(acc[nt][2 * hl], acc[nt][2 * hl + 1]);
      }
    }
  }
}

struct Args {
  const void *r, *k, *v;
  const float *lw, *u, *s0;
  const void* dout;
  const float* dsT;
  void *dr, *dk, *dv;
  float *dlw, *du, *ds0, *du_part;
  void *kdk, *c0;  // f64 scratch
};

template <int DH>
int launch(const Args& a, const Strides (&s)[9], int B, int H, int Tn,
           cudaStream_t stream) {
  // s: r, k, v, lw, do, dr, dk, dv, dlw
  using T = float;
  using A = typename Acc<T>::type;
  const T *r = static_cast<const T*>(a.r), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v),
          *dout = static_cast<const T*>(a.dout);
  COVER(0, (long long)B * H, 1);
  LAUNCH((wkv6_bwd_reverse<T, DH>), B * H, 8 * DH, 0, stream,
      r, k, v, a.lw, a.u, a.s0, dout, a.dsT, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), static_cast<A*>(a.kdk), static_cast<A*>(a.c0),
      a.ds0, a.du_part, s[0], s[1], s[2], s[3], s[4], s[6], s[7], H, Tn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  COVER(0, (long long)B * H, 1);
  LAUNCH((wkv6_bwd_forward<T, DH>), B * H, 4 * DH, 0, stream,
      r, k, v, a.lw, a.u, a.s0, dout, static_cast<const A*>(a.kdk),
      static_cast<const A*>(a.c0), static_cast<T*>(a.dr), a.dlw, s[0], s[1],
      s[2], s[3], s[4], s[5], s[8], H, Tn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int HD = H * DH;
  COVER(0, HD, 256);
  LAUNCH((wkv6_bwd_du), (HD + 255) / 256, 256, 0, stream, a.du_part, a.du, B, HD);
  return static_cast<int>(cudaGetLastError());
}

int launch_chunked(ChunkArgs& a, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        wkv6_bwd_chunk_states, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM1));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(wkv6_bwd_chunk_grads,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(SMEM3));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(wkv6_bwd_chunk_grads,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(a.nc, a.B * a.H);
  COVER(0, a.Tn, L);
  COVER(1, (long long)a.B * a.H, 1);
  LAUNCH((wkv6_bwd_chunk_states), grid, NTH, SMEM1, stream, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  COVER(0, (long long)a.B * a.H, 1);
  LAUNCH((wkv6_bwd_chunk_scan), a.B * a.H, SCAN_THREADS, 0, stream, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  COVER(0, a.Tn, L);
  COVER(1, (long long)a.B * a.H, 1);
  LAUNCH((wkv6_bwd_chunk_grads), grid, NTH, SMEM3, stream, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int HD = a.H * a.Dh;
  COVER(0, HD, 256);
  LAUNCH((wkv6_bwd_du), (HD + 255) / 256, 256, 0, stream, a.du_part, a.du,
         a.B * a.nc, HD);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 (the step sweeps). r, k, v, lw, do, dr, dk, dv, dlw: (B, H, T, Dh);
// element (b, h, t, d) of each lies at base + b*st[0] + h*st[1] + t*st[2]
// + d, the strides (in elements) given in that order in st[27]. u (H, Dh),
// s0, dS_T (may be null: zero) and dS0 (B, H, Dh, Dh), du (H, Dh) and
// du_part (B, H, Dh) are contiguous f32; lw and dlw are f32. The scratch
// kdk (B, H, T, Dh) and c0 (B, H, Dh) is contiguous f64. Dh is one of 8,
// 16, 32, 64. Returns the first failed launch's cudaGetLastError()
// (cudaErrorInvalidValue for another Dh).
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const float* lw, const float* u,
                               const float* s0, const void* dout,
                               const float* dsT, void* dr, void* dk, void* dv,
                               float* dlw, float* du, float* ds0,
                               float* du_part, void* kdk, void* c0,
                               const long long* st, int B, int H, int T,
                               int Dh, void* stream) {
  Strides s[9];
  recurrence::unpack(st, s);
  const Args a{r, k, v, lw, u, s0, dout, dsT, dr, dk, dv, dlw, du, ds0,
               du_part, kdk, c0};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 8: return launch<8>(a, s, B, H, T, cs);
    case 16: return launch<16>(a, s, B, H, T, cs);
    case 32: return launch<32>(a, s, B, H, T, cs);
    case 64: return launch<64>(a, s, B, H, T, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16 (the chunked form). r, k, v, do, dr, dk, dv (bf16) and lw, dlw
// (f32) as above, with 16-byte aligned rows; u, s0, dS_T (may be null),
// dS0 and du as above. Scratch, contiguous f32, nc = ceil(T / 64): dS and
// dG (B, H, nc, 64, 64), cwl and first (B, H, nc, 64), du_part
// (B, nc, H, Dh). Dh is one of 8, 16, 32, 64. Returns the first failed
// launch's cudaGetLastError() (cudaErrorInvalidValue for another Dh).
extern "C" int wkv6_bwd_chunked_launch(
    const void* r, const void* k, const void* v, const float* lw,
    const float* u, const float* s0, const void* dout, const float* dsT,
    void* dr, void* dk, void* dv, float* dlw, float* du, float* ds0,
    float* dS, float* dG, float* cwl, float* first, float* du_part,
    const long long* st, int B, int H, int T, int Dh, void* stream) {
  if (Dh != 8 && Dh != 16 && Dh != 32 && Dh != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s[9];
  recurrence::unpack(st, s);
  ChunkArgs a{static_cast<const bf16*>(r), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
              lw, u, s0, dsT,
              static_cast<bf16*>(dr), static_cast<bf16*>(dk),
              static_cast<bf16*>(dv), dlw, du, ds0,
              dS, dG, cwl, first, du_part,
              s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
              B, H, T, Dh, (T + L - 1) / L};
  return launch_chunked(a, static_cast<cudaStream_t>(stream));
}
