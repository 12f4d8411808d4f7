// RWKV6 (WKV6) recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_wkv6_kernel` (src/repro/kernels/wkv6.py,
// `wkv6`). Per (b, h), with an f32 state S of Dh x Dh:
//     out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t   = diag(exp(lw_t)) S_{t-1} + k_t v_t^T          lw_t <= 0
// and returns (out in r's dtype, final S in f32).
//
// What bounds it on an H100: at rwkv6-3b's shape (B=64, H=40, T=512,
// Dh=64, bf16 r/k/v/out, f32 lw) the function moves ~1.09 GB (r, k, v and
// out 671 MB, lw 336 MB, states 84 MB), 0.33 ms at the data sheet's 3.35
// TB/s; the chunked form's products take less on the bf16 tensor cores:
// the function is bound by bytes.
//
// Two kernels, chosen by the input type:
// * bf16 (the main path): the TPU kernel's chunked form, on the tensor
//   cores (mma.sync m16n8k16, f32 accumulation). One block of four warps
//   per (b, h) walks T in chunks of L = 64 steps (its own chunk, whatever
//   the model's chunk_size) with the f32 state in registers. Per chunk, in
//   log2 units, cw = cumsum(lw) (inclusive) and cwp = cw - lw:
//       A[t,s] = sum_d r[t,d] k[s,d] 2^(cwp[t,d] - cw[s,d])     s < t
//       A[t,t] = sum_d r[t,d] k[t,d] u[d]
//       out    = A v + (r * 2^cwp) S
//       S'     = 2^cw_last * S + (k * 2^(cw_last - cw))^T v
//   The decay is per channel, so A is a product of two (., Dh) matrices
//   only once the decay is split around a reference step, and a factor
//   2^(ref - cw) with ref > cw overflows (lw reaches -8 a step: 2^738 over
//   a chunk). Warp w owns the chunk's steps T0 = 16w .. T0 + 15 (rows of
//   A and out) and the state rows d = 16w .. 16w + 15. Its s-tiles before
//   T0 use the reference cwp[T0]: r * 2^(cwp[t] - cwp[T0]) and
//   k * 2^(cwp[T0] - cw[s]), both exponents <= 0. In its diagonal 16 x 16
//   tile the quadrant t >= T0 + 8 > s uses the reference cwp[T0 + 8] the
//   same way, and the two 8 x 8 diagonal quadrants (28 pairs each) take
//   the exact pairwise exponent on the CUDA cores, one pair a lane; the
//   bonus diag(r k u) goes in there too. Every factor is <= 1, at any lw.
//   r, k, v and lw of the next chunk arrive by cp.async (16-byte pieces of
//   a row) into the other stage of a two-stage ring while this chunk
//   computes; rows past T are zero-filled (lw = 0 there, so cw_last is the
//   last real step's). Dh below 64 is zero-padded in shared memory.
//   Precision: the decayed r and k, A, the state and the decayed k of the
//   update are f32 values, and one bf16 rounding of any of them puts
//   outputs near zero at 2-60x the 1e-2 tolerance against the plain
//   version (tests/test_torch_wkv6_chunks.py emulates this arithmetic), so
//   each enters as hi + lo bf16 halves: a product of two such operands is
//   three mma (hi hi, hi lo, lo hi), of one and v two.
// * f32: the sequential recurrence on the CUDA cores, f32 throughout (no
//   TF32). One block per (b, h); 4*Dh threads; thread (e, q) owns state
//   column e and the rows d = q + 4i (i < Dh/4) in registers. Per tile of
//   TC steps the block stages r, k, v and exp(lw) in shared memory and
//   every thread steps through the tile; the four threads of a column
//   (adjacent lanes) add their partial sums with two shuffles. No main path
//   runs it.
//
// Layout: r, k, v, lw and out are (B, H, T, Dh) views with any strides whose
// last dimension is contiguous; u (H, Dh), s0 and s_out (B, H, Dh, Dh) are
// contiguous. The bf16 kernel needs 16-byte aligned rows of r, k, v, lw and
// out; the wrapper checks them.

#include "recurrence.cuh"
#include "tensor_core.cuh"
#include "launch_plan.cuh"

#include <cstdint>

namespace {

constexpr int TC = 32;  // steps staged in shared memory per tile (f32)

using recurrence::Strides;
using recurrence::from_f32;
using recurrence::to_f32;
using tc::cp_async;
using tc::cp_async_commit;
using tc::cp_async_wait_all;
using tc::ex2;
using tc::ldsm_x4_t;
using tc::mma_bf16;
using tc::smem_u32;
using tc::split2;

template <typename T, int DH>
__global__ void __launch_bounds__(4 * DH)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ lw,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ out, float* __restrict__ s_out, Strides sr,
            Strides sk, Strides sv, Strides sw, Strides so, int H, int Tn) {
  constexpr int RPT = DH / 4;  // state rows per thread
  constexpr int NT = 4 * DH;   // threads
  __shared__ float rs[TC][DH], ks[TC][DH], vs[TC][DH], ws[TC][DH],
      os[TC][DH];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int t = threadIdx.x;
  const int e = t / 4, q = t % 4;

  float S[RPT], uu[RPT];
  const float* s0p = s0 + (long long)bh * DH * DH;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    S[i] = s0p[(q + 4 * i) * DH + e];
    uu[i] = u[h * DH + q + 4 * i];
  }
  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* wb = lw + b * sw.b + h * sw.h;
  T* ob = out + b * so.b + h * so.h;

  for (int t0 = 0; t0 < Tn; t0 += TC) {
    const int nt = min(TC, Tn - t0);
    __syncthreads();  // the previous tile's reads and writes of os are done
    for (int idx = t; idx < nt * DH; idx += NT) {
      const int tt = idx / DH, d = idx % DH;
      const long long st = t0 + tt;
      rs[tt][d] = to_f32(rb[st * sr.t + d]);
      ks[tt][d] = to_f32(kb[st * sk.t + d]);
      vs[tt][d] = to_f32(vb[st * sv.t + d]);
      ws[tt][d] = expf(wb[st * sw.t + d]);
    }
    __syncthreads();

#pragma unroll 1
    for (int tt = 0; tt < nt; ++tt) {
      const float ve = vs[tt][e];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int d = q + 4 * i;
        const float kv = ks[tt][d] * ve;
        acc = fmaf(rs[tt][d], fmaf(uu[i], kv, S[i]), acc);
        S[i] = fmaf(ws[tt][d], S[i], kv);
      }
      acc = recurrence::quad_sum(acc);
      if (q == 0) os[tt][e] = acc;
    }
    __syncthreads();
    for (int idx = t; idx < nt * DH; idx += NT) {
      const int tt = idx / DH, d = idx % DH;
      ob[(t0 + tt) * so.t + d] = from_f32<T>(os[tt][d]);
    }
  }

  float* sp = s_out + (long long)bh * DH * DH;
#pragma unroll
  for (int i = 0; i < RPT; ++i) sp[(q + 4 * i) * DH + e] = S[i];
}

// --- bf16: the chunked form on the tensor cores ---------------------------

constexpr int L = 64;        // steps per chunk
constexpr int DP = 64;       // head dim padded: four warps x 16 state rows
constexpr int XP = DP + 8;   // bf16 row pitch (an odd multiple of 16 B)
constexpr int WP = DP + 4;   // f32 row pitch of lw / cw
constexpr int AP = 16 + 1;   // row pitch of a warp's exact diagonal tile
constexpr int XS = L * XP, WS = L * WP;
constexpr int MMA_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;
// shared memory: two stages of r, k, v [L][XP] and lw [L][WP]; S hi and lo
// [DP][XP]; four warps' diagonal tiles [16][AP]; u [DP]
constexpr size_t MMA_SMEM = sizeof(__nv_bfloat16) * (6 * XS + 2 * DP * XP) +
                            sizeof(float) * (2 * WS + 4 * 16 * AP + DP);

__device__ __forceinline__ float2 bf2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// (Fragment layouts: tensor_core.cuh.) 113 KB of shared memory: two
// blocks, eight warps, on each SM.
__global__ void __launch_bounds__(MMA_THREADS, 2)
wkv6_mma_kernel(const __nv_bfloat16* __restrict__ r,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const float* __restrict__ lw, const float* __restrict__ u,
                const float* __restrict__ s0, __nv_bfloat16* __restrict__ out,
                float* __restrict__ s_out, Strides sr, Strides sk, Strides sv,
                Strides sw, Strides so, int H, int Tn, int Dh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Rs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2]
  __nv_bfloat16* Ks = Rs + 2 * XS;                                  // [2]
  __nv_bfloat16* Vs = Ks + 2 * XS;                                  // [2]
  __nv_bfloat16* Sh = Vs + 2 * XS;
  __nv_bfloat16* Sl = Sh + DP * XP;
  float* Ws = reinterpret_cast<float*>(Sl + DP * XP);               // [2]
  float* Ad = Ws + 2 * WS;                                          // [4]
  float* Us = Ad + 4 * 16 * AP;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int T0 = 16 * warp;                 // this warp's steps and rows
  float* ad = Ad + warp * 16 * AP;

  const __nv_bfloat16* rb = r + b * sr.b + h * sr.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  const float* wb = lw + b * sw.b + h * sw.h;
  __nv_bfloat16* ob = out + b * so.b + h * so.h;

  // the padding columns Dh..DP-1 stay zero: the copies write only the real
  // ones, and the chunk's arithmetic writes zeros there
  if (Dh < DP) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int e = t; e < 6 * XS / 8; e += MMA_THREADS)
      reinterpret_cast<uint4*>(Rs)[e] = z;
    for (int e = t; e < 2 * WS / 4; e += MMA_THREADS)
      reinterpret_cast<uint4*>(Ws)[e] = z;
    __syncthreads();
  }
  if (t < DP) Us[t] = t < Dh ? u[h * Dh + t] : 0.f;

  const int nc = (Tn + L - 1) / L;
  auto load = [&](int c) {
    const int st = c & 1;
    const int pc = Dh / 8, wc = Dh / 4;  // 16-byte pieces of a row
    for (int e = t; e < L * pc; e += MMA_THREADS) {
      const int row = e / pc, kk = e % pc;
      const int tt = c * L + row;
      const bool ok = tt < Tn;
      const long long src = ok ? tt : 0;
      const int off = st * XS + row * XP + 8 * kk;
      cp_async<16>(smem_u32(Rs + off), rb + src * sr.t + 8 * kk, ok ? 16 : 0);
      cp_async<16>(smem_u32(Ks + off), kb + src * sk.t + 8 * kk, ok ? 16 : 0);
      cp_async<16>(smem_u32(Vs + off), vb + src * sv.t + 8 * kk, ok ? 16 : 0);
    }
    for (int e = t; e < L * wc; e += MMA_THREADS) {
      const int row = e / wc, kk = e % wc;
      const int tt = c * L + row;
      const bool ok = tt < Tn;
      cp_async<16>(smem_u32(Ws + st * WS + row * WP + 4 * kk),
                   wb + (long long)(ok ? tt : 0) * sw.t + 4 * kk, ok ? 16 : 0);
    }
  };
  load(0);
  cp_async_commit();

  // S: this warp's rows d = T0 + g (+8), columns e = 8j + 2tq (+1), as C
  // fragments of a 16 x DP product; hi + lo halves in shared memory
  float sacc[DP / 8][4];
  const float* s0p = s0 + (long long)bh * Dh * Dh;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = T0 + g + 8 * (e >> 1), c = 8 * j + 2 * tq + (e & 1);
      sacc[j][e] = d < Dh && c < Dh ? s0p[d * Dh + c] : 0.f;
    }
  }
  auto store_state = [&]() {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int off = (T0 + g) * XP + 8 * j + 2 * tq;
      uint32_t hi, lo;
      split2(sacc[j][0], sacc[j][1], hi, lo);
      *reinterpret_cast<uint32_t*>(Sh + off) = hi;
      *reinterpret_cast<uint32_t*>(Sl + off) = lo;
      split2(sacc[j][2], sacc[j][3], hi, lo);
      *reinterpret_cast<uint32_t*>(Sh + off + 8 * XP) = hi;
      *reinterpret_cast<uint32_t*>(Sl + off + 8 * XP) = lo;
    }
  };
  store_state();

  // this lane's pair of the 8 x 8 diagonal quadrants (lanes 0..27): ti > si
  int ti = 1, si = lane;
  while (si >= ti) si -= ti++;

#pragma unroll 1
  for (int c = 0; c < nc; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c has landed; S of chunk c - 1 is stored
    if (c + 1 < nc) load(c + 1);
    cp_async_commit();
    const int st = c & 1;
    __nv_bfloat16* rsm = Rs + st * XS;
    const __nv_bfloat16* ksm = Ks + st * XS;
    const __nv_bfloat16* vsm = Vs + st * XS;
    float* wsm = Ws + st * WS;

    // cw = cumsum(lw log2 e) over the chunk, in place: thread (d, half)
    // scans 32 steps; the second half then adds the first half's total
    {
      const int d = t % DP, half = t / DP;
      float* p = wsm + 32 * half * WP + d;
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
        const float base = wsm[31 * WP + d];
#pragma unroll
        for (int i = 0; i < 32; ++i) p[i * WP] = x[i] + base;
      }
      __syncthreads();
    }
    // cwp[t] = cw[t - 1], 0 at t = 0
    auto cwp2 = [&](int tt, int d) {
      return tt > 0 ? f2(wsm + (tt - 1) * WP + d) : make_float2(0.f, 0.f);
    };

    // A fragments of this warp's rows t = T0 + g (+8), d = 16ks + 2tq (+8):
    // q = r 2^(cwp[t] - cwp[T0]) and rdec = r 2^cwp[t] = q 2^cwp[T0]
    uint32_t qh[4][4], ql[4][4], rh[4][4], rl[4][4];
    float2 ref[4][2];  // cwp[T0] at this lane's d
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tt = T0 + g + 8 * (i & 1), d = 16 * ks + 2 * tq + 8 * (i >> 1);
        if ((i & 1) == 0) ref[ks][i >> 1] = cwp2(T0, d);
        const float2 c0 = ref[ks][i >> 1];
        const float2 rr = bf2(rsm + tt * XP + d), cp = cwp2(tt, d);
        const float q0 = rr.x * ex2(cp.x - c0.x), q1 = rr.y * ex2(cp.y - c0.y);
        split2(q0, q1, qh[ks][i], ql[ks][i]);
        split2(q0 * ex2(c0.x), q1 * ex2(c0.y), rh[ks][i], rl[ks][i]);
      }
    }

    // A over the s-tiles before this warp's rows: k 2^(cwp[T0] - cw[s]) as
    // B fragments (s = 16J + 8nt + g, d = 16ks + 2tq (+8)), three products
    float aacc[6][4];
#pragma unroll
    for (int j = 0; j < 6; ++j) aacc[j][0] = aacc[j][1] = aacc[j][2] = aacc[j][3] = 0.f;
#pragma unroll
    for (int J = 0; J < 3; ++J) {
      if (J >= warp) break;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t bh_[2][2], bl_[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int kh = 0; kh < 2; ++kh) {
            const int s = 16 * J + 8 * nt + g, d = 16 * ks + 2 * tq + 8 * kh;
            const float2 kk = bf2(ksm + s * XP + d), cs = f2(wsm + s * WP + d);
            const float2 c0 = ref[ks][kh];
            split2(kk.x * ex2(c0.x - cs.x), kk.y * ex2(c0.y - cs.y), bh_[nt][kh],
                   bl_[nt][kh]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_bf16(aacc[2 * J + nt], qh[ks], bh_[nt][0], bh_[nt][1]);
          mma_bf16(aacc[2 * J + nt], qh[ks], bl_[nt][0], bl_[nt][1]);
          mma_bf16(aacc[2 * J + nt], ql[ks], bh_[nt][0], bh_[nt][1]);
        }
      }
    }

    // the diagonal tile's quadrant t >= T0 + 8 > s, at the reference
    // cwp[T0 + 8]: rows g + 8 of the A fragments, rows g zero
    float dll[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
      uint32_t b8h[2], b8l[2];
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const int d = 16 * ks + 2 * tq + 8 * kh;
        const float2 c8 = f2(wsm + (T0 + 7) * WP + d);
        const int tt = T0 + 8 + g, s = T0 + g;
        const float2 rr = bf2(rsm + tt * XP + d), cp = f2(wsm + (tt - 1) * WP + d);
        split2(rr.x * ex2(cp.x - c8.x), rr.y * ex2(cp.y - c8.y), ah[1 + 2 * kh],
               al[1 + 2 * kh]);
        const float2 kk = bf2(ksm + s * XP + d), cs = f2(wsm + s * WP + d);
        split2(kk.x * ex2(c8.x - cs.x), kk.y * ex2(c8.y - cs.y), b8h[kh], b8l[kh]);
      }
      mma_bf16(dll, ah, b8h[0], b8h[1]);
      mma_bf16(dll, ah, b8l[0], b8l[1]);
      mma_bf16(dll, al, b8h[0], b8h[1]);
    }
    // ... and its two 8 x 8 diagonal quadrants, one pair (T0 + o + ti,
    // T0 + o + si) a lane, with the exact exponent; the bonus on the
    // diagonal
    if (lane < 28) {
#pragma unroll
      for (int o = 0; o < 16; o += 8) {
        const int tt = T0 + o + ti, s = T0 + o + si;
        const __nv_bfloat16* rp = rsm + tt * XP;
        const __nv_bfloat16* kp = ksm + s * XP;
        const float* cp = wsm + (tt - 1) * WP;
        const float* cs = wsm + s * WP;
        float acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < DP; d += 2) {
          const float2 rr = bf2(rp + d), kk = bf2(kp + d);
          const float2 a = f2(cp + d), e = f2(cs + d);
          acc = fmaf(rr.x * kk.x, ex2(a.x - e.x), acc);
          acc = fmaf(rr.y * kk.y, ex2(a.y - e.y), acc);
        }
        ad[(o + ti) * AP + o + si] = acc;
      }
    }
    if (lane < 16) {
      const __nv_bfloat16* rp = rsm + (T0 + lane) * XP;
      const __nv_bfloat16* kp = ksm + (T0 + lane) * XP;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < DP; d += 2) {
        const float2 rr = bf2(rp + d), kk = bf2(kp + d), uu = f2(Us + d);
        acc = fmaf(rr.x * kk.x, uu.x, acc);
        acc = fmaf(rr.y * kk.y, uu.y, acc);
      }
      ad[lane * AP + lane] = acc;
    }
    __syncwarp();
    float dacc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = g + 8 * (e >> 1), j = 8 * nt + 2 * tq + (e & 1);
        dacc[nt][e] = j > i ? 0.f : (i >= 8 && j < 8 ? dll[e] : ad[i * AP + j]);
      }
    }

    // out = A v over the s-tiles up to this warp's rows, and the state
    // update S' = 2^cw_last S + kdec^T v over all of them: v's B fragments
    // (rows s, by ldmatrix.trans) serve both
    float yacc[DP / 8][4];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) yacc[j][0] = yacc[j][1] = yacc[j][2] = yacc[j][3] = 0.f;
    {
      const float2 cl = make_float2(wsm[(L - 1) * WP + T0 + g],
                                    wsm[(L - 1) * WP + T0 + g + 8]);
      const float e0 = ex2(cl.x), e1 = ex2(cl.y);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        sacc[j][0] *= e0;
        sacc[j][1] *= e0;
        sacc[j][2] *= e1;
        sacc[j][3] *= e1;
      }
#pragma unroll
      for (int J = 0; J < L / 16; ++J) {
        uint32_t bx[DP / 16][4];
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp)
          ldsm_x4_t(bx[dp], smem_u32(vsm + (16 * J + lane % 8 + 8 * ((lane / 8) % 2)) * XP +
                                     16 * dp + 8 * (lane / 16)));
        if (J <= warp) {
          const bool diag = J == warp;
          float c0[4], c1[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            c0[e] = diag ? dacc[0][e] : aacc[(2 * J) % 6][e];
            c1[e] = diag ? dacc[1][e] : aacc[(2 * J + 1) % 6][e];
          }
          uint32_t ah[4], al[4];
          split2(c0[0], c0[1], ah[0], al[0]);
          split2(c0[2], c0[3], ah[1], al[1]);
          split2(c1[0], c1[1], ah[2], al[2]);
          split2(c1[2], c1[3], ah[3], al[3]);
#pragma unroll
          for (int dp = 0; dp < DP / 16; ++dp) {
            mma_bf16(yacc[2 * dp], ah, bx[dp][0], bx[dp][1]);
            mma_bf16(yacc[2 * dp + 1], ah, bx[dp][2], bx[dp][3]);
          }
#pragma unroll
          for (int dp = 0; dp < DP / 16; ++dp) {
            mma_bf16(yacc[2 * dp], al, bx[dp][0], bx[dp][1]);
            mma_bf16(yacc[2 * dp + 1], al, bx[dp][2], bx[dp][3]);
          }
        }
        // kdec^T: rows d = T0 + g (+8), columns s = 16J + 2tq (+1) (+8):
        // k^T by ldmatrix.trans, scaled by 2^(cw_last[d] - cw[s, d])
        uint32_t kr[4], kh[4], kl[4];
        ldsm_x4_t(kr, smem_u32(ksm + (16 * J + lane % 8 + 8 * (lane / 16)) * XP + T0 +
                               8 * ((lane / 8) % 2)));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = T0 + g + 8 * (i & 1), s = 16 * J + 2 * tq + 8 * (i >> 1);
          const float c = (i & 1) ? cl.y : cl.x;
          const float2 kv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&kr[i]));
          split2(kv.x * ex2(c - wsm[s * WP + d]), kv.y * ex2(c - wsm[(s + 1) * WP + d]), kh[i],
                 kl[i]);
        }
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          mma_bf16(sacc[2 * dp], kh, bx[dp][0], bx[dp][1]);
          mma_bf16(sacc[2 * dp + 1], kh, bx[dp][2], bx[dp][3]);
        }
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          mma_bf16(sacc[2 * dp], kl, bx[dp][0], bx[dp][1]);
          mma_bf16(sacc[2 * dp + 1], kl, bx[dp][2], bx[dp][3]);
        }
      }
    }

    // out += rdec S, the chunk's old state as hi + lo B fragments (rows d,
    // by ldmatrix.trans): three products
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t sh[DP / 16][4], sl[DP / 16][4];
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        const int off = (16 * ks + lane % 8 + 8 * ((lane / 8) % 2)) * XP + 16 * dp +
                        8 * (lane / 16);
        ldsm_x4_t(sh[dp], smem_u32(Sh + off));
        ldsm_x4_t(sl[dp], smem_u32(Sl + off));
      }
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        mma_bf16(yacc[2 * dp], rh[ks], sh[dp][0], sh[dp][1]);
        mma_bf16(yacc[2 * dp + 1], rh[ks], sh[dp][2], sh[dp][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        mma_bf16(yacc[2 * dp], rh[ks], sl[dp][0], sl[dp][1]);
        mma_bf16(yacc[2 * dp + 1], rh[ks], sl[dp][2], sl[dp][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        mma_bf16(yacc[2 * dp], rl[ks], sh[dp][0], sh[dp][1]);
        mma_bf16(yacc[2 * dp + 1], rl[ks], sh[dp][2], sh[dp][3]);
      }
    }

    // out through this warp's 16 rows of the chunk's r (which only this
    // warp reads), then 16-byte stores
    __syncwarp();
    __nv_bfloat16* ys = rsm + T0 * XP;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(ys + g * XP + 8 * j + 2 * tq) =
          __floats2bfloat162_rn(yacc[j][0], yacc[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(ys + (g + 8) * XP + 8 * j + 2 * tq) =
          __floats2bfloat162_rn(yacc[j][2], yacc[j][3]);
    }
    __syncwarp();
    {
      const int pc = Dh / 8;
      for (int e = lane; e < 16 * pc; e += 32) {
        const int row = e / pc, kk = e % pc;
        const int tt = c * L + T0 + row;
        if (tt < Tn)
          *reinterpret_cast<uint4*>(ob + (long long)tt * so.t + 8 * kk) =
              *reinterpret_cast<const uint4*>(ys + row * XP + 8 * kk);
      }
    }
    __syncthreads();  // every warp has read S of this chunk
    store_state();
  }

  float* sp = s_out + (long long)bh * Dh * Dh;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = T0 + g + 8 * (e >> 1), c = 8 * j + 2 * tq + (e & 1);
      if (d < Dh && c < Dh) sp[d * Dh + c] = sacc[j][e];
    }
  }
}

int launch_bf16(const void* r, const void* k, const void* v, const float* lw,
                const float* u, const float* s0, void* out, float* s_out,
                const Strides* st, int B, int H, int Tn, int Dh,
                cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(MMA_SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaError_t err2 = cudaFuncSetAttribute(
        wkv6_mma_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err2 != cudaSuccess) return static_cast<int>(err2);
    configured = true;
  }
  COVER(0, (long long)B * H, 1);
  LAUNCH((wkv6_mma_kernel), B * H, MMA_THREADS, MMA_SMEM, stream,
      static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lw, u, s0,
      static_cast<__nv_bfloat16*>(out), s_out, st[0], st[1], st[2], st[3],
      st[4], H, Tn, Dh);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch(const void* r, const void* k, const void* v, const float* lw,
           const float* u, const float* s0, void* out, float* s_out,
           const Strides* st, int B, int H, int Tn, cudaStream_t stream) {
  COVER(0, (long long)B * H, 1);
  LAUNCH((wkv6_kernel<float, DH>), B * H, 4 * DH, 0, stream,
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), lw, u, s0, static_cast<float*>(out), s_out,
      st[0], st[1], st[2], st[3], st[4], H, Tn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, lw, out: (B, H, T, Dh); element (b, h, t, d) of each lies at
// base + b*st[0] + h*st[1] + t*st[2] + d, the strides (in elements) given
// for r, k, v, lw, out in that order in st[15]. u (H, Dh), s0 and s_out
// (B, H, Dh, Dh) are contiguous f32; lw is f32. dtype 0 is f32, 1 is bf16
// (r, k, v and out). Dh is one of 8, 16, 32, 64. Returns cudaGetLastError()
// (cudaErrorInvalidValue for another Dh or dtype).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const float* lw, const float* u, const float* s0,
                           void* out, float* s_out, const long long* st,
                           int dtype, int B, int H, int T, int Dh,
                           void* stream) {
  if (Dh != 8 && Dh != 16 && Dh != 32 && Dh != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s[5];
  recurrence::unpack(st, s);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bf16(r, k, v, lw, u, s0, out, s_out, s, B, H, T, Dh, cs);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (Dh) {
    case 8: return launch<8>(r, k, v, lw, u, s0, out, s_out, s, B, H, T, cs);
    case 16: return launch<16>(r, k, v, lw, u, s0, out, s_out, s, B, H, T, cs);
    case 32: return launch<32>(r, k, v, lw, u, s0, out, s_out, s, B, H, T, cs);
    default: return launch<64>(r, k, v, lw, u, s0, out, s_out, s, B, H, T, cs);
  }
}
