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
// Every decay factor in both recurrences is <= 1, at any lw: no chunked
// form and no ratio of decays, so nothing can overflow (a chunked form's
// hazard, csrc/wkv6.cu's header).
//
// dlw pairs S_{t-1} with G_t, which run in opposite directions. Per row d
// of the state, <G_{t-1}, S_{t-1}> = r_t dr~_t + dlw_t and <G_t, S_t> =
// dlw_t + k_t dk~_t (dr~, dk~: dr and dk without their u terms), so
//     dlw_j = <s0, dS0>_d + sum_{s<j} k_s dk~_s - sum_{t<=j} r_t dr~_t,
// a prefix sum that each sweep's own quantities give (ref.wkv6_dlw_prefix).
//
// The prefix sum cancels: where the decay is strong (lw near -8) dlw_t is
// ~w_t times the size of the terms it is the difference of, and the f32
// rounding of S and G, which the identity assumes exact, puts dlw ~2e-3 of
// its max off the direct formula at lw = -8 everywhere (a CPU emulation).
// So the sweeps accumulate in f64 for f32 inputs (`Acc<float>`), which
// only the checks run, and in f32 for bf16 ones, whose 1e-2 tolerance
// holds it; the scratch that carries k * dk~ and <s0, dS0> from launch 1
// to launch 2 is in the same type.
//
// Three launches, in order on the caller's stream, no atomics: two calls
// give the same bits.
// 1. reverse sweep, one block of 8 * Dh threads per (b, h): G in
//    registers twice, once row-owned (thread (d, q) holds G[d, q + 4i],
//    so dk~[d] = sum_e G[d, e] v[e] is a sum over the four lanes of a
//    quad) and once column-owned (thread (e, q) holds G[q + 4i, e], so
//    dv[e] is a quad sum too). G's recurrence is elementwise, so keeping
//    it twice costs one FMA an element a step and spares a cross-warp
//    reduction every step. Writes dk, dv, dS0, each (b, h)'s share of du,
//    and to the scratch k_t * dk~_t and each row's <s0, dS0>.
// 2. forward sweep, 4 * Dh threads per (b, h), S row-owned: dr, and dlw
//    from the running <G, S> started at <s0, dS0>.
// 3. du: the per-(b, h) shares summed over b in order.
// Per tile of TC steps a block stages r, k, v, do and exp(lw) in shared
// memory (f32), each warp reduces v . do and r . (u * k) of some steps,
// then every thread steps through the tile; outputs leave through shared
// memory, a tile at a time.
//
// What bounds it on an H100: at rwkv6-3b's training shape (B=8, H=40,
// T=1024, Dh=64; bf16 r/k/v/do/dr/dk/dv, f32 lw and dlw) the function
// moves ~0.46 GB, 0.14 ms at the data sheet's 3.35 TB/s. This design runs
// on the CUDA cores, 320 blocks each sequential over T: bound by the issue
// rate of its per-step FMAs and shared-memory loads, not by bytes.
//
// Layout: r, k, v, lw, do, dr, dk, dv and dlw are (B, H, T, Dh) views with
// any strides whose last dimension is contiguous; u (H, Dh), s0, dS_T and
// dS0 (B, H, Dh, Dh), du (H, Dh) and the du scratch (B, H, Dh) are
// contiguous f32; the scratch (B, H, T, Dh) and (B, H, Dh) is contiguous.

#include "recurrence.cuh"

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

// du[h, d] = sum_b du_part[b, h, d], b in order.
__global__ void wkv6_bwd_du(const float* __restrict__ du_part,
                            float* __restrict__ du, int B, int HD) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HD) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += du_part[(long long)b * HD + i];
  du[i] = s;
}

struct Args {
  const void *r, *k, *v;
  const float *lw, *u, *s0;
  const void* dout;
  const float* dsT;
  void *dr, *dk, *dv;
  float *dlw, *du, *ds0, *du_part;
  void *kdk, *c0;  // scratch in the accumulation type
};

template <typename T, int DH>
int launch(const Args& a, const Strides (&s)[9], int B, int H, int Tn,
           cudaStream_t stream) {
  // s: r, k, v, lw, do, dr, dk, dv, dlw
  using A = typename Acc<T>::type;
  const T *r = static_cast<const T*>(a.r), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v),
          *dout = static_cast<const T*>(a.dout);
  wkv6_bwd_reverse<T, DH><<<B * H, 8 * DH, 0, stream>>>(
      r, k, v, a.lw, a.u, a.s0, dout, a.dsT, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), static_cast<A*>(a.kdk), static_cast<A*>(a.c0),
      a.ds0, a.du_part, s[0], s[1], s[2], s[3], s[4], s[6], s[7], H, Tn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_forward<T, DH><<<B * H, 4 * DH, 0, stream>>>(
      r, k, v, a.lw, a.u, a.s0, dout, static_cast<const A*>(a.kdk),
      static_cast<const A*>(a.c0), static_cast<T*>(a.dr), a.dlw, s[0], s[1],
      s[2], s[3], s[4], s[5], s[8], H, Tn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int HD = H * DH;
  wkv6_bwd_du<<<(HD + 255) / 256, 256, 0, stream>>>(a.du_part, a.du, B, HD);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(int Dh, const Args& a, const Strides (&s)[9], int B, int H,
              int Tn, cudaStream_t stream) {
  switch (Dh) {
    case 8: return launch<T, 8>(a, s, B, H, Tn, stream);
    case 16: return launch<T, 16>(a, s, B, H, Tn, stream);
    case 32: return launch<T, 32>(a, s, B, H, Tn, stream);
    case 64: return launch<T, 64>(a, s, B, H, Tn, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v, lw, do, dr, dk, dv, dlw: (B, H, T, Dh); element (b, h, t, d) of
// each lies at base + b*st[0] + h*st[1] + t*st[2] + d, the strides (in
// elements) given in that order in st[27]. u (H, Dh), s0, dS_T (may be
// null: zero) and dS0 (B, H, Dh, Dh), du (H, Dh) and du_part (B, H, Dh)
// are contiguous f32; lw and dlw are f32. The scratch kdk (B, H, T, Dh)
// and c0 (B, H, Dh) is contiguous, f64 for dtype 0 and f32 for dtype 1.
// dtype 0 is f32, 1 is bf16 (r, k, v, do, dr, dk, dv). Dh is one of 8,
// 16, 32, 64. Returns the first failed launch's cudaGetLastError()
// (cudaErrorInvalidValue for another Dh or dtype).
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const float* lw, const float* u,
                               const float* s0, const void* dout,
                               const float* dsT, void* dr, void* dk, void* dv,
                               float* dlw, float* du, float* ds0,
                               float* du_part, void* kdk, void* c0,
                               const long long* st, int dtype, int B, int H,
                               int T, int Dh, void* stream) {
  Strides s[9];
  recurrence::unpack(st, s);
  const Args a{r, k, v, lw, u, s0, dout, dsT, dr, dk, dv, dlw, du, ds0,
               du_part, kdk, c0};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dh<float>(Dh, a, s, B, H, T, cs);
  if (dtype == 1) return launch_dh<__nv_bfloat16>(Dh, a, s, B, H, T, cs);
  return static_cast<int>(cudaErrorInvalidValue);
}
