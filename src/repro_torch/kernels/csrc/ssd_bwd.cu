// Backward of the Mamba2 SSD recurrence for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of
// `ssd_chunked` (src/repro/models/mamba2.py:53). The forward is, per (b, h)
// with an f32 state S of N x P,
//     S_t = exp(a_t) S_{t-1} + B_t x_t^T,        a_t <= 0
//     y_t = C_t^T S_t
// with B and C (Bt, T, N) shared by all heads. Given the output gradient
// dy and the final-state gradient dS_T (null: zero), this computes
//     dx_t = G_t^T B_t,        dB_t = sum_h G_t x_t,
//     dC_t = sum_h S_t dy_t,   dS0 = exp(a_0) G_0,
//     da_t = exp(a_t) <G_t, S_{t-1}>
// where G_t, the gradient of S_t, runs backwards from the end:
//     G_{T-1} = dS_T + C_{T-1} dy_{T-1}^T,
//     G_t     = exp(a_{t+1}) G_{t+1} + C_t dy_t^T.
// Every decay factor is <= 1: nothing can overflow.
//
// da pairs S_{t-1} with G_t, which run in opposite directions. Since
// <G_t, S_t> = da_t + x_t . dx_t and <G_{t-1}, S_{t-1}> = C_{t-1} . dC_{t-1}^(h)
// + da_t (dC^(h): the head's own share of dC),
//     da_j = <s0, dS0> + sum_{s<j} x_s . dx_s - sum_{t<j} C_t . dC_t^(h),
// a prefix sum of each sweep's own quantities (ref.ssd_da_prefix).
//
// The prefix sum cancels where the decay is strong: at a = -8 every step
// the f32 rounding of S and G, which the identity assumes exact, puts da
// ~5e-3 of its max off the direct formula (a CPU emulation; zamba2-7b's a
// lies in [-0.1, 0) at its init, where it is ~1e-6). So the sweeps
// accumulate in f64 for f32 inputs (`Acc<float>`), which only the checks
// run, and in f32 for bf16 ones; the scratch that carries x . dx and
// <s0, dS0> from launch 1 to launch 2 is in the same type.
//
// Four launches, in order on the caller's stream, no atomics: two calls
// give the same bits.
// 1. reverse sweep, one block per (b, h) of 4P + max(32, 4N) threads: G in
//    registers twice, once column-owned (thread (p, q) holds G[q + 4i, p],
//    so dx[p] = sum_n G[n, p] B[n] is a sum over the four lanes of a quad)
//    and once row-owned (thread (n, q) holds G[n, q + 4i], so the head's
//    dB[n] = sum_p G[n, p] x[p] is a quad sum too). G's recurrence is
//    elementwise, so keeping it twice costs one FMA an element a step and
//    spares a cross-warp reduction every step. Writes dx, dS0, the head's
//    dB to an f32 scratch (Bt, H, T, N), and x_t . dx_t and <s0, dS0> to
//    the scratch of the accumulation type.
// 2. forward sweep, max(32, 4N) threads per (b, h), S row-owned: the head's
//    dC to a second f32 scratch, and da from the running <G, S> started at
//    <s0, dS0>.
// 3., 4. dB and dC: the heads' shares summed in order of h, one launch
//    each of one kernel.
// Per tile of TC steps a block stages x, dy, B, C and exp(a) in shared
// memory (f32, zero-padded to 64 columns), then every thread steps
// through the tile; per-step dot products over a whole state (x . dx,
// C . dC) are taken a tile at a time by warps, the prefix over a tile by
// one thread, in order.
//
// What bounds it on an H100: at zamba2-7b's training shape (Bt=4, H=112,
// T=1024, N=P=64; bf16 x/dy/dx/B/C/dB/dC, f32 a and da) the function
// moves ~0.12 GB, 0.04 ms at the data sheet's 3.35 TB/s. This design runs
// on the CUDA cores, 448 blocks each sequential over T, and moves the two
// f32 scratches besides (4 * Bt*H*T*N bytes each, written and read): bound
// by the issue rate of its per-step FMAs and shared-memory loads.
//
// Layout: x, dy, dx (Bt, H, T, P) and a (Bt, H, T) are views with any
// strides whose last dimension is contiguous (a: any strides), B, C
// (Bt, T, N) likewise; s0, dS_T and dS0 (Bt, H, N, P), da (Bt, H, T), the
// scratches and dB, dC (Bt, T, N) are contiguous.

#include "recurrence.cuh"

namespace {

constexpr int TC = 16;     // steps staged in shared memory per tile
constexpr int W = 64;      // staged width: P and N padded to 64
constexpr int MAX_P = 64;
constexpr int RP = MAX_P / 4;  // row-owned slots: columns q + 4i

using recurrence::Acc;
using recurrence::Strides;
using recurrence::from_f32;
using recurrence::mad;
using recurrence::quad_sum;
using recurrence::to_f32;
using recurrence::warp_sum;

// Zero a [TC][W] tile: the padding past P or N stays zero afterwards.
__device__ __forceinline__ void zero(float (&a)[TC][W], int nthreads) {
  for (int idx = threadIdx.x; idx < TC * W; idx += nthreads)
    a[idx / W][idx % W] = 0.f;
}

template <typename T>
__device__ __forceinline__ void stage_rows(float (&dst)[TC][W], const T* src,
                                           long long st_t, int t0, int nt,
                                           int n, int nthreads) {
  for (int idx = threadIdx.x; idx < nt * n; idx += nthreads) {
    const int tt = idx / n, c = idx % n;
    dst[tt][c] = to_f32(src[(t0 + tt) * st_t + c]);
  }
}

template <int N>
__host__ __device__ constexpr int row_threads() {  // whole warps of rows
  return 4 * N < 32 ? 32 : 4 * N;
}

template <typename T, int N>
__global__ void __launch_bounds__(4 * MAX_P + row_threads<N>())
ssd_bwd_reverse(const T* __restrict__ x, const float* __restrict__ a,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ s0, const T* __restrict__ dy,
                const float* __restrict__ dsT, T* __restrict__ dx,
                float* __restrict__ dBh,
                typename Acc<T>::type* __restrict__ xdx,
                typename Acc<T>::type* __restrict__ c0,
                float* __restrict__ ds0, Strides sx, Strides sa, Strides sb,
                Strides sc, Strides sdy, Strides sdx, int H, int Tn, int P) {
  using A = typename Acc<T>::type;
  constexpr int RN = N / 4;  // column-owned slots: rows q + 4i
  __shared__ float xs[TC][W], dys[TC][W], bs[TC][W], cs[TC][W], dbs[TC][W];
  __shared__ A dxs[TC][W];
  __shared__ float eas[TC];
  __shared__ A red[MAX_P / 8];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int t = threadIdx.x, nthreads = blockDim.x;
  const int PH = 4 * P;             // column-owned threads (whole warps)
  const bool by_row = t >= PH;      // the row-owned copy of G
  const int own = (by_row ? t - PH : t) / 4, q = t % 4;
  const int warp = t / 32, lane = t % 32;

  // column p = own < P: slots G[q + 4i, p]; row n = own: G[n, q + 4i]
  // (columns past P and rows past N hold 0 and stay 0)
  A Gc[RN], Gr[RP];
  const float* gT = dsT ? dsT + (long long)bh * N * P : nullptr;
#pragma unroll
  for (int i = 0; i < RN; ++i)
    Gc[i] = (!by_row && gT) ? gT[(q + 4 * i) * P + own] : 0.f;
#pragma unroll
  for (int i = 0; i < RP; ++i)
    Gr[i] = (by_row && gT && own < N && q + 4 * i < P)
                ? gT[own * P + q + 4 * i] : 0.f;
  A ea_next = 1;  // exp(a_{t+1}); 1 before the last step

  zero(xs, nthreads); zero(dys, nthreads); zero(bs, nthreads);
  zero(cs, nthreads);
  const T* xb = x + b * sx.b + h * sx.h;
  const float* ab = a + b * sa.b + h * sa.h;
  const T* bb = Bm + b * sb.b;
  const T* cb = Cm + b * sc.b;
  const T* db = dy + b * sdy.b + h * sdy.h;
  T* dxb = dx + b * sdx.b + h * sdx.h;
  float* dbb = dBh + (long long)bh * Tn * N;
  A* xdxb = xdx + (long long)bh * Tn;

  for (int tile = (Tn - 1) / TC; tile >= 0; --tile) {
    const int t0 = tile * TC, nt = min(TC, Tn - t0);
    __syncthreads();  // zeroed, or the previous tile's outputs have left
    stage_rows(xs, xb, sx.t, t0, nt, P, nthreads);
    stage_rows(dys, db, sdy.t, t0, nt, P, nthreads);
    stage_rows(bs, bb, sb.t, t0, nt, N, nthreads);
    stage_rows(cs, cb, sc.t, t0, nt, N, nthreads);
    if (t < nt) eas[t] = expf(ab[(t0 + t) * sa.t]);
    __syncthreads();

#pragma unroll 1
    for (int tt = nt - 1; tt >= 0; --tt) {
      if (!by_row) {  // column p = own: dx[p] = sum_n G[n, p] B[n]
        const A dyp = dys[tt][own];
        A acc = 0;
#pragma unroll
        for (int i = 0; i < RN; ++i) {
          Gc[i] = mad(ea_next, Gc[i], A(cs[tt][q + 4 * i]) * dyp);
          acc = mad(Gc[i], A(bs[tt][q + 4 * i]), acc);
        }
        acc = quad_sum(acc);
        if (q == 0) dxs[tt][own] = acc;
      } else {  // row n = own: the head's dB[n] = sum_p G[n, p] x[p]
        const A cn = cs[tt][own];
        A acc = 0;
#pragma unroll
        for (int i = 0; i < RP; ++i) {
          Gr[i] = mad(ea_next, Gr[i], cn * A(dys[tt][q + 4 * i]));
          acc = mad(Gr[i], A(xs[tt][q + 4 * i]), acc);
        }
        acc = quad_sum(acc);
        if (q == 0 && own < N) dbs[tt][own] = float(acc);
      }
      ea_next = eas[tt];
    }
    __syncthreads();
    for (int idx = t; idx < nt * P; idx += nthreads) {
      const int tt = idx / P, c = idx % P;
      dxb[(t0 + tt) * sdx.t + c] = from_f32<T>(float(dxs[tt][c]));
    }
    for (int idx = t; idx < nt * N; idx += nthreads) {
      const int tt = idx / N, n = idx % N;
      dbb[(long long)(t0 + tt) * N + n] = dbs[tt][n];
    }
    for (int tt = warp; tt < nt; tt += nthreads / 32) {
      A sum = 0;
      for (int c = lane; c < P; c += 32)
        sum = mad(A(xs[tt][c]), dxs[tt][c], sum);
      sum = warp_sum(sum);
      if (lane == 0) xdxb[t0 + tt] = sum;
    }
  }

  // dS0 = exp(a_0) G_0; <s0, dS0> over the head, warps in order
  A c = 0;
  if (!by_row) {
    const long long base = (long long)bh * N * P;
#pragma unroll
    for (int i = 0; i < RN; ++i) {
      const A g = ea_next * Gc[i];
      const long long idx = base + (q + 4 * i) * P + own;
      ds0[idx] = float(g);
      c = mad(A(s0[idx]), g, c);
    }
    c = warp_sum(c);
    if (lane == 0) red[warp] = c;
  }
  __syncthreads();
  if (t == 0) {
    A sum = 0;
    for (int w = 0; w < PH / 32; ++w) sum += red[w];
    c0[bh] = sum;
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(row_threads<N>())
ssd_bwd_forward(const T* __restrict__ x, const float* __restrict__ a,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ s0, const T* __restrict__ dy,
                const typename Acc<T>::type* __restrict__ xdx,
                const typename Acc<T>::type* __restrict__ c0,
                float* __restrict__ dCh, float* __restrict__ da, Strides sx,
                Strides sa, Strides sb, Strides sc, Strides sdy, int H,
                int Tn, int P) {
  using A = typename Acc<T>::type;
  constexpr int NTH = row_threads<N>();
  __shared__ float xs[TC][W], dys[TC][W], bs[TC][W], cs[TC][W];
  __shared__ A dcs[TC][W];
  __shared__ float eas[TC];
  __shared__ A xdxs[TC], cdc[TC];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int t = threadIdx.x;
  const int n = t / 4, q = t % 4;  // row n, columns q + 4i
  const int warp = t / 32, lane = t % 32;

  A S[RP];
  const float* s0p = s0 + (long long)bh * N * P + n * P;
#pragma unroll
  for (int i = 0; i < RP; ++i)
    S[i] = (n < N && q + 4 * i < P) ? s0p[q + 4 * i] : 0.f;
  A Pacc = c0[bh];  // <G_{t-1}, S_{t-1}> of the head; thread 0 keeps it
  zero(xs, NTH); zero(dys, NTH); zero(bs, NTH); zero(cs, NTH);

  const T* xb = x + b * sx.b + h * sx.h;
  const float* ab = a + b * sa.b + h * sa.h;
  const T* bb = Bm + b * sb.b;
  const T* cb = Cm + b * sc.b;
  const T* db = dy + b * sdy.b + h * sdy.h;
  const A* xdxb = xdx + (long long)bh * Tn;
  float* dcb = dCh + (long long)bh * Tn * N;
  float* dab = da + (long long)bh * Tn;

  for (int t0 = 0; t0 < Tn; t0 += TC) {
    const int nt = min(TC, Tn - t0);
    __syncthreads();  // zeroed, or the previous tile's outputs have left
    stage_rows(xs, xb, sx.t, t0, nt, P, NTH);
    stage_rows(dys, db, sdy.t, t0, nt, P, NTH);
    stage_rows(bs, bb, sb.t, t0, nt, N, NTH);
    stage_rows(cs, cb, sc.t, t0, nt, N, NTH);
    if (t < nt) {
      eas[t] = expf(ab[(t0 + t) * sa.t]);
      xdxs[t] = xdxb[t0 + t];  // launch 1's x . dx
    }
    __syncthreads();

#pragma unroll 1
    for (int tt = 0; tt < nt; ++tt) {
      const A ea = eas[tt], bn = bs[tt][n];
      A acc = 0;  // the head's dC[n] = sum_p S_t[n, p] dy[p]
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        S[i] = mad(ea, S[i], bn * A(xs[tt][q + 4 * i]));
        acc = mad(S[i], A(dys[tt][q + 4 * i]), acc);
      }
      acc = quad_sum(acc);
      if (q == 0 && n < N) dcs[tt][n] = acc;
    }
    __syncthreads();
    for (int tt = warp; tt < nt; tt += NTH / 32) {
      A sum = 0;
      for (int c = lane; c < N; c += 32)
        sum = mad(A(cs[tt][c]), dcs[tt][c], sum);
      sum = warp_sum(sum);
      if (lane == 0) cdc[tt] = sum;
    }
    __syncthreads();
    if (t == 0) {
      for (int tt = 0; tt < nt; ++tt) {
        dab[t0 + tt] = float(Pacc);
        Pacc += xdxs[tt] - cdc[tt];
      }
    }
    for (int idx = t; idx < nt * N; idx += NTH) {
      const int tt = idx / N, nn = idx % N;
      dcb[(long long)(t0 + tt) * N + nn] = float(dcs[tt][nn]);
    }
  }
}

// out[b, t, n] = sum_h part[b, h, t, n], h in order.
template <typename T>
__global__ void ssd_bwd_head_sum(const float* __restrict__ part,
                                 T* __restrict__ out, int H, long long TN,
                                 long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long b = i / TN, rem = i % TN;
  const float* p = part + b * H * TN + rem;
  float s = 0.f;
  for (int h = 0; h < H; ++h) s += p[h * TN];
  out[i] = from_f32<T>(s);
}

struct Args {
  const void* x;
  const float* a;
  const void *Bm, *Cm;
  const float* s0;
  const void* dy;
  const float* dsT;
  void* dx;
  float* da;
  void *dB, *dC;
  float *ds0, *dBh, *dCh;
  void *xdx, *c0;  // scratch in the accumulation type
};

template <typename T, int N>
int launch(const Args& g, const Strides (&s)[6], int Bt, int H, int Tn,
           int P, cudaStream_t stream) {
  // s: x, a, B, C, dy, dx
  using A = typename Acc<T>::type;
  const T *x = static_cast<const T*>(g.x), *Bm = static_cast<const T*>(g.Bm),
          *Cm = static_cast<const T*>(g.Cm),
          *dy = static_cast<const T*>(g.dy);
  ssd_bwd_reverse<T, N><<<Bt * H, 4 * P + row_threads<N>(), 0, stream>>>(
      x, g.a, Bm, Cm, g.s0, dy, g.dsT, static_cast<T*>(g.dx), g.dBh,
      static_cast<A*>(g.xdx), static_cast<A*>(g.c0), g.ds0, s[0], s[1], s[2],
      s[3], s[4], s[5], H, Tn, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_forward<T, N><<<Bt * H, row_threads<N>(), 0, stream>>>(
      x, g.a, Bm, Cm, g.s0, dy, static_cast<const A*>(g.xdx),
      static_cast<const A*>(g.c0), g.dCh, g.da, s[0], s[1], s[2], s[3], s[4],
      H, Tn, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long TN = (long long)Tn * N, total = Bt * TN;
  const int blocks = static_cast<int>((total + 255) / 256);
  ssd_bwd_head_sum<T><<<blocks, 256, 0, stream>>>(g.dBh, static_cast<T*>(g.dB),
                                                    H, TN, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_head_sum<T><<<blocks, 256, 0, stream>>>(g.dCh, static_cast<T*>(g.dC),
                                                    H, TN, total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(int N, const Args& g, const Strides (&s)[6], int Bt, int H,
             int Tn, int P, cudaStream_t stream) {
  switch (N) {
    case 4: return launch<T, 4>(g, s, Bt, H, Tn, P, stream);
    case 8: return launch<T, 8>(g, s, Bt, H, Tn, P, stream);
    case 16: return launch<T, 16>(g, s, Bt, H, Tn, P, stream);
    case 32: return launch<T, 32>(g, s, Bt, H, Tn, P, stream);
    case 64: return launch<T, 64>(g, s, Bt, H, Tn, P, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, dy, dx: (Bt, H, T, P); a: (Bt, H, T); B, C: (Bt, T, N). Element
// (b, h, t, c) of x, dy and dx lies at base + b*s[0] + h*s[1] + t*s[2] + c,
// element (b, h, t) of a at base + b*s[0] + h*s[1] + t*s[2], element
// (b, t, n) of B and C at base + b*s[0] + t*s[2] + n (s[1] unused), with the
// strides (in elements) of x, a, B, C, dy, dx in that order in st[18].
// s0, dS_T (may be null: zero) and dS0 (Bt, H, N, P), da (Bt, H, T), the
// scratches dBh and dCh (Bt, H, T, N) are contiguous f32; dB and dC
// (Bt, T, N) are contiguous in x's dtype; the scratch xdx (Bt, H, T) and
// c0 (Bt, H) is contiguous, f64 for dtype 0 and f32 for dtype 1. dtype 0
// is f32, 1 is bf16 (x, B, C, dy, dx, dB, dC). N is one of 4, 8, 16, 32,
// 64; P a multiple of 8 up to 64. Returns the first failed launch's
// cudaGetLastError() (cudaErrorInvalidValue for another N, P or dtype).
extern "C" int ssd_bwd_launch(const void* x, const float* a, const void* Bm,
                              const void* Cm, const float* s0, const void* dy,
                              const float* dsT, void* dx, float* da, void* dB,
                              void* dC, float* ds0, float* dBh, float* dCh,
                              void* xdx, void* c0, const long long* st,
                              int dtype, int Bt, int H, int T, int N, int P,
                              void* stream) {
  if (P < 8 || P > MAX_P || P % 8) return static_cast<int>(cudaErrorInvalidValue);
  Strides s[6];
  recurrence::unpack(st, s);
  const Args g{x, a, Bm, Cm, s0, dy, dsT, dx, da, dB, dC, ds0, dBh, dCh,
               xdx, c0};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_n<float>(N, g, s, Bt, H, T, P, cs);
  if (dtype == 1) return launch_n<__nv_bfloat16>(N, g, s, Bt, H, T, P, cs);
  return static_cast<int>(cudaErrorInvalidValue);
}
