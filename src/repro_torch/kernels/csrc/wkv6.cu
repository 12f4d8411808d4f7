// RWKV6 (WKV6) recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_wkv6_kernel` (src/repro/kernels/wkv6.py,
// `wkv6`). Per (b, h), with an f32 state S of Dh x Dh:
//     out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t   = diag(exp(lw_t)) S_{t-1} + k_t v_t^T          lw_t <= 0
// and returns (out in r's dtype, final S in f32).
//
// The TPU kernel runs the chunked form: per chunk of C steps it builds a
// (C, C, Dh) log-space decay tensor (1 MB of f32 at C = 64, over the 227 KB
// of shared memory a Hopper block may have) and carries S across chunks in
// VMEM. This kernel runs the sequential recurrence instead, which computes
// the same function for any T (no T % chunk rule) and only ever multiplies
// by decays exp(lw) <= 1, so it never exponentiates a positive number.
//
// Design: one block per (b, h); 4*Dh threads. Thread (e, q) owns state
// column e and the rows d = q + 4i (i < Dh/4) in registers, so S never
// leaves the chip across T. Per tile of TC steps the block stages r, k, v
// and exp(lw) in shared memory (f32), then every thread steps through the
// tile: acc = sum_d r_d (S_de + u_d k_d v_e), S_de = w_d S_de + k_d v_e; the
// four threads of a column (adjacent lanes) add their partial sums with two
// shuffles, and the tile's outputs are written back coalesced.
//
// What bounds it on an H100: at rwkv6-3b's shape (B=64, H=40, T=512,
// Dh=64, bf16 r/k/v/out, f32 lw) the function moves ~1.09 GB (r, k, v and
// out 671 MB, lw 336 MB, states 84 MB), 0.33 ms at the data sheet's 3.35
// TB/s. The chunked form's products, 4*B*H*T*Dh*(C+Dh) = 43 GFLOP at C = 64,
// take 0.04 ms on the bf16 tensor cores: the function is bound by bytes.
// This design instead does 7 f32 operations per state element and step on
// the CUDA cores (38 GFLOP, 0.56 ms at 67 TFLOP/s), and is held back further
// by its shared-memory loads (three per state element and step). The
// chunked form on tensor cores is work for a later PR.
//
// Layout: r, k, v, lw and out are (B, H, T, Dh) views with any strides whose
// last dimension is contiguous; u (H, Dh), s0 and s_out (B, H, Dh, Dh) are
// contiguous.

#include "recurrence.cuh"

namespace {

constexpr int TC = 32;  // steps staged in shared memory per tile

using recurrence::Strides;
using recurrence::from_f32;
using recurrence::to_f32;

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

template <typename T, int DH>
int launch(const void* r, const void* k, const void* v, const float* lw,
           const float* u, const float* s0, void* out, float* s_out,
           const Strides* st, int B, int H, int Tn, cudaStream_t stream) {
  wkv6_kernel<T, DH><<<B * H, 4 * DH, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), lw, u, s0, static_cast<T*>(out), s_out,
      st[0], st[1], st[2], st[3], st[4], H, Tn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(int Dh, const void* r, const void* k, const void* v,
              const float* lw, const float* u, const float* s0, void* out,
              float* s_out, const Strides* st, int B, int H, int Tn,
              cudaStream_t s) {
  switch (Dh) {
    case 8: return launch<T, 8>(r, k, v, lw, u, s0, out, s_out, st, B, H, Tn, s);
    case 16: return launch<T, 16>(r, k, v, lw, u, s0, out, s_out, st, B, H, Tn, s);
    case 32: return launch<T, 32>(r, k, v, lw, u, s0, out, s_out, st, B, H, Tn, s);
    case 64: return launch<T, 64>(r, k, v, lw, u, s0, out, s_out, st, B, H, Tn, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  Strides s[5];
  recurrence::unpack(st, s);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(Dh, r, k, v, lw, u, s0, out, s_out, s, B, H, T, cs);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(Dh, r, k, v, lw, u, s0, out, s_out, s, B,
                                    H, T, cs);
  return static_cast<int>(cudaErrorInvalidValue);
}
