// Mamba2 SSD recurrence (scalar decay per step and head) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_kernel` (src/repro/kernels/ssd.py,
// `ssd`). Per (b, h), with an f32 state S of N x P:
//     S_t = exp(a_t) S_{t-1} + B_t x_t^T          a_t <= 0, B_t in R^N
//     y_t = C_t^T S_t
// where B and C are shared by all heads; returns (y in x's dtype, final S
// in f32).
//
// Two things of the TPU design do not carry over. Its wrapper broadcasts B
// and C to every head (src/repro/kernels/ssd.py:87-88) and its kernel
// recomputes C.B^T per head; here every (b, h) block reads the shared
// (Bt, T, N) tensors directly, from L2 after the first head. And its
// chunked form needs a (C, C) decay-masked tile per chunk (256 KB of f32 at
// C = 256, over the 227 KB of shared memory a Hopper block may have). On
// the CUDA cores the chunked form at the model's chunk of 256 costs more
// operations per output than the sequential recurrence (about C + 4N = 512
// against 5N = 320 per element of y), so this kernel runs the recurrence,
// which also takes any T (no T % chunk rule) and only ever multiplies by
// decays exp(a) <= 1.
//
// Design: one block per (b, h); 4*P threads. Thread (p, q) owns state
// column p and the rows n = q + 4i (i < N/4) in registers, so S never
// leaves the chip across T. Per tile of TC steps the block stages x, B, C
// and exp(a) in shared memory (f32); every thread then steps through the
// tile: S_np = e^a S_np + B_n x_p, y_p += C_n S_np; the four threads of a
// column (adjacent lanes) add their partial y with two shuffles, and the
// tile's outputs are written back coalesced. f32 on the CUDA cores, no
// TF32.
//
// What bounds it on an H100: at zamba2-7b's shape (Bt=64, H=112, T=512,
// N=P=64, bf16 x/B/C/y, f32 a) the function moves ~1.2 GB, 0.36 ms at the
// data sheet's 3.35 TB/s. The chunked form's products (181 GFLOP at chunk
// 256) take 0.18 ms on the bf16 tensor cores: the function is bound by
// bytes. This design does 5*Bt*H*T*N*P = 75 GFLOP of f32 on the CUDA cores,
// 1.1 ms at 67 TFLOP/s. Tensor cores are for a later PR.
//
// Layout: x, y (Bt, H, T, P), a (Bt, H, T) and B, C (Bt, T, N) are views
// with any strides whose last dimension is contiguous (a: any strides);
// s0 and s_out (Bt, H, N, P) are contiguous.

#include "recurrence.cuh"

namespace {

constexpr int TC = 32;      // steps staged in shared memory per tile
constexpr int MAX_P = 64;  // 4 * MAX_P threads per block

using recurrence::Strides;
using recurrence::from_f32;
using recurrence::to_f32;

template <typename T, int N>
__global__ void __launch_bounds__(4 * MAX_P)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ a,
           const T* __restrict__ Bm, const T* __restrict__ Cm,
           const float* __restrict__ s0, T* __restrict__ y,
           float* __restrict__ s_out, Strides sx, Strides sa, Strides sb,
           Strides sc, Strides sy, int H, int Tn, int P) {
  constexpr int RPT = N / 4;  // state rows per thread
  extern __shared__ float smem[];
  float* xs = smem;              // [TC][P]
  float* ys = xs + TC * P;       // [TC][P]
  float* bs = ys + TC * P;       // [TC][N]
  float* cs = bs + TC * N;       // [TC][N]
  float* as = cs + TC * N;       // [TC]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int t = threadIdx.x, nthreads = blockDim.x;
  const int p = t / 4, q = t % 4;

  float S[RPT];
  const float* s0p = s0 + (long long)bh * N * P;
#pragma unroll
  for (int i = 0; i < RPT; ++i) S[i] = s0p[(q + 4 * i) * P + p];
  const T* xb = x + b * sx.b + h * sx.h;
  const float* ab = a + b * sa.b + h * sa.h;
  const T* bb = Bm + b * sb.b;
  const T* cb = Cm + b * sc.b;
  T* yb = y + b * sy.b + h * sy.h;

  for (int t0 = 0; t0 < Tn; t0 += TC) {
    const int nt = min(TC, Tn - t0);
    __syncthreads();  // the previous tile's reads and writes of ys are done
    for (int idx = t; idx < nt * P; idx += nthreads) {
      const int tt = idx / P, c = idx % P;
      xs[idx] = to_f32(xb[(t0 + tt) * sx.t + c]);
    }
    for (int idx = t; idx < nt * N; idx += nthreads) {
      const int tt = idx / N, n = idx % N;
      bs[idx] = to_f32(bb[(t0 + tt) * sb.t + n]);
      cs[idx] = to_f32(cb[(t0 + tt) * sc.t + n]);
    }
    if (t < nt) as[t] = expf(ab[(t0 + t) * sa.t]);
    __syncthreads();

#pragma unroll 1
    for (int tt = 0; tt < nt; ++tt) {
      const float xp = xs[tt * P + p];
      const float al = as[tt];
      const float* bt = bs + tt * N;
      const float* ct = cs + tt * N;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int n = q + 4 * i;
        S[i] = fmaf(al, S[i], bt[n] * xp);
        acc = fmaf(ct[n], S[i], acc);
      }
      acc = recurrence::quad_sum(acc);
      if (q == 0) ys[tt * P + p] = acc;
    }
    __syncthreads();
    for (int idx = t; idx < nt * P; idx += nthreads) {
      const int tt = idx / P, c = idx % P;
      yb[(t0 + tt) * sy.t + c] = from_f32<T>(ys[idx]);
    }
  }

  float* sp = s_out + (long long)bh * N * P;
#pragma unroll
  for (int i = 0; i < RPT; ++i) sp[(q + 4 * i) * P + p] = S[i];
}

template <typename T, int N>
int launch(const void* x, const float* a, const void* Bm, const void* Cm,
           const float* s0, void* y, float* s_out, const Strides* st, int Bt,
           int H, int Tn, int P, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * TC * P + 2 * TC * N + TC);
  ssd_kernel<T, N><<<Bt * H, 4 * P, smem, stream>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), s0, static_cast<T*>(y), s_out, st[0], st[1],
      st[2], st[3], st[4], H, Tn, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(int N, const void* x, const float* a, const void* Bm,
             const void* Cm, const float* s0, void* y, float* s_out,
             const Strides* st, int Bt, int H, int Tn, int P,
             cudaStream_t s) {
  switch (N) {
    case 4: return launch<T, 4>(x, a, Bm, Cm, s0, y, s_out, st, Bt, H, Tn, P, s);
    case 8: return launch<T, 8>(x, a, Bm, Cm, s0, y, s_out, st, Bt, H, Tn, P, s);
    case 16: return launch<T, 16>(x, a, Bm, Cm, s0, y, s_out, st, Bt, H, Tn, P, s);
    case 32: return launch<T, 32>(x, a, Bm, Cm, s0, y, s_out, st, Bt, H, Tn, P, s);
    case 64: return launch<T, 64>(x, a, Bm, Cm, s0, y, s_out, st, Bt, H, Tn, P, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, y: (Bt, H, T, P); a: (Bt, H, T); B, C: (Bt, T, N). Element (b, h, t, c)
// of x and y lies at base + b*s[0] + h*s[1] + t*s[2] + c, element (b, h, t)
// of a at base + b*s[0] + h*s[1] + t*s[2], element (b, t, n) of B and C at
// base + b*s[0] + t*s[2] + n (s[1] unused), with the strides (in elements)
// of x, a, B, C, y in that order in st[15]. s0 and s_out (Bt, H, N, P) are
// contiguous f32; a is f32. dtype 0 is f32, 1 is bf16 (x, B, C and y).
// N is one of 4, 8, 16, 32, 64; P is a multiple of 8 up to 64. Returns
// cudaGetLastError() (cudaErrorInvalidValue for another N, P or dtype).
extern "C" int ssd_launch(const void* x, const float* a, const void* Bm,
                          const void* Cm, const float* s0, void* y,
                          float* s_out, const long long* st, int dtype,
                          int Bt, int H, int T, int N, int P, void* stream) {
  if (P < 8 || P > MAX_P || P % 8) return static_cast<int>(cudaErrorInvalidValue);
  Strides s[5];
  recurrence::unpack(st, s);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_n<float>(N, x, a, Bm, Cm, s0, y, s_out, s, Bt, H, T, P, cs);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(N, x, a, Bm, Cm, s0, y, s_out, s, Bt, H, T,
                                   P, cs);
  return static_cast<int>(cudaErrorInvalidValue);
}
