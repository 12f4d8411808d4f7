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
//
// da pairs S_{t-1} with G_t, which run in opposite directions. Since
// <G_t, S_t> = da_t + x_t . dx_t and <G_{t-1}, S_{t-1}> = C_{t-1} . dC_{t-1}^(h)
// + da_t (dC^(h): the head's own share of dC),
//     da_{t+1} = da_t + x_t . dx_t - C_t . dC_t^(h),
// a prefix sum of products of the outputs (ref.ssd_da_prefix); it cancels
// where the decay is strong.
//
// Two routes, chosen by the input type.
//
// * bf16 (the training path): the chunked form on the tensor cores
//   (mma.sync m16n8k16, f32 accumulation), in chunks of L = 64 steps (the
//   kernel's own, whatever the model's chunk) that run in parallel.
//   Within a chunk, cw = cumsum(a) (inclusive), cwl = cw[L-1]; S0 is the
//   state before the chunk and Gx the gradient of its last state from the
//   steps after it. With M[i,j] = (C_i . B_j) e^(cw_i - cw_j) and
//   W[i,j] = (dy_i . x_j) e^(cw_i - cw_j) for j <= i (the exponent masked
//   before the exponential, as csrc/ssd.cu does: no factor exceeds 1),
//       dx_j      = sum_{i>=j} M[i,j] dy_i + e^(cwl - cw_j) Gx^T B_j
//       dB_j^(h)  = sum_{i>=j} W[i,j] C_i  + e^(cwl - cw_j) Gx x_j
//       dC_i^(h)  = sum_{j<=i} W[i,j] B_j  + e^(cw_i) S0 dy_i
//   Five launches on the caller's stream, no atomics: two calls give the
//   same bits.
//   1. chunk states, one block of four warps per (chunk, b, h): the
//      chunk's own dS = (B e^(cwl - cw))^T x and dG = (C e^cw)^T dy, and
//      cwl, to f32 scratch (Bt, H, chunks, 64, 64).
//   2. the boundary scan, one block of 256 threads per (b, h): S0 of every
//      chunk (S0' = e^cwl S0 + dS) over the dS scratch, Gx of every chunk
//      (going back: G = e^cwl G + dG) over the dG scratch, dS0, and each
//      chunk's first da, <Gx_{c-1}, S0_c>, exact in f32.
//   3. the outputs, one block of four warps per (chunk, b, group of eight
//      heads); warp w owns the steps 16w .. 16w + 15. Per head: M as rows j
//      (C B^T, shared by the heads, is recomputed: one product) and dx; W
//      as rows j and the head's dB; W as rows i and the head's dC; then da,
//      re-anchored at each chunk: phase 2's first da plus the prefix of
//      the chunk's own terms. The group's dB and dC add up in registers in
//      order of h, to f32 scratch (Bt, groups, T, N): at zamba2-7b's 112
//      heads 14 groups, 896 blocks.
//   4., 5. dB and dC: the groups' shares summed in order.
//   Precision: M and W enter their products as hi + lo bf16 halves (two
//   products each); the decayed B and C, x, dy and the boundary states as
//   one bf16 rounding. One rounding of M or of W puts da 1.5-2.4x past
//   the 1e-2 x max tolerance at a = -2 (tests/
//   test_torch_recurrent_bwd_chunks.py, which emulates this arithmetic);
//   the other operands hold it with one.
//   Rows past T are zero-filled (a = 0 there); N and P below 64 are
//   zero-padded in shared memory.
// * f32 (only the checks run it): two step sweeps on the CUDA cores,
//   accumulating in f64, since the prefix sum over all of T cancels.
//   1. reverse sweep, one block per (b, h) of 4P + max(32, 4N) threads: G
//      in registers twice, once column-owned (thread (p, q) holds
//      G[q + 4i, p], so dx[p] = sum_n G[n, p] B[n] is a sum over the four
//      lanes of a quad) and once row-owned (thread (n, q) holds
//      G[n, q + 4i], so the head's dB[n] = sum_p G[n, p] x[p] is a quad sum
//      too). Writes dx, dS0, the head's dB to f32 scratch (Bt, H, T, N), and
//      x_t . dx_t and <s0, dS0> to f64 scratch.
//   2. forward sweep, max(32, 4N) threads per (b, h), S row-owned: the
//      head's dC to a second f32 scratch, and da from the running <G, S>
//      started at <s0, dS0>.
//   3., 4. dB and dC: the heads' shares summed in order of h, one launch
//      each of one kernel.
//   Per tile of TC steps a block stages x, dy, B, C and exp(a) in shared
//   memory (f32, zero-padded to 64 columns), then every thread steps
//   through the tile.
//
// What bounds it on an H100: at zamba2-7b's training shape (Bt=4, H=112,
// T=1024, N=P=64; bf16 x/dy/dx/B/C/dB/dC, f32 a and da) the function
// moves ~0.12 GB, 0.04 ms at the data sheet's 3.35 TB/s; the chunked
// products take about as long on the tensor cores. The bf16 route moves
// the two boundary-state scratches besides (117 MB each, written in
// phase 1, rewritten in phase 2, read in phase 3). The step sweeps, run
// on bf16 inputs, took 2.90 ms, bound by each block's chain of 1024
// dependent steps over 448 blocks; here a block's chain is eight heads of
// one chunk (PERF.md section 6 has both in turns). Phase 3
// takes the largest share (PERF.md section 6): 235 registers a thread hold
// it to two blocks, eight warps, an SM, too few to hide its latencies.
//
// Layout: x, dy, dx (Bt, H, T, P) and a (Bt, H, T) are views with any
// strides whose last dimension is contiguous (a: any strides), B, C
// (Bt, T, N) likewise; s0, dS_T and dS0 (Bt, H, N, P), da (Bt, H, T), the
// scratches and dB, dC (Bt, T, N) are contiguous.

#include "recurrence.cuh"
#include "tensor_core.cuh"
#include "launch_plan.cuh"

#include <cstdint>

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

// --- bf16: the chunked form on the tensor cores ---------------------------

using bf16 = __nv_bfloat16;
using tc::cp_async;
using tc::cp_async_commit;
using tc::cp_async_wait_all;
using tc::mma_bf16;
using tc::pack_bf16;
using tc::smem_u32;
using tc::split2;

constexpr int L = 64;        // steps per chunk
constexpr int DP = 64;       // N and P padded
constexpr int XP = DP + 8;   // bf16 row pitch (an odd multiple of 16 B)
constexpr int XS = L * XP;
constexpr int NTH = 128;     // four warps
constexpr int SCAN_THREADS = 256;
constexpr int HEAD_GROUP = 8;  // heads per phase-3 block
// phase 1: x, dy, B, C [L][XP], cw [L]
constexpr size_t SMEM1 = sizeof(bf16) * 4 * XS + sizeof(float) * L;
// phase 3: B, C, x, dy [L][XP]; S0, Gx [DP][XP]; cw, x . dx, C . dC [L]
constexpr size_t SMEM3 = sizeof(bf16) * 6 * XS + sizeof(float) * 3 * L;

__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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
__device__ __forceinline__ void zero_smem(void* base, size_t bytes) {
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (size_t e = threadIdx.x; e < bytes / 16; e += NTH)
    reinterpret_cast<uint4*>(base)[e] = z;
}

// `cols` bf16 columns of the chunk's L rows of a (T, cols) matrix with row
// stride st_t into a [L][XP] tile by cp.async, rows past T zero-filled
// (16-byte pieces; 8-byte when cols = 4).
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long st_t, int c, int Tn,
                                          int cols) {
  if (cols % 8 == 0) {
    const int pc = cols / 8;
    for (int e = threadIdx.x; e < L * pc; e += NTH) {
      const int row = e / pc, k = e % pc;
      const int tt = c * L + row;
      const bool ok = tt < Tn;
      cp_async<16>(smem_u32(dst + row * XP + 8 * k),
                   src + (long long)(ok ? tt : 0) * st_t + 8 * k, ok ? 16 : 0);
    }
  } else {
    for (int row = threadIdx.x; row < L; row += NTH) {
      const int tt = c * L + row;
      const bool ok = tt < Tn;
      cp_async<8>(smem_u32(dst + row * XP), src + (long long)(ok ? tt : 0) * st_t,
                  ok ? 8 : 0);
    }
  }
}

// cw = cumsum(a) over the chunk by warp 0 (two steps a lane), rows past T
// holding a = 0; the other warps wait at the caller's barrier.
__device__ __forceinline__ void scan_cw(float* cw, const float* ab, long long st_t,
                                        int c, int Tn) {
  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= 32) return;
  const int t0 = c * L + 2 * lane;
  const float a0 = t0 < Tn ? ab[t0 * st_t] : 0.f;
  const float a1 = t0 + 1 < Tn ? ab[(t0 + 1) * st_t] : 0.f;
  float v = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  cw[2 * lane] = v - a1;
  cw[2 * lane + 1] = v;
}

struct ChunkArgs {
  const bf16 *x, *B, *C, *dy;
  const float *a, *s0, *dsT;
  bf16* dx;
  float *da, *ds0;
  float *dS, *dG, *cwl, *first, *dBp, *dCp;  // scratch
  Strides sx, sa, sb, sc, sdy, sdx;
  int Bt, H, Tn, N, P, nc, nG;
};

// Phase 1: the chunk's own dS = (B e^(cwl - cw))^T x and dG = (C e^cw)^T dy,
// and its cwl. Warp w owns state rows n = 16w .. 16w + 15.
__global__ void __launch_bounds__(NTH)
ssd_bwd_chunk_states(ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ys = Xs + XS;
  bf16* Bs = Ys + XS;
  bf16* Cs = Bs + XS;
  float* cw = reinterpret_cast<float*>(Cs + XS);
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int T0 = 16 * warp;

  if (a.P < DP || a.N < DP) {
    zero_smem(smem_raw, sizeof(bf16) * 4 * XS);
    __syncthreads();
  }
  load_rows(Xs, a.x + b * a.sx.b + h * a.sx.h, a.sx.t, c, a.Tn, a.P);
  load_rows(Ys, a.dy + b * a.sdy.b + h * a.sdy.h, a.sdy.t, c, a.Tn, a.P);
  load_rows(Bs, a.B + b * a.sb.b, a.sb.t, c, a.Tn, a.N);
  load_rows(Cs, a.C + b * a.sc.b, a.sc.t, c, a.Tn, a.N);
  cp_async_commit();
  scan_cw(cw, a.a + b * a.sa.b + h * a.sa.h, a.sa.t, c, a.Tn);
  cp_async_wait_all();
  __syncthreads();

  // A fragments: rows n = T0 + g (+8), steps s = 16J + 2tq (+1) (+8) of
  // B^T and C^T by ldmatrix.trans, scaled per step
  const float cl = cw[L - 1];
  float sacc[8][4], gacc[8][4];
  zero(sacc);
  zero(gacc);
#pragma unroll
  for (int J = 0; J < L / 16; ++J) {
    uint32_t br[4], cr[4], bd[4], cd[4];
    const uint32_t off = (16 * J + lane % 8 + 8 * (lane / 16)) * XP + T0 + 8 * ((lane / 8) % 2);
    tc::ldsm_x4_t(br, smem_u32(Bs + off));
    tc::ldsm_x4_t(cr, smem_u32(Cs + off));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 16 * J + 2 * tq + 8 * (i >> 1);
      const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&br[i]));
      const float2 cv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&cr[i]));
      bd[i] = pack_bf16(bv.x * __expf(cl - cw[s]), bv.y * __expf(cl - cw[s + 1]));
      cd[i] = pack_bf16(cv.x * __expf(cw[s]), cv.y * __expf(cw[s + 1]));
    }
    uint32_t bx[4][4], by[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      ld_b_kn(bx[p], Xs, 16 * J, 16 * p);
      ld_b_kn(by[p], Ys, 16 * J, 16 * p);
    }
    mma_row(sacc, bd, bx);
    mma_row(gacc, cd, by);
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
  if (t == 0) a.cwl[(long long)bh * a.nc + c] = cl;
}

// Phase 2: the boundary scan, in place over the scratch: dS -> S0 of each
// chunk, dG -> Gx of each chunk (the gradient of its last state from the
// steps after it); dS0; each chunk's first da, <Gx_{c-1}, S0_c>. Thread t
// owns the float4 t + 256 m (m < 4) of each 64 x 64 matrix: row
// t / 16 + 16 m, columns 4 (t % 16) .. + 3, so a warp's loads and stores
// are whole 512-byte runs; the next chunk's loads are issued before this
// chunk's stores.
__global__ void __launch_bounds__(SCAN_THREADS)
ssd_bwd_chunk_scan(ChunkArgs a) {
  __shared__ float red[2][SCAN_THREADS / 32];
  const int bh = blockIdx.x;
  const int t = threadIdx.x, row0 = t / 16, col = 4 * (t % 16);
  const int warp = t / 32, lane = t % 32;
  const int N = a.N, P = a.P, nc = a.nc;
  const long long sbase = (long long)bh * N * P;
  const float4* dS4 = reinterpret_cast<const float4*>(a.dS);
  const float4* dG4 = reinterpret_cast<const float4*>(a.dG);
  auto at = [&](int c, int m) { return ((long long)bh * nc + c) * (DP * DP / 4) + t + 256 * m; };
  auto init = [&](const float* src, float (&X)[4][4]) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = row0 + 16 * m, p = col + i;
        X[m][i] = src && n < N && p < P ? src[sbase + n * P + p] : 0.f;
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
    const float w = __expf(a.cwl[(long long)bh * nc + c]);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      reinterpret_cast<float4*>(a.dS)[at(c, m)] = make_float4(X[m][0], X[m][1], X[m][2], X[m][3]);
      X[m][0] = fmaf(w, X[m][0], x[m].x);
      X[m][1] = fmaf(w, X[m][1], x[m].y);
      X[m][2] = fmaf(w, X[m][2], x[m].z);
      X[m][3] = fmaf(w, X[m][3], x[m].w);
    }
  }
  init(a.dsT, X);  // now the gradient
  float4 ng[4], ns[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    ng[m] = dG4[at(nc - 1, m)];
    ns[m] = dS4[at(nc - 1, m)];
  }
  for (int c = nc - 1; c >= 0; --c) {
    float4 x[4], s4[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      x[m] = ng[m];
      s4[m] = ns[m];
    }
    if (c > 0) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        ng[m] = dG4[at(c - 1, m)];
        ns[m] = dS4[at(c - 1, m)];
      }
    }
    const float w = __expf(a.cwl[(long long)bh * nc + c]);
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      reinterpret_cast<float4*>(a.dG)[at(c, m)] = make_float4(X[m][0], X[m][1], X[m][2], X[m][3]);
      X[m][0] = fmaf(w, X[m][0], x[m].x);
      X[m][1] = fmaf(w, X[m][1], x[m].y);
      X[m][2] = fmaf(w, X[m][2], x[m].z);
      X[m][3] = fmaf(w, X[m][3], x[m].w);
      acc = fmaf(X[m][0], s4[m].x, acc);
      acc = fmaf(X[m][1], s4[m].y, acc);
      acc = fmaf(X[m][2], s4[m].z, acc);
      acc = fmaf(X[m][3], s4[m].w, acc);
    }
    // the block's sum, warps in order (alternate buffers: no second barrier)
    acc = recurrence::warp_sum(acc);
    if (lane == 0) red[c & 1][warp] = acc;
    __syncthreads();
    if (t == 0) {
      float sum = 0.f;
      for (int i = 0; i < SCAN_THREADS / 32; ++i) sum += red[c & 1][i];
      a.first[(long long)bh * nc + c] = sum;
    }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = row0 + 16 * m, p = col + i;
      if (n < N && p < P) a.ds0[sbase + n * P + p] = X[m][i];
    }
  }
}

// Phase 3: the outputs of one chunk for a group of heads; warp w owns the
// steps 16w .. 16w + 15 of each. dB and dC are summed over the group's
// heads in registers, in order of h.
__global__ void __launch_bounds__(NTH, 2)
ssd_bwd_chunk_grads(ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Cs = Bs + XS;
  bf16* Xs = Cs + XS;
  bf16* Ys = Xs + XS;  // dy
  bf16* Ss = Ys + XS;  // S0 [n][p]
  bf16* Gs = Ss + XS;  // Gx [n][p]
  float* cw = reinterpret_cast<float*>(Gs + XS);
  float* zx = cw + L;  // x . dx of each step
  float* zc = zx + L;  // C . dC (the head's own) of each step

  const int c = blockIdx.x;
  const int b = blockIdx.y / a.nG, grp = blockIdx.y % a.nG;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int T0 = 16 * warp;
  const int Tn = a.Tn, N = a.N, P = a.P, nc = a.nc;
  const int h_end = min(a.H, (grp + 1) * HEAD_GROUP);

  if (P < DP || N < DP) {
    zero_smem(smem_raw, sizeof(bf16) * 4 * XS);
    __syncthreads();
  }
  load_rows(Bs, a.B + b * a.sb.b, a.sb.t, c, Tn, N);
  load_rows(Cs, a.C + b * a.sc.b, a.sc.t, c, Tn, N);

  float dBacc[8][4], dCacc[8][4];
  zero(dBacc);
  zero(dCacc);
  for (int h = grp * HEAD_GROUP; h < h_end; ++h) {
    const int bh = b * a.H + h;
    __syncthreads();  // the previous head is done with the tiles
    load_rows(Xs, a.x + b * a.sx.b + h * a.sx.h, a.sx.t, c, Tn, P);
    load_rows(Ys, a.dy + b * a.sdy.b + h * a.sdy.h, a.sdy.t, c, Tn, P);
    cp_async_commit();
    {  // the boundary states as bf16
      const long long base = ((long long)bh * nc + c) * DP * DP;
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
    }
    scan_cw(cw, a.a + b * a.sa.b + h * a.sa.h, a.sa.t, c, Tn);
    cp_async_wait_all();
    __syncthreads();
    const float cl = cw[L - 1];
    const float cj0 = cw[T0 + g], cj1 = cw[T0 + g + 8];

    // dx_j = sum_{i >= j} M[i, j] dy_i + e^(cwl - cw_j) (B_j^T Gx), M[i, j]
    // = (C_i . B_j) e^(cw_i - cw_j) as hi + lo halves
    {
      float m[8][4], acc[8][4];
      zero(m);
      zero(acc);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t af[4], bx[4][4];
        ld_a(af, Bs, T0, 16 * ks);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (p < warp) continue;
          uint32_t bb[4];
          ld_b_nk(bb, Cs, 16 * p, 16 * ks);
          mma_bf16(m[2 * p], af, bb[0], bb[1]);
          mma_bf16(m[2 * p + 1], af, bb[2], bb[3]);
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) ld_b_kn(bx[p], Gs, 16 * ks, 16 * p);
        mma_row(acc, af, bx);
      }
      const float e0 = __expf(cl - cj0), e1 = __expf(cl - cj1);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = T0 + g + 8 * (e >> 1), i = 8 * nt + 2 * tq + (e & 1);
          m[nt][e] = i >= j ? m[nt][e] * __expf(cw[i] - cw[j]) : 0.f;
        }
      }
#pragma unroll
      for (int J = 0; J < 4; ++J) {
        if (J < warp) continue;
        uint32_t ah[4], al[4], bx[4][4];
        split2(m[2 * J][0], m[2 * J][1], ah[0], al[0]);
        split2(m[2 * J][2], m[2 * J][3], ah[1], al[1]);
        split2(m[2 * J + 1][0], m[2 * J + 1][1], ah[2], al[2]);
        split2(m[2 * J + 1][2], m[2 * J + 1][3], ah[3], al[3]);
#pragma unroll
        for (int p = 0; p < 4; ++p) ld_b_kn(bx[p], Ys, 16 * J, 16 * p);
        mma_row(acc, ah, bx);
        mma_row(acc, al, bx);
      }
      bf16* dxb = a.dx + b * a.sdx.b + h * a.sdx.h;
      float z0 = 0.f, z1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int p = 8 * nt + 2 * tq;
        const float2 x0 = bf2(Xs + (T0 + g) * XP + p), x1 = bf2(Xs + (T0 + g + 8) * XP + p);
        z0 = fmaf(x0.x, acc[nt][0], fmaf(x0.y, acc[nt][1], z0));
        z1 = fmaf(x1.x, acc[nt][2], fmaf(x1.y, acc[nt][3], z1));
#pragma unroll
        for (int hl = 0; hl < 2; ++hl) {
          const int j = T0 + g + 8 * hl;
          if (c * L + j < Tn && p < P)
            *reinterpret_cast<__nv_bfloat162*>(dxb + (long long)(c * L + j) * a.sdx.t + p) =
                __floats2bfloat162_rn(acc[nt][2 * hl], acc[nt][2 * hl + 1]);
        }
      }
      z0 = recurrence::quad_sum(z0);
      z1 = recurrence::quad_sum(z1);
      if (tq == 0) {
        zx[T0 + g] = z0;
        zx[T0 + g + 8] = z1;
      }
    }

    // dB_j += sum_{i >= j} W[i, j] C_i + e^(cwl - cw_j) Gx x_j, W[i, j] =
    // (dy_i . x_j) e^(cw_i - cw_j) as hi + lo halves (rows j)
    {
      float w[8][4], acc[8][4];
      zero(w);
      zero(acc);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t af[4], bx[4][4];
        ld_a(af, Xs, T0, 16 * ks);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (p < warp) continue;
          uint32_t bb[4];
          ld_b_nk(bb, Ys, 16 * p, 16 * ks);
          mma_bf16(w[2 * p], af, bb[0], bb[1]);
          mma_bf16(w[2 * p + 1], af, bb[2], bb[3]);
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) ld_b_nk(bx[p], Gs, 16 * p, 16 * ks);
        mma_row(acc, af, bx);
      }
      const float e0 = __expf(cl - cj0), e1 = __expf(cl - cj1);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = T0 + g + 8 * (e >> 1), i = 8 * nt + 2 * tq + (e & 1);
          w[nt][e] = i >= j ? w[nt][e] * __expf(cw[i] - cw[j]) : 0.f;
        }
      }
#pragma unroll
      for (int J = 0; J < 4; ++J) {
        if (J < warp) continue;
        uint32_t ah[4], al[4], bx[4][4];
        split2(w[2 * J][0], w[2 * J][1], ah[0], al[0]);
        split2(w[2 * J][2], w[2 * J][3], ah[1], al[1]);
        split2(w[2 * J + 1][0], w[2 * J + 1][1], ah[2], al[2]);
        split2(w[2 * J + 1][2], w[2 * J + 1][3], ah[3], al[3]);
#pragma unroll
        for (int p = 0; p < 4; ++p) ld_b_kn(bx[p], Cs, 16 * J, 16 * p);
        mma_row(acc, ah, bx);
        mma_row(acc, al, bx);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dBacc[nt][e] += acc[nt][e];
      }
    }

    // dC_i += sum_{j <= i} W[i, j] B_j + e^(cw_i) S0 dy_i (rows i); the
    // head's C . dC for da
    {
      float w[8][4], acc[8][4];
      zero(w);
      zero(acc);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t af[4], bx[4][4];
        ld_a(af, Ys, T0, 16 * ks);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (p > warp) break;
          uint32_t bb[4];
          ld_b_nk(bb, Xs, 16 * p, 16 * ks);
          mma_bf16(w[2 * p], af, bb[0], bb[1]);
          mma_bf16(w[2 * p + 1], af, bb[2], bb[3]);
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) ld_b_nk(bx[p], Ss, 16 * p, 16 * ks);
        mma_row(acc, af, bx);
      }
      const float e0 = __expf(cj0), e1 = __expf(cj1);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = T0 + g + 8 * (e >> 1), j = 8 * nt + 2 * tq + (e & 1);
          w[nt][e] = j <= i ? w[nt][e] * __expf(cw[i] - cw[j]) : 0.f;
        }
      }
#pragma unroll
      for (int J = 0; J < 4; ++J) {
        if (J > warp) break;
        uint32_t ah[4], al[4], bx[4][4];
        split2(w[2 * J][0], w[2 * J][1], ah[0], al[0]);
        split2(w[2 * J][2], w[2 * J][3], ah[1], al[1]);
        split2(w[2 * J + 1][0], w[2 * J + 1][1], ah[2], al[2]);
        split2(w[2 * J + 1][2], w[2 * J + 1][3], ah[3], al[3]);
#pragma unroll
        for (int p = 0; p < 4; ++p) ld_b_kn(bx[p], Bs, 16 * J, 16 * p);
        mma_row(acc, ah, bx);
        mma_row(acc, al, bx);
      }
      float z0 = 0.f, z1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = 8 * nt + 2 * tq;
        const float2 c0 = bf2(Cs + (T0 + g) * XP + n), c1 = bf2(Cs + (T0 + g + 8) * XP + n);
        z0 = fmaf(c0.x, acc[nt][0], fmaf(c0.y, acc[nt][1], z0));
        z1 = fmaf(c1.x, acc[nt][2], fmaf(c1.y, acc[nt][3], z1));
#pragma unroll
        for (int e = 0; e < 4; ++e) dCacc[nt][e] += acc[nt][e];
      }
      z0 = recurrence::quad_sum(z0);
      z1 = recurrence::quad_sum(z1);
      if (tq == 0) {
        zc[T0 + g] = z0;
        zc[T0 + g + 8] = z1;
      }
    }
    __syncthreads();
    // da = the first da + the exclusive prefix of x . dx - C . dC
    if (warp == 0) {
      const int i = 2 * lane;
      const float z0 = zx[i] - zc[i], z1 = zx[i + 1] - zc[i + 1];
      float v = z0 + z1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      const float f = a.first[(long long)bh * nc + c];
      float* dab = a.da + (long long)bh * Tn + c * L;
      if (c * L + i < Tn) dab[i] = f + (v - z0 - z1);
      if (c * L + i + 1 < Tn) dab[i + 1] = f + (v - z1);
    }
  }

  // the group's share of dB and dC: (Bt, groups, T, N) f32
  const long long part = ((long long)b * a.nG + grp) * Tn;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int hl = 0; hl < 2; ++hl) {
      const int j = T0 + g + 8 * hl, n = 8 * nt + 2 * tq;
      if (c * L + j < Tn && n < N) {
        const long long idx = (part + c * L + j) * N + n;
        *reinterpret_cast<float2*>(a.dBp + idx) =
            make_float2(dBacc[nt][2 * hl], dBacc[nt][2 * hl + 1]);
        *reinterpret_cast<float2*>(a.dCp + idx) =
            make_float2(dCacc[nt][2 * hl], dCacc[nt][2 * hl + 1]);
      }
    }
  }
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
  void *xdx, *c0;  // f64 scratch
};

template <int N>
int launch(const Args& g, const Strides (&s)[6], int Bt, int H, int Tn,
           int P, cudaStream_t stream) {
  // s: x, a, B, C, dy, dx
  using T = float;
  using A = typename Acc<T>::type;
  const T *x = static_cast<const T*>(g.x), *Bm = static_cast<const T*>(g.Bm),
          *Cm = static_cast<const T*>(g.Cm),
          *dy = static_cast<const T*>(g.dy);
  COVER(0, (long long)Bt * H, 1);
  LAUNCH((ssd_bwd_reverse<T, N>), Bt * H, 4 * P + row_threads<N>(), 0, stream,
      x, g.a, Bm, Cm, g.s0, dy, g.dsT, static_cast<T*>(g.dx), g.dBh,
      static_cast<A*>(g.xdx), static_cast<A*>(g.c0), g.ds0, s[0], s[1], s[2],
      s[3], s[4], s[5], H, Tn, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  COVER(0, (long long)Bt * H, 1);
  LAUNCH((ssd_bwd_forward<T, N>), Bt * H, row_threads<N>(), 0, stream,
      x, g.a, Bm, Cm, g.s0, dy, static_cast<const A*>(g.xdx),
      static_cast<const A*>(g.c0), g.dCh, g.da, s[0], s[1], s[2], s[3], s[4],
      H, Tn, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long TN = (long long)Tn * N, total = Bt * TN;
  const int blocks = static_cast<int>((total + 255) / 256);
  COVER(0, total, 256);
  LAUNCH((ssd_bwd_head_sum<T>), blocks, 256, 0, stream, g.dBh,
         static_cast<T*>(g.dB), H, TN, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  COVER(0, total, 256);
  LAUNCH((ssd_bwd_head_sum<T>), blocks, 256, 0, stream, g.dCh,
         static_cast<T*>(g.dC), H, TN, total);
  return static_cast<int>(cudaGetLastError());
}

int launch_chunked(ChunkArgs& a, bf16* dB, bf16* dC, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_chunk_grads, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM3));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_chunk_grads,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  COVER(0, a.Tn, L);
  COVER(1, (long long)a.Bt * a.H, 1);
  LAUNCH((ssd_bwd_chunk_states), dim3(a.nc, a.Bt * a.H), NTH, SMEM1, stream, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  COVER(0, (long long)a.Bt * a.H, 1);
  LAUNCH((ssd_bwd_chunk_scan), a.Bt * a.H, SCAN_THREADS, 0, stream, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  COVER(0, a.Tn, L);
  COVER(1, (long long)a.Bt * a.H, HEAD_GROUP);
  LAUNCH((ssd_bwd_chunk_grads), dim3(a.nc, a.Bt * a.nG), NTH, SMEM3, stream, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long TN = (long long)a.Tn * a.N, total = a.Bt * TN;
  const int blocks = static_cast<int>((total + 255) / 256);
  COVER(0, total, 256);
  LAUNCH((ssd_bwd_head_sum<bf16>), blocks, 256, 0, stream, a.dBp, dB, a.nG, TN, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  COVER(0, total, 256);
  LAUNCH((ssd_bwd_head_sum<bf16>), blocks, 256, 0, stream, a.dCp, dC, a.nG, TN, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dy, dx: (Bt, H, T, P); a: (Bt, H, T); B, C: (Bt, T, N). Element
// (b, h, t, c) of x, dy and dx lies at base + b*s[0] + h*s[1] + t*s[2] + c,
// element (b, h, t) of a at base + b*s[0] + h*s[1] + t*s[2], element
// (b, t, n) of B and C at base + b*s[0] + t*s[2] + n (s[1] unused), with the
// strides (in elements) of x, a, B, C, dy, dx in that order in st[18].
// s0, dS_T (may be null: zero) and dS0 (Bt, H, N, P), da (Bt, H, T) are
// contiguous f32; dB and dC (Bt, T, N) are contiguous in x's dtype. N is
// one of 4, 8, 16, 32, 64; P a multiple of 8 up to 64. Both return the
// first failed launch's cudaGetLastError() (cudaErrorInvalidValue for
// another N or P).
//
// f32 (the step sweeps): the scratches dBh and dCh (Bt, H, T, N) are
// contiguous f32, xdx (Bt, H, T) and c0 (Bt, H) contiguous f64.
extern "C" int ssd_bwd_launch(const void* x, const float* a, const void* Bm,
                              const void* Cm, const float* s0, const void* dy,
                              const float* dsT, void* dx, float* da, void* dB,
                              void* dC, float* ds0, float* dBh, float* dCh,
                              void* xdx, void* c0, const long long* st,
                              int Bt, int H, int T, int N, int P,
                              void* stream) {
  if (P < 8 || P > MAX_P || P % 8) return static_cast<int>(cudaErrorInvalidValue);
  Strides s[6];
  recurrence::unpack(st, s);
  const Args g{x, a, Bm, Cm, s0, dy, dsT, dx, da, dB, dC, ds0, dBh, dCh,
               xdx, c0};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return launch<4>(g, s, Bt, H, T, P, cs);
    case 8: return launch<8>(g, s, Bt, H, T, P, cs);
    case 16: return launch<16>(g, s, Bt, H, T, P, cs);
    case 32: return launch<32>(g, s, Bt, H, T, P, cs);
    case 64: return launch<64>(g, s, Bt, H, T, P, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16 (the chunked form; x, B, C, dy with 16-byte aligned rows, B and C
// 8-byte at N = 4). Scratch, contiguous f32, nc = ceil(T / 64) and
// groups = ceil(H / 8): dS and dG (Bt, H, nc, 64, 64), cwl and first
// (Bt, H, nc), dBp and dCp (Bt, groups, T, N).
extern "C" int ssd_bwd_chunked_launch(
    const void* x, const float* a, const void* Bm, const void* Cm,
    const float* s0, const void* dy, const float* dsT, void* dx, float* da,
    void* dB, void* dC, float* ds0, float* dS, float* dG, float* cwl,
    float* first, float* dBp, float* dCp, const long long* st, int Bt,
    int H, int T, int N, int P, void* stream) {
  if (P < 8 || P > MAX_P || P % 8 || (N != 4 && N != 8 && N != 16 &&
                                      N != 32 && N != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s[6];
  recurrence::unpack(st, s);
  ChunkArgs g{static_cast<const bf16*>(x), static_cast<const bf16*>(Bm),
              static_cast<const bf16*>(Cm), static_cast<const bf16*>(dy),
              a, s0, dsT, static_cast<bf16*>(dx), da, ds0,
              dS, dG, cwl, first, dBp, dCp,
              s[0], s[1], s[2], s[3], s[4], s[5],
              Bt, H, T, N, P, (T + L - 1) / L,
              (H + HEAD_GROUP - 1) / HEAD_GROUP};
  return launch_chunked(g, static_cast<bf16*>(dB), static_cast<bf16*>(dC),
                        static_cast<cudaStream_t>(stream));
}
