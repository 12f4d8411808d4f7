// Mamba2 SSD recurrence (scalar decay per step and head) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_kernel` (src/repro/kernels/ssd.py,
// `ssd`). Per (b, h), with an f32 state S of N x P:
//     S_t = exp(a_t) S_{t-1} + B_t x_t^T          a_t <= 0, B_t in R^N
//     y_t = C_t^T S_t
// where B and C are shared by all heads; returns (y in x's dtype, final S
// in f32). Every (b, h) block reads the shared (Bt, T, N) B and C directly
// (the TPU wrapper broadcast them to every head, src/repro/kernels/ssd.py:
// 87-88), from L2 after the first head of a batch row.
//
// What bounds it on an H100: at zamba2-7b's shape (Bt=64, H=112, T=512,
// N=P=64, bf16 x/B/C/y, f32 a) the function moves ~1.2 GB, 0.36 ms at the
// data sheet's 3.35 TB/s; the chunked form's products (chunk 64, below)
// take less on the bf16 tensor cores: the function is bound by bytes.
//
// Two kernels, chosen by the input type:
// * bf16 (the main path): the TPU kernel's chunked form, on the tensor
//   cores (mma.sync m16n8k16, f32 accumulation). One block of four warps
//   per (b, h) walks T in chunks of L = 64 steps (its own chunk, whatever
//   the model's chunk_size: the chunk changes only rounding) with the f32
//   state in registers. Per chunk, with cw = cumsum(a) (a warp scan):
//       G  = C B^T                         (L x L, over N)
//       M  = G * tril(exp(cw_t - cw_s))
//       y  = M x + diag(exp(cw)) C S
//       S' = exp(cw_last) S + (x * exp(cw_last - cw))^T B   (as S'^T)
//   Warp w owns the chunk's steps 16w..16w+15 for G, M and y (so G and M
//   x skip the s-tiles past them: causal) and the state's head columns
//   16w..16w+15 for S'^T, whose f32 accumulators stay in registers across
//   chunks. M leaves the G accumulators as the A fragments of M x, and
//   the decay of the state update scales x^T's A fragments, both in
//   registers. S^T goes through shared memory once per chunk, as the B
//   fragments of C S. x, B, C and a of the next chunk arrive by cp.async
//   (16-byte chunks of a row; 8 bytes for N = 4; 4 bytes for each a) into
//   the other stage of a two-stage ring while this chunk computes; rows
//   past T are zero-filled (a = 0 there, so cw_last is the last real
//   step's). N and P below 16 / 64 are zero-padded in shared memory.
//   Precision: M, S and the decayed x are f32 values; a single bf16
//   rounding of them puts the output of the main shape at up to 19x the
//   1e-2 tolerance against the plain version (a CPU emulation), so each
//   goes in as hi + lo bf16 halves (two products), which keeps about 16
//   bits: seven products per chunk instead of four.
// * f32: the sequential recurrence on the CUDA cores, f32 throughout (no
//   TF32). One block per (b, h); thread (p, q) owns state column p and the
//   rows n = q + 4i (i < N/4) in registers; per tile of TC steps the block
//   stages x, B, C and exp(a) in shared memory and every thread steps
//   through the tile. No main path runs it.
//
// Layout: x, y (Bt, H, T, P), a (Bt, H, T) and B, C (Bt, T, N) are views
// with any strides whose last dimension is contiguous (a: any strides);
// s0 and s_out (Bt, H, N, P) are contiguous. The bf16 kernel needs 16-byte
// aligned rows of x and y (8-byte for B and C when N = 4); the wrapper
// checks them.

#include "recurrence.cuh"
#include "tensor_core.cuh"
#include "launch_plan.cuh"

#include <cstdint>

namespace {

constexpr int TC = 32;      // steps staged in shared memory per tile (f32)
constexpr int MAX_P = 64;  // 4 * MAX_P threads per block (f32)

using recurrence::Strides;
using recurrence::from_f32;
using recurrence::to_f32;
using tc::cp_async;
using tc::cp_async_commit;
using tc::cp_async_wait_all;
using tc::ldsm_x4;
using tc::ldsm_x4_t;
using tc::mma_bf16;
using tc::smem_u32;
using tc::split2;

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

// --- bf16: the chunked form on the tensor cores ---------------------------

constexpr int L = 64;         // steps per chunk
constexpr int PP = 64;        // head dim padded: four warps x 16 columns
constexpr int XP = PP + 8;    // x and y row pitch (an odd multiple of 16 B)
constexpr int MMA_THREADS = 128;

// (Fragment layouts: tensor_core.cuh.)
//
// NP: the state dim N padded to a multiple of 16 (16, 32, 64). Shared
// memory (dynamic): two stages of x [L][XP], B and C [L][NP + 8] and a
// [L] (f32); S^T hi and lo [PP][NP + 8]; for NP < PP y [L][XP]; cw [4][L]
// (f32, one per warp). At NP = 64 that is 75 KB and at most 168 registers
// a thread: three blocks, twelve warps, on each SM.
template <int NP>
__global__ void __launch_bounds__(MMA_THREADS, 3)
ssd_mma_kernel(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ a,
               const __nv_bfloat16* __restrict__ Bm,
               const __nv_bfloat16* __restrict__ Cm,
               const float* __restrict__ s0, __nv_bfloat16* __restrict__ y,
               float* __restrict__ s_out, Strides sx, Strides sa, Strides sb,
               Strides sc, Strides sy, int H, int Tn, int N, int P) {
  constexpr int BP = NP + 8;    // B, C, S^T row pitch
  constexpr int KN = NP / 16;   // k-steps over the state dim
  constexpr int NN = NP / 8;    // n-tiles over the state dim
  constexpr int NPT = PP / 8;   // n-tiles over the head dim
  constexpr int XS = L * XP, BS = L * BP;
  constexpr bool YIC = NP == PP;  // y staged in the chunk's C rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2]
  __nv_bfloat16* Bs = Xs + 2 * XS;                                  // [2]
  __nv_bfloat16* Cs = Bs + 2 * BS;                                  // [2]
  __nv_bfloat16* Sh = Cs + 2 * BS;
  __nv_bfloat16* Sl = Sh + PP * BP;
  __nv_bfloat16* Ys = Sl + PP * BP;
  float* As = reinterpret_cast<float*>(Ys + (YIC ? 0 : XS));       // [2]
  float* cws = As + 2 * L;                                          // [4]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  float* cw = cws + warp * L;

  const __nv_bfloat16* xb = x + b * sx.b + h * sx.h;
  const float* ab = a + b * sa.b + h * sa.h;
  const __nv_bfloat16* bb = Bm + b * sb.b;
  const __nv_bfloat16* cb = Cm + b * sc.b;
  __nv_bfloat16* yb = y + b * sy.b + h * sy.h;

  // the padding columns (P..PP-1 of x, N..NP-1 of B and C) stay zero: the
  // copies below write only the real ones
  if (P < PP || N < NP) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int e = t; e < (2 * XS + 4 * BS) / 8; e += MMA_THREADS)
      reinterpret_cast<uint4*>(Xs)[e] = z;
    __syncthreads();
  }
  const int nc = (Tn + L - 1) / L;
  auto load = [&](int c) {
    const int st = c & 1;
    __nv_bfloat16* xd = Xs + st * XS;
    __nv_bfloat16* bd = Bs + st * BS;
    __nv_bfloat16* cd = Cs + st * BS;
    const int pc = P / 8;
    for (int e = t; e < L * pc; e += MMA_THREADS) {
      const int r = e / pc, k = e % pc;
      const int tt = c * L + r;
      const bool ok = tt < Tn;
      cp_async<16>(smem_u32(xd + r * XP + 8 * k),
                   xb + (long long)(ok ? tt : 0) * sx.t + 8 * k, ok ? 16 : 0);
    }
    if (N % 8 == 0) {
      const int nck = N / 8;
      for (int e = t; e < L * nck; e += MMA_THREADS) {
        const int r = e / nck, k = e % nck;
        const int tt = c * L + r;
        const bool ok = tt < Tn;
        const long long row = ok ? tt : 0;
        cp_async<16>(smem_u32(bd + r * BP + 8 * k), bb + row * sb.t + 8 * k,
                     ok ? 16 : 0);
        cp_async<16>(smem_u32(cd + r * BP + 8 * k), cb + row * sc.t + 8 * k,
                     ok ? 16 : 0);
      }
    } else {  // N = 4: one 8-byte piece per row
      for (int r = t; r < L; r += MMA_THREADS) {
        const int tt = c * L + r;
        const bool ok = tt < Tn;
        const long long row = ok ? tt : 0;
        cp_async<8>(smem_u32(bd + r * BP), bb + row * sb.t, ok ? 8 : 0);
        cp_async<8>(smem_u32(cd + r * BP), cb + row * sc.t, ok ? 8 : 0);
      }
    }
    if (t < L) {
      const int tt = c * L + t;
      const bool ok = tt < Tn;
      cp_async<4>(smem_u32(As + st * L + t), ab + (long long)(ok ? tt : 0) * sa.t,
                  ok ? 4 : 0);
    }
  };
  load(0);
  cp_async_commit();

  // S^T: this warp's head columns p = 16 warp + g (+8), state rows
  // n = 8j + 2tq (+1), as C fragments of a 16 x NP product
  float sacc[NN][4];
  const float* s0p = s0 + (long long)bh * N * P;
#pragma unroll
  for (int j = 0; j < NN; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 8 * j + 2 * tq + (e & 1), p = 16 * warp + g + 8 * (e >> 1);
      sacc[j][e] = n < N && p < P ? s0p[n * P + p] : 0.f;
    }
  }
  auto store_state = [&]() {
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      const int off = (16 * warp + g) * BP + 8 * j + 2 * tq;
      uint32_t hi, lo;
      split2(sacc[j][0], sacc[j][1], hi, lo);
      *reinterpret_cast<uint32_t*>(Sh + off) = hi;
      *reinterpret_cast<uint32_t*>(Sl + off) = lo;
      split2(sacc[j][2], sacc[j][3], hi, lo);
      *reinterpret_cast<uint32_t*>(Sh + off + 8 * BP) = hi;
      *reinterpret_cast<uint32_t*>(Sl + off + 8 * BP) = lo;
    }
  };
  store_state();

  const int tr = 16 * warp + g;             // this lane's steps: tr, tr + 8
#pragma unroll 1
  for (int c = 0; c < nc; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c has landed; S^T of chunk c - 1 is stored
    if (c + 1 < nc) load(c + 1);
    cp_async_commit();
    const int st = c & 1;
    const __nv_bfloat16* xs = Xs + st * XS;
    const __nv_bfloat16* bs = Bs + st * BS;
    const __nv_bfloat16* cs = Cs + st * BS;

    // cw = cumsum(a) over the chunk: two steps a lane, a warp scan
    {
      const float a0 = As[st * L + 2 * lane], a1 = As[st * L + 2 * lane + 1];
      float v = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      cw[2 * lane] = v - a1;
      cw[2 * lane + 1] = v;
      __syncwarp();
    }
    const float cw_last = cw[L - 1];
    const float e0 = __expf(cw[tr]), e1 = __expf(cw[tr + 8]);

    // C A-fragments of this warp's steps, for C S and C B^T
    uint32_t ca[KN][4];
#pragma unroll
    for (int ks = 0; ks < KN; ++ks)
      ldsm_x4(ca[ks], smem_u32(cs + (16 * warp + lane % 16) * BP + 16 * ks +
                               8 * (lane / 16)));

    // y = diag(e^cw) C S, S as hi + lo. Each loop issues its products to
    // independent accumulators back to back.
    float yacc[NPT][4];
#pragma unroll
    for (int j = 0; j < NPT; ++j) yacc[j][0] = yacc[j][1] = yacc[j][2] = yacc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KN; ++ks) {
      uint32_t bh_[PP / 16][4], bl_[PP / 16][4];
#pragma unroll
      for (int pp = 0; pp < PP / 16; ++pp) {
        const int off = (16 * pp + lane % 8 + 8 * (lane / 16)) * BP + 16 * ks +
                        8 * ((lane / 8) % 2);
        ldsm_x4(bh_[pp], smem_u32(Sh + off));
        ldsm_x4(bl_[pp], smem_u32(Sl + off));
      }
#pragma unroll
      for (int pp = 0; pp < PP / 16; ++pp) {
        mma_bf16(yacc[2 * pp], ca[ks], bh_[pp][0], bh_[pp][1]);
        mma_bf16(yacc[2 * pp + 1], ca[ks], bh_[pp][2], bh_[pp][3]);
      }
#pragma unroll
      for (int pp = 0; pp < PP / 16; ++pp) {
        mma_bf16(yacc[2 * pp], ca[ks], bl_[pp][0], bl_[pp][1]);
        mma_bf16(yacc[2 * pp + 1], ca[ks], bl_[pp][2], bl_[pp][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      yacc[j][0] *= e0;
      yacc[j][1] *= e0;
      yacc[j][2] *= e1;
      yacc[j][3] *= e1;
    }

    // G = C B^T over the s-tiles up to this warp's steps (s <= t)
    float gacc[L / 8][4];
#pragma unroll
    for (int j = 0; j < L / 8; ++j) gacc[j][0] = gacc[j][1] = gacc[j][2] = gacc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KN; ++ks) {
#pragma unroll
      for (int sp = 0; sp < L / 16; ++sp) {   // s in 16 sp .. 16 sp + 15
        if (sp > warp) break;
        uint32_t bf[4];
        ldsm_x4(bf, smem_u32(bs + (16 * sp + lane % 8 + 8 * (lane / 16)) * BP +
                             16 * ks + 8 * ((lane / 8) % 2)));
        mma_bf16(gacc[2 * sp], ca[ks], bf[0], bf[1]);
        mma_bf16(gacc[2 * sp + 1], ca[ks], bf[2], bf[3]);
      }
    }
    // M = G * exp(cw_t - cw_s) for s <= t, as hi + lo A fragments of M x;
    // x rows s with P contiguous: ldmatrix.trans gives its B fragments
    const float cw0 = cw[tr], cw1 = cw[tr + 8];
#pragma unroll
    for (int sp = 0; sp < L / 16; ++sp) {
      if (sp > warp) break;
      float mv[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int s0i = 16 * sp + 8 * jj + 2 * tq;
        const float c0 = cw[s0i], c1 = cw[s0i + 1];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tt = tr + 8 * (e >> 1);
          const float ce = (e & 1) ? c1 : c0;
          mv[jj][e] = s0i + (e & 1) <= tt
                          ? gacc[2 * sp + jj][e] * __expf((e < 2 ? cw0 : cw1) - ce)
                          : 0.f;
        }
      }
      uint32_t mh[4], ml[4];
      split2(mv[0][0], mv[0][1], mh[0], ml[0]);
      split2(mv[0][2], mv[0][3], mh[1], ml[1]);
      split2(mv[1][0], mv[1][1], mh[2], ml[2]);
      split2(mv[1][2], mv[1][3], mh[3], ml[3]);
      uint32_t bx[PP / 16][4];
#pragma unroll
      for (int dp = 0; dp < PP / 16; ++dp)
        ldsm_x4_t(bx[dp], smem_u32(xs + (16 * sp + lane % 8 + 8 * ((lane / 8) % 2)) *
                                            XP +
                                   16 * dp + 8 * (lane / 16)));
#pragma unroll
      for (int dp = 0; dp < PP / 16; ++dp) {
        mma_bf16(yacc[2 * dp], mh, bx[dp][0], bx[dp][1]);
        mma_bf16(yacc[2 * dp + 1], mh, bx[dp][2], bx[dp][3]);
      }
#pragma unroll
      for (int dp = 0; dp < PP / 16; ++dp) {
        mma_bf16(yacc[2 * dp], ml, bx[dp][0], bx[dp][1]);
        mma_bf16(yacc[2 * dp + 1], ml, bx[dp][2], bx[dp][3]);
      }
    }

    // y through this warp's 16 rows of a staging tile, then 16-byte
    // stores. With N = 64 the tile is this warp's rows of the chunk's C,
    // which no other warp reads and which the warp holds in ca.
    __nv_bfloat16* ys = YIC ? Cs + st * BS + 16 * warp * BP : Ys + 16 * warp * XP;
    constexpr int YP = YIC ? BP : XP;
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(ys + g * YP + 8 * j + 2 * tq) =
          __floats2bfloat162_rn(yacc[j][0], yacc[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(ys + (g + 8) * YP + 8 * j + 2 * tq) =
          __floats2bfloat162_rn(yacc[j][2], yacc[j][3]);
    }
    __syncwarp();
    {
      const int pc = P / 8;
      for (int e = lane; e < 16 * pc; e += 32) {
        const int r = e / pc, k = e % pc;
        const int tt = c * L + 16 * warp + r;
        if (tt < Tn)
          *reinterpret_cast<uint4*>(yb + (long long)tt * sy.t + 8 * k) =
              *reinterpret_cast<const uint4*>(ys + r * YP + 8 * k);
      }
      __syncwarp();
    }

    // S'^T = e^{cw_last} S^T + (x * e^{cw_last - cw})^T B: A = x^T (this
    // warp's head columns), decayed and split in registers; B rows s with
    // N contiguous, by ldmatrix.trans
    const float el = __expf(cw_last);
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      sacc[j][0] *= el;
      sacc[j][1] *= el;
      sacc[j][2] *= el;
      sacc[j][3] *= el;
    }
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      uint32_t xr[4];
      ldsm_x4_t(xr, smem_u32(xs + (16 * kk + lane % 8 + 8 * (lane / 16)) * XP +
                             16 * warp + 8 * ((lane / 8) % 2)));
      uint32_t bf[NN / 2][4];
#pragma unroll
      for (int np = 0; np < NN / 2; ++np)
        ldsm_x4_t(bf[np], smem_u32(bs + (16 * kk + lane % 8 + 8 * ((lane / 8) % 2)) *
                                            BP +
                                   16 * np + 8 * (lane / 16)));
      const int s0i = 16 * kk + 2 * tq;
      const float d0 = __expf(cw_last - cw[s0i]), d1 = __expf(cw_last - cw[s0i + 1]);
      const float d8 = __expf(cw_last - cw[s0i + 8]),
                  d9 = __expf(cw_last - cw[s0i + 9]);
      uint32_t xh[4], xl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&xr[i]);
        const float f0 = i < 2 ? d0 : d8, f1 = i < 2 ? d1 : d9;
        split2(__low2float(v) * f0, __high2float(v) * f1, xh[i], xl[i]);
      }
#pragma unroll
      for (int np = 0; np < NN / 2; ++np) {
        mma_bf16(sacc[2 * np], xh, bf[np][0], bf[np][1]);
        mma_bf16(sacc[2 * np + 1], xh, bf[np][2], bf[np][3]);
      }
#pragma unroll
      for (int np = 0; np < NN / 2; ++np) {
        mma_bf16(sacc[2 * np], xl, bf[np][0], bf[np][1]);
        mma_bf16(sacc[2 * np + 1], xl, bf[np][2], bf[np][3]);
      }
    }
    __syncthreads();  // every warp has read S^T of this chunk
    store_state();
  }

  float* sp = s_out + (long long)bh * N * P;
#pragma unroll
  for (int j = 0; j < NN; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 8 * j + 2 * tq + (e & 1), p = 16 * warp + g + 8 * (e >> 1);
      if (n < N && p < P) sp[n * P + p] = sacc[j][e];
    }
  }
}

template <int NP>
int launch_bf16(const void* x, const float* a, const void* Bm, const void* Cm,
                const float* s0, void* y, float* s_out, const Strides* st,
                int Bt, int H, int Tn, int N, int P, cudaStream_t stream) {
  constexpr size_t smem = sizeof(__nv_bfloat16) *
                              ((NP == PP ? 2 : 3) * L * XP +
                               4 * L * (NP + 8) + 2 * PP * (NP + 8)) +
                          sizeof(float) * (2 * L + 4 * L);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_mma_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaError_t err2 = cudaFuncSetAttribute(
        ssd_mma_kernel<NP>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err2 != cudaSuccess) return static_cast<int>(err2);
    configured = true;
  }
  COVER(0, (long long)Bt * H, 1);
  LAUNCH((ssd_mma_kernel<NP>), Bt * H, MMA_THREADS, smem, stream,
      static_cast<const __nv_bfloat16*>(x), a,
      static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), s0,
      static_cast<__nv_bfloat16*>(y), s_out, st[0], st[1], st[2], st[3],
      st[4], H, Tn, N, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
int launch(const void* x, const float* a, const void* Bm, const void* Cm,
           const float* s0, void* y, float* s_out, const Strides* st, int Bt,
           int H, int Tn, int P, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * TC * P + 2 * TC * N + TC);
  COVER(0, (long long)Bt * H, 1);
  LAUNCH((ssd_kernel<T, N>), Bt * H, 4 * P, smem, stream,
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
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (N) {
    case 4:
    case 8:
    case 16:
      return launch_bf16<16>(x, a, Bm, Cm, s0, y, s_out, s, Bt, H, T, N, P, cs);
    case 32:
      return launch_bf16<32>(x, a, Bm, Cm, s0, y, s_out, s, Bt, H, T, N, P, cs);
    case 64:
      return launch_bf16<64>(x, a, Bm, Cm, s0, y, s_out, s, Bt, H, T, N, P, cs);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
