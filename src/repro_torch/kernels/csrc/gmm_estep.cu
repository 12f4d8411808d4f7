// Diag/spher GMM E-step for Hopper (sm_90a), f32 on the CUDA cores.
//
// Replaces the Pallas TPU kernels `_estep_fused_kernel` and `_estep_kernel`
// (src/repro/kernels/gmm_estep.py, `estep_fused` / `estep`). For fit b, row
// n and component k it computes
//
//   logp[b,n,k] = c[b,k] - 0.5 * (x_n^2 . inv[b,k] - 2 x_n . muinv[b,k])
//
// with inv = 1/var, muinv = mu*inv and c = log pi - 0.5 (d log 2 pi +
// sum log var + sum mu^2 inv), and (when lse is given) the row logsumexp
// over k.
//
// What bounds it on an H100: the two products are 4*B*N*K*d f32 operations,
// and the bytes are x (read once per shared block), the (B, K, d) parameters
// and the (B, N, K) output. At the main path's shape (x (1,1000,1280),
// B = K = 10) that is ~0.51 GFLOP over ~6.6 MB, ~78 FLOP/byte, above the f32
// ridge (67 TFLOP/s / 3.35 TB/s = 20): it is bound by f32 operations. TF32
// tensor cores are ruled out because x^2.inv - 2x.(mu.inv) cancels terms
// that a 10-bit mantissa cannot carry to the 3e-4 tolerance.
//
// Two kernels, one launch function:
// * estep_prep: inv, muinv and c, one block per (b, k) (the reference's
//   _estep_call does this in XLA ops around its kernel). spher variances
//   arrive as (B, K) with a d-stride of 0.
// * estep_kernel: a block owns BN = 4 RS rows of one feature block and FB
//   of the fits that share it, FB * KT columns at a time (KT, the component
//   tile, is K rounded up to 2, 4, 8, 10 or 12; larger K loops over tiles
//   with a running (m, l) per row); FB * RS groups of DS threads, at most
//   256. Thread (group, ds): the group is one fit and a slot of RM = 4 rows
//   (rows slot + RS i), so each x value it loads serves KT components and
//   each parameter value 4 rows; ds is one of DS slices of the d loop (4
//   consecutive d of every chunk of 4 DS). x and the fits' inv and muinv
//   arrive chunk by chunk by cp.async (16-byte pieces, from a table of row
//   sources built once per component tile) into a four-stage ring; the DS
//   partial sums of a group (adjacent lanes) are added by shuffles, and
//   lane ds < RM then owns row ds of the group: its K log-numerators and
//   its logsumexp stay in that thread. Ragged N, K, fits and d are masked
//   (zero-filled copies, masked stores): exactly K columns are written.
//   On the card a block stages x and the parameters at about 11 GB/s,
//   whatever the number of blocks (kernels/compare.py --sweep-estep), so
//   the Python wrapper (gmm_estep.launch_plan) picks the plan whose busiest
//   SM stages the fewest bytes: at the main path's shape 2 fits and 40 rows
//   a block, 125 blocks of 160 threads, one an SM.

#include "tensor_core.cuh"
#include "launch_plan.cuh"

namespace {

constexpr int PREP_THREADS = 128;
constexpr int MAX_THREADS = 256;
constexpr int RM = 4;                   // rows per thread
constexpr int NST = 4;                  // stages of the copy ring
constexpr float NEG = -1e30f;
constexpr float LOG2PI = 1.8378770664093453f;

using tc::cp_async;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::smem_u32;

// one block per row (b, k) of the parameter grid: inv, muinv and c
__global__ void __launch_bounds__(PREP_THREADS)
estep_prep(const float* __restrict__ mu, const float* __restrict__ var,
           const float* __restrict__ pi, float* __restrict__ inv,
           float* __restrict__ muinv, float* __restrict__ cst, int d,
           long long var_row, long long var_d) {
  __shared__ float part[2][PREP_THREADS / 32];
  const int row = blockIdx.x, t = threadIdx.x;
  const float* m = mu + (long long)row * d;
  const float* v = var + row * var_row;
  float* ip = inv + (long long)row * d;
  float* mp = muinv + (long long)row * d;
  float logdet = 0.f, maha = 0.f;
#pragma unroll 4
  for (int dd = t; dd < d; dd += PREP_THREADS) {
    const float vv = v[dd * var_d], mm = m[dd];
    const float iv = 1.f / vv, mi = mm * iv;
    ip[dd] = iv;
    mp[dd] = mi;
    logdet += logf(vv);
    maha = fmaf(mm, mi, maha);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    logdet += __shfl_xor_sync(0xffffffffu, logdet, off);
    maha += __shfl_xor_sync(0xffffffffu, maha, off);
  }
  if (t % 32 == 0) {
    part[0][t / 32] = logdet;
    part[1][t / 32] = maha;
  }
  __syncthreads();
  if (t == 0) {
    logdet = maha = 0.f;
    for (int w = 0; w < PREP_THREADS / 32; ++w) {
      logdet += part[0][w];
      maha += part[1][w];
    }
    cst[row] = logf(fmaxf(pi[row], 1e-20f)) -
               0.5f * (d * LOG2PI + logdet + maha);
  }
}

template <int KT, int DS>
__global__ void __launch_bounds__(MAX_THREADS)
estep_kernel(const float* __restrict__ x, const float* __restrict__ inv,
             const float* __restrict__ muinv, const float* __restrict__ cst,
             float* __restrict__ out, float* __restrict__ lse, int r, int N,
             int K, int d, int FB, int RS, bool vec) {
  constexpr int DC = 4 * DS;  // d per chunk
  constexpr int P = DC + 4;   // row pitch (f32)
  extern __shared__ __align__(16) float smem[];
  const int BN = RM * RS, PR = FB * KT;
  const int SS = (BN + 2 * PR) * P;  // a stage: x [BN], inv, muinv [PR]

  const int t = threadIdx.x, ds = t % DS, grp = t / DS;
  const int j = grp % FB, slot = grp / FB;
  const int nfg = (r + FB - 1) / FB;
  const int bx = blockIdx.y / nfg, f0 = (blockIdx.y % nfg) * FB;
  const int n0 = blockIdx.x * BN;
  const bool fit_ok = f0 + j < r;
  const int b = bx * r + f0 + j;  // this thread's fit (if fit_ok)
  const float* xb = x + (long long)bx * N * d;
  const float* pb = inv + (long long)(bx * r + f0) * K * d;
  const float* qb = muinv + (long long)(bx * r + f0) * K * d;
  // the row this lane owns after the reduction (lanes ds < RM)
  const int my_n = n0 + slot + RS * (ds < RM ? ds : 0);

  float m_run = NEG, l_run = 0.f;
  const int nch = (d + DC - 1) / DC;

  // where each staged row comes from: x rows, then the fits' inv rows
  // (src) and muinv rows (src2), null past N, the fits or K (zero-filled)
  const float** src = reinterpret_cast<const float**>(smem + NST * SS);
  const float** src2 = src + BN + PR;
  // this thread's 16-byte piece q of rows r0, r0 + RSTEP, ... of a chunk
  const int RSTEP = blockDim.x / (DC / 4);
  const int q = t % (DC / 4), r0 = t / (DC / 4);

  for (int k0 = 0; k0 < K; k0 += KT) {
    for (int row = t; row < BN + PR; row += blockDim.x) {
      if (row < BN) {
        src[row] = n0 + row < N ? xb + (long long)(n0 + row) * d : nullptr;
      } else {
        const int pr = row - BN, jj = pr / KT, kk = k0 + pr % KT;
        const bool ok = f0 + jj < r && kk < K;
        const long long off = ((long long)jj * K + kk) * d;
        src[row] = ok ? pb + off : nullptr;
        src2[pr] = ok ? qb + off : nullptr;
      }
    }
    __syncthreads();
    auto load = [&](int ch) {
      float* xs = smem + (ch % NST) * SS;
      const int dd = ch * DC + 4 * q;
      const int have = min(4, max(0, d - dd));  // elements of this piece
      for (int row = r0; row < BN + PR; row += RSTEP) {
        float* dst = xs + row * P + 4 * q;
        const float* s1 = src[row];
        const float* s2 = row < BN ? nullptr : src2[row - BN];
        const int n = s1 ? have : 0;
        if (vec) {  // rows 16-byte aligned: one piece, zero-filled past d
          cp_async<16>(smem_u32(dst), n ? s1 + dd : xb, 4 * n);
          if (row >= BN)
            cp_async<16>(smem_u32(dst + PR * P), n ? s2 + dd : xb, 4 * n);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool in = i < n;
            cp_async<4>(smem_u32(dst + i), in ? s1 + dd + i : xb, in ? 4 : 0);
            if (row >= BN)
              cp_async<4>(smem_u32(dst + PR * P + i), in ? s2 + dd + i : xb,
                          in ? 4 : 0);
          }
        }
      }
    };

    float a1[RM][KT], a2[RM][KT];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) a1[i][kk] = a2[i][kk] = 0.f;

#pragma unroll
    for (int ch = 0; ch < NST - 1; ++ch) {
      if (ch < nch) load(ch);
      cp_async_commit();
    }
#pragma unroll 1
    for (int ch = 0; ch < nch; ++ch) {
      // chunk ch has landed (NST - 2 later ones may still be in flight)
      cp_async_wait<NST - 2>();
      __syncthreads();  // ... for every thread; chunk ch - 1 is summed
      if (ch + NST - 1 < nch) load(ch + NST - 1);
      cp_async_commit();
      const float* xs = smem + (ch % NST) * SS;
      const float* is = xs + BN * P + j * KT * P + 4 * ds;
      const float* ms = is + PR * P;
      float4 xv[RM], x2[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        xv[i] = *reinterpret_cast<const float4*>(xs + (slot + RS * i) * P + 4 * ds);
        x2[i] = make_float4(xv[i].x * xv[i].x, xv[i].y * xv[i].y,
                            xv[i].z * xv[i].z, xv[i].w * xv[i].w);
      }
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const float4 iv = *reinterpret_cast<const float4*>(is + kk * P);
        const float4 mv = *reinterpret_cast<const float4*>(ms + kk * P);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          a1[i][kk] = fmaf(x2[i].x, iv.x, a1[i][kk]);
          a1[i][kk] = fmaf(x2[i].y, iv.y, a1[i][kk]);
          a1[i][kk] = fmaf(x2[i].z, iv.z, a1[i][kk]);
          a1[i][kk] = fmaf(x2[i].w, iv.w, a1[i][kk]);
          a2[i][kk] = fmaf(xv[i].x, mv.x, a2[i][kk]);
          a2[i][kk] = fmaf(xv[i].y, mv.y, a2[i][kk]);
          a2[i][kk] = fmaf(xv[i].z, mv.z, a2[i][kk]);
          a2[i][kk] = fmaf(xv[i].w, mv.w, a2[i][kk]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every chunk is summed and every source read before
                      // the next tile's

    // the DS slices of a group are adjacent lanes: every one gets the sums
#pragma unroll
    for (int off = DS / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          a1[i][kk] += __shfl_xor_sync(0xffffffffu, a1[i][kk], off);
          a2[i][kk] += __shfl_xor_sync(0xffffffffu, a2[i][kk], off);
        }
    }
    // lane ds < RM: row slot + RS ds of its fit
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      if (i != ds) continue;
      const bool row_ok = fit_ok && my_n < N;
      float lp[KT], tmax = NEG;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const int k = k0 + kk;
        const float c = fit_ok && k < K ? cst[(long long)b * K + k] : 0.f;
        lp[kk] = fmaf(-0.5f, a1[i][kk] - 2.f * a2[i][kk], c);
        if (k < K) {
          if (row_ok) out[((long long)b * N + my_n) * K + k] = lp[kk];
          tmax = fmaxf(tmax, lp[kk]);
        }
      }
      const float m_new = fmaxf(m_run, tmax);
      float p = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        if (k0 + kk < K) p += expf(lp[kk] - m_new);
      l_run = l_run * expf(m_run - m_new) + p;
      m_run = m_new;
    }
  }

  if (lse != nullptr && ds < RM && fit_ok && my_n < N)
    lse[(long long)b * N + my_n] = m_run + logf(fmaxf(l_run, 1e-30f));
}

template <int KT, int DS>
int launch_main(const float* x, const float* inv, const float* muinv,
                const float* cst, float* out, float* lse, int Bx, int r,
                int N, int K, int d, int FB, int RS, bool vec,
                cudaStream_t s) {
  const int BN = RM * RS;
  const dim3 grid((N + BN - 1) / BN, Bx * ((r + FB - 1) / FB));
  const int rows = BN + 2 * FB * KT;  // and a source pointer each
  const int smem = static_cast<int>(sizeof(float)) * NST * rows * (4 * DS + 4) +
                   static_cast<int>(sizeof(float*)) * rows;
  static int allowed = 48 * 1024;  // dynamic shared memory without opting in
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        estep_kernel<KT, DS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  COVER(0, N, BN);
  COVER(1, (long long)Bx * r, FB);
  LAUNCH((estep_kernel<KT, DS>), grid, FB * RS * DS, smem, s,
      x, inv, muinv, cst, out, lse, r, N, K, d, FB, RS, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DS>
int launch_kt(int KT, const float* x, const float* inv, const float* muinv,
              const float* cst, float* out, float* lse, int Bx, int r, int N,
              int K, int d, int FB, int RS, bool vec, cudaStream_t s) {
  switch (KT) {
    case 2: return launch_main<2, DS>(x, inv, muinv, cst, out, lse, Bx, r, N, K, d, FB, RS, vec, s);
    case 4: return launch_main<4, DS>(x, inv, muinv, cst, out, lse, Bx, r, N, K, d, FB, RS, vec, s);
    case 8: return launch_main<8, DS>(x, inv, muinv, cst, out, lse, Bx, r, N, K, d, FB, RS, vec, s);
    case 10: return launch_main<10, DS>(x, inv, muinv, cst, out, lse, Bx, r, N, K, d, FB, RS, vec, s);
    case 12: return launch_main<12, DS>(x, inv, muinv, cst, out, lse, Bx, r, N, K, d, FB, RS, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (Bx, N, d) contiguous; mu (B, K, d) contiguous; var (B, K, d) or spher
// (B, K): element (row = b*K + k, dd) at var + row*var_row + dd*var_d; pi
// (B, K). Scratch inv, muinv (B, K, d) and cst (B, K); out (B, N, K); lse
// (B, N) or null for the numerators-only variant. All f32 on one device;
// B % Bx == 0, N, K, d >= 1. The plan (KT in 2, 4, 8, 10, 12; DS in 8, 16, 32;
// FB * RS * DS threads, a multiple of 32 up to 256) comes from the wrapper;
// vec says x's rows are 16-byte aligned (x and d % 4 == 0).
// Returns cudaGetLastError() (cudaErrorInvalidValue for another plan).
extern "C" int estep_launch(const float* x, const float* mu, const float* var,
                            long long var_row, long long var_d,
                            const float* pi, float* inv, float* muinv,
                            float* cst, float* out, float* lse, int Bx, int B,
                            int N, int K, int d, int KT, int DS, int FB,
                            int RS, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = FB * RS * DS;
  if (threads % 32 || threads > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  COVER(0, (long long)B * K, 1);
  LAUNCH((estep_prep), B * K, PREP_THREADS, 0, s, mu, var, pi, inv, muinv,
         cst, d, var_row, var_d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int r = B / Bx;
  if (DS == 8)
    return launch_kt<8>(KT, x, inv, muinv, cst, out, lse, Bx, r, N, K, d, FB,
                        RS, vec != 0, s);
  if (DS == 16)
    return launch_kt<16>(KT, x, inv, muinv, cst, out, lse, Bx, r, N, K, d,
                         FB, RS, vec != 0, s);
  if (DS == 32)
    return launch_kt<32>(KT, x, inv, muinv, cst, out, lse, Bx, r, N, K, d,
                         FB, RS, vec != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
