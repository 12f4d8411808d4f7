// Diag/spher GMM E-step for Hopper (sm_90a), f32 on the CUDA cores.
//
// Replaces the Pallas TPU kernels `_estep_fused_kernel` and `_estep_kernel`
// (src/repro/kernels/gmm_estep.py, `estep_fused` / `estep`). For fit b, row
// n and component k it computes
//
//   logp[b,n,k] = c[b,k] - 0.5 * (x_n^2 . inv[b,k] - 2 x_n . muinv[b,k])
//
// with inv = 1/var, muinv = mu*inv and the per-component constant c folded
// by the Python wrapper, and (template flag kLse) the row logsumexp over k.
//
// What bounds it on an H100: the two products are 4*B*N*K*d f32 operations,
// and the bytes are x (read once per shared block), the (B, K, d) parameters
// and the (B, N, K) output. At the main path's shape (x (1,1000,1280),
// B = K = 10) that is ~0.51 GFLOP over ~6.6 MB, ~78 FLOP/byte, above the f32
// ridge (67 TFLOP/s / 3.35 TB/s = 20): it is bound by f32 operations. TF32
// tensor cores are ruled out because x^2.inv - 2x.(mu.inv) cancels terms
// that a 10-bit mantissa cannot carry to the 3e-4 tolerance.
//
// Design against that bound, and against what differs from the TPU:
// * The TPU grid carried the running (m, l) logsumexp across its minor K
//   axis in VMEM. Hopper blocks run in no order, so one block owns BN rows
//   of one fit and sweeps every K tile itself, (m, l) in registers.
// * The TPU kept d whole per tile (a (256, 1280) f32 tile is 1.3 MB, far
//   over the 227 KB a block may have); here d is looped in DC-wide chunks
//   staged through shared memory, and x^2 is formed in registers, never
//   stored.
// * x is (Bx, N, d) and fit b reads block b / r (r = B / Bx) in place: no
//   repeated copy of x exists.
// * Ragged N and K edges are masked in the kernel; exactly K columns are
//   written, so no -1e30 padding leaks out.
// Each thread accumulates RPT rows x 1 component; the 16 threads of a row
// group are 16 consecutive lanes, so the per-tile row max and sum are warp
// shuffles. A simple kernel first: all r fits of one x tile in one block,
// TMA staging and a 3xTF32 split are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int BN = 64;                      // rows of x per block
constexpr int BK = 16;                      // components per K tile
constexpr int DC = 32;                      // d chunk staged in shared memory
constexpr int THREADS = 256;
constexpr int ROW_GROUPS = THREADS / BK;    // 16
constexpr int RPT = BN / ROW_GROUPS;        // rows per thread: 4
constexpr float NEG = -1e30f;

template <bool kLse>
__global__ void __launch_bounds__(THREADS)
estep_kernel(const float* __restrict__ x, const float* __restrict__ inv,
             const float* __restrict__ muinv, const float* __restrict__ cst,
             float* __restrict__ out, float* __restrict__ lse,
             int r, int N, int K, int d) {
  __shared__ float xs[BN][DC + 1];
  __shared__ float is[BK][DC + 1];
  __shared__ float ms[BK][DC + 1];

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * BN;
  const int t = threadIdx.x;
  const int tk = t % BK;
  const int tn = t / BK;
  const float* xb = x + (size_t)(b / r) * N * d;
  const float* ib = inv + (size_t)b * K * d;
  const float* mb = muinv + (size_t)b * K * d;

  float m_run[RPT], l_run[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m_run[i] = NEG;
    l_run[i] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    float a1[RPT], a2[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      a1[i] = 0.f;
      a2[i] = 0.f;
    }
    for (int d0 = 0; d0 < d; d0 += DC) {
      for (int e = t; e < BN * DC; e += THREADS) {
        const int row = e / DC, col = e % DC;
        const int n = n0 + row, dd = d0 + col;
        xs[row][col] = (n < N && dd < d) ? xb[(size_t)n * d + dd] : 0.f;
      }
      for (int e = t; e < BK * DC; e += THREADS) {
        const int row = e / DC, col = e % DC;
        const int k = k0 + row, dd = d0 + col;
        const bool ok = k < K && dd < d;
        is[row][col] = ok ? ib[(size_t)k * d + dd] : 0.f;
        ms[row][col] = ok ? mb[(size_t)k * d + dd] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float iv = is[tk][c];
        const float mv = ms[tk][c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float xv = xs[tn + i * ROW_GROUPS][c];
          a1[i] = fmaf(xv * xv, iv, a1[i]);
          a2[i] = fmaf(xv, mv, a2[i]);
        }
      }
      __syncthreads();
    }

    const int k = k0 + tk;
    const bool kok = k < K;
    const float c = kok ? cst[(size_t)b * K + k] : 0.f;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int n = n0 + tn + i * ROW_GROUPS;
      const float lp = -0.5f * (a1[i] - 2.f * a2[i]) + c;
      if (kok && n < N) out[((size_t)b * N + n) * K + k] = lp;
      if (kLse) {
        // row max / sum over this tile's 16 components: 16 adjacent lanes
        float tmax = kok ? lp : NEG;
#pragma unroll
        for (int off = BK / 2; off > 0; off >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
        const float m_new = fmaxf(m_run[i], tmax);
        float p = kok ? expf(lp - m_new) : 0.f;
#pragma unroll
        for (int off = BK / 2; off > 0; off >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, off);
        l_run[i] = l_run[i] * expf(m_run[i] - m_new) + p;
        m_run[i] = m_new;
      }
    }
  }

  if (kLse && tk == 0) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int n = n0 + tn + i * ROW_GROUPS;
      if (n < N)
        lse[(size_t)b * N + n] = m_run[i] + logf(fmaxf(l_run[i], 1e-30f));
    }
  }
}

}  // namespace

// x (Bx, N, d); inv, muinv (B, K, d); cst (B, K); out (B, N, K); lse (B, N)
// or null for the numerators-only variant. All f32, contiguous, on one
// device; B % Bx == 0, N, K, d >= 1. Returns cudaGetLastError().
extern "C" int estep_launch(const float* x, const float* inv,
                            const float* muinv, const float* cst, float* out,
                            float* lse, int Bx, int B, int N, int K, int d,
                            void* stream) {
  const dim3 grid((N + BN - 1) / BN, B);
  const int r = B / Bx;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lse != nullptr)
    estep_kernel<true><<<grid, THREADS, 0, s>>>(x, inv, muinv, cst, out, lse,
                                                r, N, K, d);
  else
    estep_kernel<false><<<grid, THREADS, 0, s>>>(x, inv, muinv, cst, out,
                                                 nullptr, r, N, K, d);
  return static_cast<int>(cudaGetLastError());
}
