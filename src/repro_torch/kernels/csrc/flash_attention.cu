// Online-softmax attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention.py, `flash_attention`), with all of
// its semantics: queries at the tail of the keys (q_pos = i + Sk - Sq);
// causal, sliding `window` and bidirectional `prefix` masks; GQA (q head h
// reads kv head h / G); scale 1/sqrt(D); running (m, l, acc) in f32; rows
// with no visible key come out as 0. Keys past Sk are masked here, which
// the TPU kernel left to its callers' block sizes. On request
// (`flash_attention_lse_launch`) both kernels also write each row's
// logsumexp, which the backward (flash_attention_bwd.cu) reads.
//
// What bounds it on an H100: at the encoder's shape (B=256, H=16, S=64,
// D=80, bf16) one call is 4*B*H*S*S*D = 5.4 GFLOP over 168 MB of q, k, v
// and o: 32 FLOP/byte, far under the bf16 tensor-core ridge (989 TFLOP/s /
// 3.35 TB/s = 295), so it is bound by bytes, ~50 us. zamba2-7b's shared
// causal block (B=64, H=32, S=512, D=112) needs 120 GFLOP over 940 MB:
// bytes again, 0.28 ms. The design reads q, k and v once from device
// memory and writes o once, and keeps S and P on chip.
//
// Two kernels, chosen by the input type:
// * bf16 (every main path): tensor cores, mma.sync m16n8k16 with f32
//   accumulation. A block of four warps owns a work item, 64 queries of
//   one (b, h); each warp owns 16 of them.
//   - Tile skipping. An item visits only the key tiles that hold a key
//     visible to one of its rows: `key_tiles` below, the same arithmetic
//     as `key_tile_range` in kernels/flash_attention.py (causal gives the
//     upper end, `window` the lower, `prefix` adds its tiles back); a warp
//     also skips the visited tiles that its own rows do not need. Only the
//     tiles a mask boundary cuts for a warp's rows (`tile_needs_mask`)
//     test each pair. Causal S = 512 visits 36 of 64 tiles per (b, h).
//   - Staging. Q, K and V arrive by 16-byte cp.async (rows of D*2 = 160 /
//     224 bytes hold whole 16-byte chunks; rows past Sq or Sk are zero-
//     filled) into row-major shared tiles whose row pitch, D + 8 elements,
//     is an odd multiple of 16 bytes, so the ldmatrix reads are free of
//     bank conflicts. A ring of two K/V stages keeps the next tile's
//     copies in flight while this one is multiplied; each thread keeps one
//     16-byte column of a row and steps its row, so an address costs one
//     add.
//   - Products. S = Q.K^T takes Q's A fragments and K's B fragments by
//     ldmatrix (Q is re-read each tile rather than held, which keeps the
//     kernel at 168 registers, three blocks an SM); P.V takes V's by
//     ldmatrix.trans from the same row-major layout (no transposed copy).
//     P goes from the S accumulators straight into the A fragments of P.V.
//   - Softmax: f32 registers, base 2, the scale folded into one FMA before
//     ex2.approx; masked pairs score -inf; O is rescaled only when a row
//     of the warp has a new maximum.
//   - O is staged through the block's Q tile and leaves in 16-byte stores.
//   - Precision: Q.K^T is exact against the reference's upcast product. P
//     is rounded to bf16 for P.V while l sums the unrounded P: that adds
//     at most 2^-9 * max|v| to each output, inside the 5e-2 tolerance.
//   - Not wgmma, not 32-row warps: kernels/variants/ holds a wgmma version
//     (one warpgroup, S and P.V by wgmma from no-swizzle shared layouts)
//     and one whose warps own 32 rows (K and V read once per 128 queries);
//     both are right and slower here (kernels/compare.py times them beside
//     this one; PERF.md §6 has the numbers).
// * f32: CUDA cores, f32 throughout (no TF32). Four threads share one
//   query row: each scores 16 of the tile's 64 keys with the row's query
//   in registers and owns D/4 of the output columns. It sweeps every key
//   tile; no main path runs it.
//
// Head dims: 16, 32, 64, 80 (hubert-xlarge), 112 (zamba2-7b's shared causal
// block: seven k-steps of 16 and fourteen n-tiles of 8), 128, 160
// (pixtral-12b) and 192 (nemotron-4-340b). At 160 and 192 a warp holds
// D / 2 = 80 and 96 f32 output accumulators a thread beside the 32 scores,
// which does not fit the 168 registers of three blocks an SM: those two
// instances take `min_blocks` = 1 (up to 255 registers). Their shared
// tiles, (D + 8) * (64 + 2 * 2 * 64) * 2 bytes, are 107.5 KB and 125 KB:
// two blocks an SM at 160, one at 192. A row of 20 or 24 16-byte chunks
// is copied by 32 lanes, 12 or 8 of them idle.
//
// Layout: q, k, v and o are (B, heads, S, D) views with any strides whose
// last dimension is contiguous, so the encoder passes (B, S, H, D) tensors
// transposed in place. The bf16 kernel needs 16-byte aligned bases and
// row, head and batch strides (the wrapper checks them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tensor_core.cuh"
#include "launch_plan.cuh"

namespace {

using tc::cp_async;
using tc::cp_async_commit;
using tc::cp_async_wait_all;
using tc::ex2;
using tc::ldsm_x4;
using tc::ldsm_x4_t;
using tc::mma_bf16;
using tc::pack_bf16;
using tc::smem_u32;

constexpr int BQ = 64;        // queries per block
constexpr int BKV = 64;       // keys per tile
constexpr int TPR = 4;        // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr int KPT = BKV / TPR;  // keys scored per thread per tile
constexpr float NEG = -1e30f;

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ bool visible(int q_pos, int kp, int Sk, int causal,
                                        int window, int prefix) {
  const int rel = q_pos - kp;
  bool ok = true;
  if (causal) ok = ok && rel >= 0;
  if (window > 0) ok = ok && rel < window;
  if (prefix > 0) ok = ok || kp < prefix;
  return ok && kp < Sk;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
             Strides so, int H, int Hkv, int Sq, int Sk, float scale,
             int causal, int window, int prefix) {
  extern __shared__ float smem[];
  float* Ks = smem;                      // [BKV][D + 1]
  float* Vs = Ks + BKV * (D + 1);        // [BKV][D]
  float* Ps = Vs + BKV * D;              // [BQ][BKV + 1]
  constexpr int DPT = D / TPR;           // output columns per thread

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int t = threadIdx.x;
  const int row = t / TPR, sub = t % TPR;
  const int qi = blockIdx.y * BQ + row;
  const bool q_ok = qi < Sq;
  const int q_pos = qi + Sk - Sq;

  float qr[D];
  const float* qp =
      q + b * sq.b + h * sq.h + (long long)(q_ok ? qi : 0) * sq.s;
#pragma unroll
  for (int c = 0; c < D; ++c) qr[c] = q_ok ? qp[c] : 0.f;

  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = NEG, l = 0.f;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;

  for (int k0 = 0; k0 < Sk; k0 += BKV) {
    __syncthreads();  // the previous tile's K, V and P reads are done
    for (int e = t; e < BKV * D; e += THREADS) {
      const int j = e / D, c = e % D;
      const bool ok = k0 + j < Sk;
      Ks[j * (D + 1) + c] = ok ? kb[(k0 + j) * sk.s + c] : 0.f;
      Vs[j * D + c] = ok ? vb[(k0 + j) * sv.s + c] : 0.f;
    }
    __syncthreads();

    // scores of this thread's keys go to its own slots of P; the loop
    // over keys stays rolled so that each D instantiation compiles once
    float* prow = Ps + row * (BKV + 1);
    unsigned vis = 0u;
    float tmax = NEG;
#pragma unroll 1
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = sub + TPR * jj;
      const int kp = k0 + j;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) dot = fmaf(qr[c], Ks[j * (D + 1) + c], dot);
      const bool ok = visible(q_pos, kp, Sk, causal, window, prefix);
      const float s = ok ? dot * scale : NEG;
      vis |= ok ? (1u << jj) : 0u;
      prow[j] = s;
      tmax = fmaxf(tmax, s);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    const float m_new = fmaxf(m, tmax);
    float psum = 0.f;
#pragma unroll 4
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = sub + TPR * jj;
      const float p = (vis >> jj) & 1u ? expf(prow[j] - m_new) : 0.f;
      prow[j] = p;
      psum += p;
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    const float alpha = expf(m - m_new);
    l = alpha * l + psum;
    m = m_new;
    __syncwarp();  // the row's four threads wrote its P; all read it below

#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      const float p = prow[j];
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[i] = fmaf(p, Vs[j * D + sub + TPR * i], acc[i]);
    }
  }

  if (q_ok) {
    const float l_safe = fmaxf(l, 1e-30f);
    float* op = o + b * so.b + h * so.h + (long long)qi * so.s;
#pragma unroll
    for (int i = 0; i < DPT; ++i) op[sub + TPR * i] = acc[i] / l_safe;
    // the row's logsumexp of the scaled scores; -inf with no visible key
    if (lse != nullptr && sub == 0)
      lse[(long long)bh * Sq + qi] = l > 0.f ? m + logf(l) : -INFINITY;
  }
}

// --- bf16: tensor cores ----------------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int NST = 2;                  // stages of the K/V ring

// The key tiles that query rows i0 .. i1 (i1 < Sq) visit: [0, n_pre) then
// [lo, hi). The same arithmetic as key_tile_range in
// kernels/flash_attention.py, for a block's rows and for a warp's.
__device__ __forceinline__ void key_tiles(int i0, int i1, int Sq, int Sk,
                                          int causal, int window, int prefix,
                                          int& n_pre, int& lo, int& hi) {
  const int qf = i0 + Sk - Sq, ql = i1 + Sk - Sq;
  const int k_lo = window > 0 ? max(0, qf - window + 1) : 0;
  const int k_hi = causal ? min(Sk - 1, ql) : Sk - 1;
  const int p_end = prefix > 0 ? (min(prefix, Sk) + BKV - 1) / BKV : 0;
  int t_end = 0;
  lo = 0;
  if (k_hi >= k_lo) {
    lo = k_lo / BKV;
    t_end = k_hi / BKV + 1;
  }
  n_pre = min(p_end, lo);
  hi = max(t_end, p_end);
}

// False only when every (query, key) pair of the tile is visible to rows
// i0 .. i1 (tile_needs_mask in kernels/flash_attention.py).
__device__ __forceinline__ bool tile_needs_mask(int tile, int i0, int i1,
                                                int Sq, int Sk, int causal,
                                                int window, int prefix) {
  const int k0 = tile * BKV;
  if (k0 + BKV > Sk) return true;
  if (k0 + BKV <= prefix) return false;
  const int qf = i0 + Sk - Sq, ql = i1 + Sk - Sq;
  return (causal && k0 + BKV - 1 > qf) || (window > 0 && ql - k0 >= window);
}

// Copies of a [rows][D] bf16 tile between global rows (stride `gs`
// elements) and a shared tile of pitch D + 8, in 16-byte chunks: LPR lanes
// per row (the power of two at or above D / 8), 128 / LPR rows per pass;
// a lane whose chunk column is past D / 8 idles. Each thread keeps one
// chunk column and steps its row, so an address is one add per pass.
template <int D>
struct TileCopy {
  static constexpr int CH = D / 8;
  static constexpr int LPR =
      CH <= 2 ? 2 : CH <= 4 ? 4 : CH <= 8 ? 8 : CH <= 16 ? 16 : 32;
  static constexpr int RPP = MMA_THREADS / LPR;   // rows per pass
  int c, r0;
  bool active;
  __device__ explicit TileCopy(int t)
      : c(t % LPR), r0(t / LPR), active(t % LPR < CH) {}
};

// (Fragment layouts: tensor_core.cuh.)
//
// A work item is a block of BQ = 64 queries of one (b, h); items run in
// (b, h)-major order, so one (b, h)'s query blocks run together and read
// its keys and values from L2 after the first; within a (b, h) the causal
// blocks with the most key tiles come first. Warp w owns query rows
// 16w .. 16w + 15. Shared memory (dynamic): Q [BQ][D + 8], then NST stages
// of K and of V, each [BKV][D + 8]; step j of the block's key tiles uses
// stage j % NST, and its copies are in flight while step j - 1 is
// multiplied.
// blocks an SM that the register budget is set for: three (168 registers)
// up to D = 128; one (255) for the wide heads, whose accumulators alone
// take D / 2 registers
constexpr int min_blocks(int D) { return D <= 128 ? 3 : 1; }

template <int D>
__global__ void __launch_bounds__(MMA_THREADS, min_blocks(D))
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 Strides sq, Strides sk, Strides sv, Strides so, int H,
                 int Hkv, int Sq, int Sk, float scale_log2, int causal,
                 int window, int prefix) {
  constexpr int KD = D / 16;              // k-steps of Q.K^T
  constexpr int ND = D / 8;               // n-tiles of P.V
  constexpr int NK = BKV / 8;             // n-tiles of Q.K^T
  constexpr int DP = D + 8;               // row pitch (bf16 elements)
  using Copy = TileCopy<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * DP;
  __nv_bfloat16* Vs = Ks + NST * BKV * DP;

  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int nqb = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqb;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int bi0 = (nqb - 1 - blockIdx.x % nqb) * BQ;
  int n_pre, lo, hi;
  key_tiles(bi0, min(Sq, bi0 + BQ) - 1, Sq, Sk, causal, window, prefix,
            n_pre, lo, hi);
  const int n_vis = n_pre + hi - lo;
  const Copy cp(t);
  const __nv_bfloat16* kb = k + b * sk.b + hk * sk.h + 8 * cp.c;
  const __nv_bfloat16* vb = v + b * sv.b + hk * sv.h + 8 * cp.c;

  // the K and V copies of step idx into stage st: 16-byte pieces, each
  // thread one chunk column; rows past Sk are zero-filled
  auto issue = [&](int idx, int st) {
    if (!cp.active) return;
    const int tile = idx < n_pre ? idx : lo + idx - n_pre;
    const uint32_t kd = smem_u32(Ks + st * BKV * DP + 8 * cp.c);
    const uint32_t vd = smem_u32(Vs + st * BKV * DP + 8 * cp.c);
    int kp = tile * BKV + cp.r0;
    const __nv_bfloat16* ks_ = kb + (long long)kp * sk.s;
    const __nv_bfloat16* vs_ = vb + (long long)kp * sv.s;
#pragma unroll
    for (int i = 0; i < BKV / Copy::RPP; ++i) {
      const int r = cp.r0 + i * Copy::RPP;
      const int n = kp < Sk ? 16 : 0;
      cp_async<16>(kd + 2 * r * DP, n ? ks_ : kb, n);
      cp_async<16>(vd + 2 * r * DP, n ? vs_ : vb, n);
      kp += Copy::RPP;
      ks_ += Copy::RPP * sk.s;
      vs_ += Copy::RPP * sv.s;
    }
  };

  if (n_vis > 0) {
    if (cp.active) {
      const __nv_bfloat16* src = q + b * sq.b + h * sq.h + 8 * cp.c;
      for (int r = cp.r0; r < BQ; r += Copy::RPP) {
        const int qi = bi0 + r;
        const bool ok = qi < Sq;
        cp_async<16>(smem_u32(Qs + r * DP + 8 * cp.c),
                     src + (long long)(ok ? qi : 0) * sq.s, ok ? 16 : 0);
      }
    }
    issue(0, 0);
    cp_async_commit();
  }
  // a warp skips the tiles that its own rows do not need (causal: the far
  // side of the diagonal)
  const int wi0 = bi0 + 16 * warp, wi1 = min(Sq, wi0 + 16) - 1;
  int w_pre = 0, w_lo = 0, w_hi = 0;
  if (wi0 <= wi1)
    key_tiles(wi0, wi1, Sq, Sk, causal, window, prefix, w_pre, w_lo, w_hi);
  const int qp0 = wi0 + g + Sk - Sq;    // q_pos of the warp's row g
  const __nv_bfloat16* qw = Qs + 16 * warp * DP;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // running max (of scores times scale * log2 e) and sum of rows g, g + 8
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int idx = 0; idx < n_vis; ++idx) {
    cp_async_wait_all();
    __syncthreads();  // step idx has landed; step idx - 1 is read by all
    if (idx + 1 < n_vis) issue(idx + 1, (idx + 1) % NST);
    cp_async_commit();
    const int tile = idx < n_pre ? idx : lo + idx - n_pre;
    if (!(tile < w_pre || (tile >= w_lo && tile < w_hi))) continue;
    const int k0 = tile * BKV;
    const __nv_bfloat16* kt = Ks + (idx % NST) * BKV * DP;
    const __nv_bfloat16* vt = Vs + (idx % NST) * BKV * DP;

    // S = Q.K^T: K rows are keys with D contiguous, so ldmatrix gives B
    // fragments of two n-tiles; the k-steps outside, so that consecutive
    // products go to independent accumulators
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      uint32_t qa[4];
      ldsm_x4(qa, smem_u32(qw + (lane % 16) * DP + 16 * ks + 8 * (lane / 16)));
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, smem_u32(kt + (16 * np + lane % 8 + 8 * (lane / 16)) * DP +
                             16 * ks + 8 * ((lane / 8) % 2)));
        mma_bf16(s[2 * np], qa, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qa, bf[2], bf[3]);
      }
    }
    // masked pairs score -inf; interior tiles test nothing
    if (tile_needs_mask(tile, wi0, wi1, Sq, Sk, causal, window, prefix)) {
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * n + 2 * tq + (e & 1);
          if (!visible(qp0 + 8 * (e >> 1), kp, Sk, causal, window, prefix))
            s[n][e] = -INFINITY;
        }
      }
    }
    // online softmax in base 2: p = 2^(s * scale log2 e - m)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0 * scale_log2);
    const float mn1 = fmaxf(m1, mx1 * scale_log2);
    // a row with no visible key yet keeps m = -inf: offset 0 keeps p = 0
    const float o0 = mn0 == -INFINITY ? 0.f : mn0;
    const float o1 = mn1 == -INFINITY ? 0.f : mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      s[n][0] = ex2(fmaf(s[n][0], scale_log2, -o0));
      s[n][1] = ex2(fmaf(s[n][1], scale_log2, -o0));
      s[n][2] = ex2(fmaf(s[n][2], scale_log2, -o1));
      s[n][3] = ex2(fmaf(s[n][3], scale_log2, -o1));
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    // P, rounded to bf16, is the A operand of P.V, 16 keys a fragment
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    const float al0 = ex2(m0 - o0), al1 = ex2(m1 - o1);
    l0 = al0 * l0 + ps0;   // each lane's share; summed over the quad below
    l1 = al1 * l1 + ps1;
    m0 = mn0;
    m1 = mn1;
    // rescale O only when some row of the warp has a new maximum
    if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= al0;
        acc[n][1] *= al0;
        acc[n][2] *= al1;
        acc[n][3] *= al1;
      }
    }
    // O += P.V: V rows are keys with D contiguous, so ldmatrix.trans gives
    // B fragments of two n-tiles
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t bf[4];
        ldsm_x4_t(bf, smem_u32(vt + (16 * kk + lane % 8 + 8 * ((lane / 8) % 2)) *
                                        DP +
                               16 * dp + 8 * (lane / 16)));
        mma_bf16(acc[2 * dp], pa[kk], bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], pa[kk], bf[2], bf[3]);
      }
    }
  }

  // the row sums over the four lanes of each row; O through this warp's 16
  // rows of the Q tile (read only by this warp), then 16-byte stores
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  // the rows' logsumexp of the scaled scores, natural log: m is in base 2
  // (scores times scale * log2 e), so lse = (m + log2 l) ln 2; -inf for a
  // row with no visible key
  if (lse != nullptr && tq == 0) {
    const float ln2 = 0.6931471805599453f;
    float* lr = lse + (long long)bh * Sq + wi0 + g;
    if (wi0 + g < Sq) lr[0] = l0 > 0.f ? (m0 + log2f(l0)) * ln2 : -INFINITY;
    if (wi0 + g + 8 < Sq)
      lr[8] = l1 > 0.f ? (m1 + log2f(l1)) * ln2 : -INFINITY;
  }
  __nv_bfloat16* os = Qs + 16 * warp * DP;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = 8 * n + 2 * tq;
    *reinterpret_cast<uint32_t*>(os + g * DP + c) =
        pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * DP + c) =
        pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  cp_async_wait_all();
  __syncthreads();
  if (cp.active) {
    __nv_bfloat16* dst = o + b * so.b + h * so.h + 8 * cp.c;
    for (int r = cp.r0; r < BQ; r += Copy::RPP) {
      const int qi = bi0 + r;
      if (qi < Sq)
        *reinterpret_cast<uint4*>(dst + (long long)qi * so.s) =
            *reinterpret_cast<const uint4*>(Qs + r * DP + 8 * cp.c);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  Strides sq, sk, sv, so;
  int B, H, Hkv, Sq, Sk, causal, window, prefix;
  float scale;
};

template <int D>
int launch_f32(const Args& a, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BKV * (D + 1) + BKV * D + BQ * (BKV + 1));
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_simt_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  COVER(0, (long long)a.B * a.H, 1);
  COVER(1, a.Sq, BQ);
  LAUNCH((flash_simt_kernel<D>), grid, THREADS, smem, stream,
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.sq,
      a.sk, a.sv, a.so, a.H, a.Hkv, a.Sq, a.Sk, a.scale, a.causal, a.window,
      a.prefix);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const Args& a, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(__nv_bfloat16) * (D + 8) * (BQ + 2 * NST * BKV);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaError_t err2 = cudaFuncSetAttribute(
        flash_mma_kernel<D>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err2 != cudaSuccess) return static_cast<int>(err2);
    configured = true;
  }
  const long long items = (long long)a.B * a.H * ((a.Sq + BQ - 1) / BQ);
  if (items > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  COVER(0, (long long)a.B * a.H * a.Sq, BQ);
  LAUNCH((flash_mma_kernel<D>), static_cast<unsigned>(items), MMA_THREADS, smem, stream,
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.o), a.lse, a.sq, a.sk, a.sv, a.so, a.H,
      a.Hkv,
      a.Sq, a.Sk, a.scale * 1.4426950408889634f, a.causal, a.window,
      a.prefix);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const Args& a, cudaStream_t s) {
  if (dtype == 0) return launch_f32<D>(a, s);
  if (dtype == 1) return launch_bf16<D>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, H, Sq, D), k and v (B, Hkv, Sk, D), o (B, H, Sq, D): element
// (b, h, i, c) of each lies at base + b*st[0] + h*st[1] + i*st[2] + c, the
// strides (in elements) given for q, k, v, o in that order in st[12].
// dtype 0 is f32, 1 is bf16. D is one of 16, 32, 64, 80, 112, 128, 160,
// 192; H % Hkv == 0. lse, when not null, receives each row's logsumexp of
// the scaled scores as (B, H, Sq) contiguous f32 (-inf for a row with no
// visible key): what the backward (flash_attention_bwd.cu) recomputes P
// from. Returns cudaGetLastError() (cudaErrorInvalidValue for another D or
// dtype).
extern "C" int flash_attention_lse_launch(const void* q, const void* k,
                                          const void* v, void* o, float* lse,
                                          const long long* st, int dtype,
                                          int B, int H, int Hkv, int Sq,
                                          int Sk, int D, int causal,
                                          int window, int prefix,
                                          void* stream) {
  const Args a{q, k, v, o, lse,
               Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
               Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
               B, H, Hkv, Sq, Sk, causal, window, prefix,
               static_cast<float>(1.0 / sqrt(static_cast<double>(D)))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(dtype, a, s);
    case 32: return launch<32>(dtype, a, s);
    case 64: return launch<64>(dtype, a, s);
    case 80: return launch<80>(dtype, a, s);
    case 112: return launch<112>(dtype, a, s);
    case 128: return launch<128>(dtype, a, s);
    case 160: return launch<160>(dtype, a, s);
    case 192: return launch<192>(dtype, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same without the logsumexp (the signature of the variants under
// kernels/variants/, which kernels/compare.py times against this one).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* st, int dtype, int B,
                                      int H, int Hkv, int Sq, int Sk, int D,
                                      int causal, int window, int prefix,
                                      void* stream) {
  return flash_attention_lse_launch(q, k, v, o, nullptr, st, dtype, B, H,
                                    Hkv, Sq, Sk, D, causal, window, prefix,
                                    stream);
}
