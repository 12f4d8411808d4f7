// Online-softmax attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention.py, `flash_attention`), with all of
// its semantics: queries at the tail of the keys (q_pos = i + Sk - Sq);
// causal, sliding `window` and bidirectional `prefix` masks; GQA (q head h
// reads kv head h / G); scale 1/sqrt(D); running (m, l, acc) in f32; rows
// with no visible key come out as 0. Keys past Sk are masked here, which
// the TPU kernel left to its callers' block sizes.
//
// What bounds it on an H100: at the encoder's shape (B=256, H=16, S=64,
// D=80, bf16) one call is 4*B*H*S*S*D = 5.4 GFLOP over 168 MB of q, k, v
// and o: 32 FLOP/byte, far under the bf16 tensor-core ridge (989 TFLOP/s /
// 3.35 TB/s = 295), so it is bound by bytes, ~50 us. The design reads q, k
// and v once and writes o once, and keeps S and P on chip.
//
// Two kernels, chosen by the input type:
// * bf16 (the encoder's path): tensor cores, mma.sync m16n8k16 with f32
//   accumulation. One block of four warps owns 64 queries of one (b, h);
//   each warp holds its 16 query rows as A fragments in registers for the
//   whole sweep. Per tile of 64 keys, K (row-major) and V (transposed) are
//   staged in shared memory with rows padded so every 32-bit fragment load
//   is free of bank conflicts; S = Q.K^T stays in the accumulators, the
//   row max and sum are shuffles across the four lanes that share a row,
//   and P goes from the S accumulators straight into the A fragments of
//   P.V. Q.K^T is exact against the reference's upcast product. P is
//   rounded to bf16 for P.V while l sums the unrounded P: that adds at
//   most 2^-9 * max|v| to each output (about 0.4% of the largest |v|),
//   well inside the 5e-2 bf16 tolerance.
// * f32: CUDA cores, f32 throughout (no TF32). Four threads share one
//   query row: each scores 16 of the tile's 64 keys with the row's query
//   in registers and owns D/4 of the output columns.
//
// Head dims: 16, 32, 64, 80 (hubert-xlarge), 112 (zamba2-7b's shared causal
// block: seven k-steps of 16 and fourteen n-tiles of 8) and 128.
//
// Layout: q, k, v and o are (B, heads, S, D) views with any strides whose
// last dimension is contiguous, so the encoder passes (B, S, H, D) tensors
// transposed in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

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
             const float* __restrict__ v, float* __restrict__ o, Strides sq,
             Strides sk, Strides sv, Strides so, int H, int Hkv, int Sq,
             int Sk, float scale, int causal, int window, int prefix) {
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
  }
}

// --- bf16: tensor cores ----------------------------------------------------

constexpr int MMA_WARPS = 4;            // 16 query rows each: BQ = 64
constexpr int MMA_THREADS = 32 * MMA_WARPS;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layouts of mma.m16n8k16 (lane = 4*g + t): A (16x16, rows =
// queries or P rows) a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
// a3 = (g+8, 2t+8..); B (16x8, k x n) b0 = (2t..2t+1, g), b1 = (2t+8.., g);
// C (16x8) c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1).
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, Strides sq, Strides sk,
                 Strides sv, Strides so, int H, int Hkv, int Sq, int Sk,
                 float scale, int causal, int window, int prefix) {
  constexpr int KD = D / 16;              // k-steps of Q.K^T
  constexpr int ND = D / 8;               // n-tiles of P.V
  constexpr int NK = BKV / 8;             // n-tiles of Q.K^T
  constexpr int DP = D + 8;               // K row pitch (bf16 elements)
  constexpr int KP = BKV + 8;             // V^T row pitch
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV * DP];
  __shared__ __align__(16) __nv_bfloat16 Vt[D * KP];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int r0 = blockIdx.y * BQ + warp * 16 + g;   // this lane's rows:
  const int r1 = r0 + 8;                            // r0 and r0 + 8
  const int qp0 = r0 + Sk - Sq, qp1 = r1 + Sk - Sq;

  // the warp's 16 query rows as A fragments, for the whole key sweep
  uint32_t qa[KD][4];
  const __nv_bfloat16* q0 = q + b * sq.b + h * sq.h + (long long)r0 * sq.s;
  const __nv_bfloat16* q1 = q + b * sq.b + h * sq.h + (long long)r1 * sq.s;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int ks = 0; ks < KD; ++ks) {
    const int c = 16 * ks + 2 * tq;
    __nv_bfloat162 v00{zero, zero}, v10{zero, zero}, v01{zero, zero},
        v11{zero, zero};
    if (r0 < Sq) {
      v00 = __nv_bfloat162{q0[c], q0[c + 1]};
      v01 = __nv_bfloat162{q0[c + 8], q0[c + 9]};
    }
    if (r1 < Sq) {
      v10 = __nv_bfloat162{q1[c], q1[c + 1]};
      v11 = __nv_bfloat162{q1[c + 8], q1[c + 9]};
    }
    qa[ks][0] = *reinterpret_cast<uint32_t*>(&v00);
    qa[ks][1] = *reinterpret_cast<uint32_t*>(&v10);
    qa[ks][2] = *reinterpret_cast<uint32_t*>(&v01);
    qa[ks][3] = *reinterpret_cast<uint32_t*>(&v11);
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  const __nv_bfloat16* kb = k + b * sk.b + hk * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + hk * sv.h;

  for (int k0 = 0; k0 < Sk; k0 += BKV) {
    __syncthreads();  // the previous tile's K and V reads are done
    for (int e = t; e < BKV * D; e += MMA_THREADS) {
      const int j = e / D, c = e % D;
      const bool ok = k0 + j < Sk;
      Ks[j * DP + c] = ok ? kb[(k0 + j) * sk.s + c] : zero;
      Vt[c * KP + j] = ok ? vb[(k0 + j) * sv.s + c] : zero;
    }
    __syncthreads();

    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (8 * n + g) * DP + 2 * tq;
#pragma unroll
      for (int ks = 0; ks < KD; ++ks)
        mma_bf16(s[n], qa[ks], pair(kr + 16 * ks), pair(kr + 16 * ks + 8));
    }
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * n + 2 * tq + (e & 1);
        const bool ok = visible(e < 2 ? qp0 : qp1, kp, Sk, causal, window,
                                prefix);
        s[n][e] = ok ? s[n][e] * scale : NEG;
        if (e < 2) mx0 = fmaxf(mx0, s[n][e]);
        else mx1 = fmaxf(mx1, s[n][e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked score is exactly NEG; exp of it is 0 against any real
        // row max, and a row with no visible key keeps p = 0 below
        const float mn = e < 2 ? mn0 : mn1;
        const float p = s[n][e] == NEG ? 0.f : expf(s[n][e] - mn);
        s[n][e] = p;
        if (e < 2) ps0 += p;
        else ps1 += p;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, off);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, off);
    }
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    l0 = al0 * l0 + ps0;
    l1 = al1 * l1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }
    // P (the S accumulators) is the A operand of P.V, 16 keys at a time
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vr = Vt + (8 * n + g) * KP + 16 * kk + 2 * tq;
        mma_bf16(acc[n], pa, pair(vr), pair(vr + 8));
      }
    }
  }

  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* o0 = o + b * so.b + h * so.h + (long long)r0 * so.s;
  __nv_bfloat16* o1 = o + b * so.b + h * so.h + (long long)r1 * so.s;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = 8 * n + 2 * tq;
    if (r0 < Sq) {
      o0[c] = __float2bfloat16_rn(acc[n][0] * inv0);
      o0[c + 1] = __float2bfloat16_rn(acc[n][1] * inv0);
    }
    if (r1 < Sq) {
      o1[c] = __float2bfloat16_rn(acc[n][2] * inv1);
      o1[c + 1] = __float2bfloat16_rn(acc[n][3] * inv1);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
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
  flash_simt_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.sq, a.sk,
      a.sv, a.so, a.H, a.Hkv, a.Sq, a.Sk, a.scale, a.causal, a.window,
      a.prefix);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ);
  flash_mma_kernel<D><<<grid, MMA_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.o), a.sq, a.sk, a.sv, a.so, a.H, a.Hkv,
      a.Sq, a.Sk, a.scale, a.causal, a.window, a.prefix);
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
// dtype 0 is f32, 1 is bf16. D is one of 16, 32, 64, 80, 112, 128;
// H % Hkv == 0.
// Returns cudaGetLastError() (cudaErrorInvalidValue for another D or dtype).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* st, int dtype, int B,
                                      int H, int Hkv, int Sq, int Sk, int D,
                                      int causal, int window, int prefix,
                                      void* stream) {
  const Args a{q, k, v, o,
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
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
