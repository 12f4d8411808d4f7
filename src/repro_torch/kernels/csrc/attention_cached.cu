// Attention over a KV cache with per-row positions, for Hopper (sm_90a).
//
// No TPU kernel stands behind this one: the reference computes it in XLA
// (`_sdpa_chunked` with `kv_positions` / `kv_valid`,
// src/repro/models/layers.py:126-176), on the decode and ring-buffer paths
// of `attention` (:204-256). The port's flash kernel cannot express it: its
// queries always sit at the tail of one shared key range and its rows have
// no per-row length. This kernel computes exactly
// `ref.attention_positions_ref`:
// * q (B, H, Sq, D), k and v (B, Hkv, Sk, D) views with any strides whose
//   last dimension is contiguous; q_pos (B, Sq) and kv_pos (B, Sk) int32.
// * Key slot j is visible to query i of row b when kv_pos[b, j] >= 0, and
//   rel = q_pos[b, i] - kv_pos[b, j] >= 0 if causal, and rel < window if
//   window > 0.
// * Scores, running max, sum and accumulator in f32 (no TF32, no bf16
//   products), scale 1/sqrt(D); GQA: q head h reads kv head h / G. The
//   output takes q's type. A row with no visible key comes out as 0.
//
// What bounds it on an H100: a decode step reads the valid K and V of every
// (b, kv head) once and does 4*G*D operations per key and kv head: at
// granite-3-2b's decode (B = 8, Hkv = 8, G = 4, D = 64, bf16) that is 8
// operations per byte, far under the ridge, so it is bound by bytes: 8.4 MB
// of K and V at a mean length of 512 take 2.5 us at 3.35 TB/s.
//
// Design (simple and right first; TMA and wgmma are later work):
// * One block of four warps takes up to ROWS = 16 rows of one (b, kv head):
//   row r is query head kvh*G + r / Sq at query r % Sq, so a decode block
//   serves all G query heads of its group and reads each K/V tile once for
//   them. The rows' queries sit in shared memory in f32, pre-scaled by
//   scale * log2(e) so the softmax runs in base 2.
// * The keys of a (b, kv head) are split into n_split ranges, one per
//   block (grid z), so that B*Hkv = 64 decode blocks still fill 132 SMs.
//   With n_split > 1 each block leaves its unnormalised accumulator and
//   its (m, l) in an f32 scratch, and `combine_kernel` merges the splits.
// * Per key tile of BK = 64 slots the block first reads the tile's kv_pos
//   and skips the tile when no slot can be visible to any of its rows
//   (empty slots, past the causal end, before the window): ragged rows do
//   not pay for their cache's empty tail. Then K and V arrive by 16-byte
//   loads, converted to f32 in shared memory (K's row pitch D + 1 keeps
//   the key-indexed score reads free of bank conflicts). Scores are one
//   (row, key) pair a thread; each warp owns rows for the online softmax
//   (warp shuffles); each thread keeps ROWS*D/128 output accumulators.
//
// Head dims: those the wrapper lists (64 for granite-3-2b and
// granite-moe, 112 for zamba2-7b's shared block, 128 for yi-34b, grok-1
// and granite-34b, 160 for pixtral-12b, 192 for nemotron-4-340b; 20 and 24
// accumulators a thread at the last two). The f32 staging at D = 192 is
// (16 * 192 + 64 * 193 + 64 * 192 + 16 * 64) * 4 bytes = 115 KB, above the
// 48 KB default: every instance opts in to its size. A group of G query
// heads makes G * Sq rows, so granite-34b's G = 48 (MQA) at decode runs
// three row blocks per (b, kv head). The wrapper checks 16-byte aligned
// K/V bases and strides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int ROWS = 16;     // query rows per block
constexpr int BK = 64;       // key slots per tile
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -INFINITY;

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of T as floats: 4 f32 or 8 bf16
__device__ __forceinline__ void unpack(const uint4& u, float* dst,
                                       const float*) {
  dst[0] = __uint_as_float(u.x);
  dst[1] = __uint_as_float(u.y);
  dst[2] = __uint_as_float(u.z);
  dst[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* dst,
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(p[e]);
    dst[2 * e] = f.x;
    dst[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
cached_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ q_pos,
              const int* __restrict__ kv_pos, T* __restrict__ o,
              float* __restrict__ part_acc, float* __restrict__ part_ml,
              Strides sq, Strides sk, Strides sv, Strides so, int H, int Hkv,
              int Sq, int Sk, int keys_per_split, int n_split, float qscale,
              int causal, int window) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int CH = D / VEC;           // 16-byte chunks per row
  constexpr int KP = D + 1;             // K's row pitch in shared memory
  constexpr int OPT = ROWS * D / THREADS;  // accumulators per thread
  static_assert(D % 8 == 0 && ROWS * D % THREADS == 0, "head dim");

  extern __shared__ float smem[];
  float* Qs = smem;                     // [ROWS][D]
  float* Ks = Qs + ROWS * D;            // [BK][D + 1]
  float* Vs = Ks + BK * KP;             // [BK][D]
  float* Ss = Vs + BK * D;              // [ROWS][BK]: scores, then P
  __shared__ int qp_s[ROWS];
  __shared__ int kvp_s[BK];
  __shared__ float m_s[ROWS], l_s[ROWS], alpha_s[ROWS];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int G = H / Hkv;
  const int R = G * Sq;
  const int r0 = blockIdx.y * ROWS;
  const int nrows = min(ROWS, R - r0);
  const int split = blockIdx.z;
  const int k_begin = split * keys_per_split;
  const int k_end = min(Sk, k_begin + keys_per_split);

  // the rows' queries, pre-scaled, and their positions
  for (int idx = tid; idx < ROWS * D; idx += THREADS) {
    const int row = idx / D, c = idx % D;
    float x = 0.f;
    if (row < nrows) {
      const int r = r0 + row;
      const int h = kvh * G + r / Sq, i = r % Sq;
      x = to_f(q[b * sq.b + h * sq.h + i * sq.s + c]) * qscale;
    }
    Qs[idx] = x;
  }
  if (tid < ROWS) {
    qp_s[tid] = tid < nrows ? q_pos[(long long)b * Sq + (r0 + tid) % Sq] : 0;
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  int qmin = qp_s[0], qmax = qp_s[0];
  for (int row = 1; row < nrows; ++row) {
    qmin = min(qmin, qp_s[row]);
    qmax = max(qmax, qp_s[row]);
  }

  float acc[OPT];
#pragma unroll
  for (int j = 0; j < OPT; ++j) acc[j] = 0.f;

  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  for (int kt = k_begin; kt < k_end; kt += BK) {
    const int nk = min(BK, k_end - kt);
    // the tile's slots: skip it when none can be visible to a row here
    int any = 0;
    if (tid < BK) {
      const int kp = tid < nk ? kv_pos[(long long)b * Sk + kt + tid] : -1;
      kvp_s[tid] = kp;
      any = kp >= 0 && (!causal || kp <= qmax) &&
            (window <= 0 || qmin - kp < window);
    }
    if (!__syncthreads_or(any)) continue;

    for (int idx = tid; idx < BK * CH; idx += THREADS) {
      const int key = idx / CH, c = idx % CH;
      float kf[VEC], vf[VEC];
      if (key < nk) {
        const uint4 ku = *reinterpret_cast<const uint4*>(
            kb + (long long)(kt + key) * sk.s + c * VEC);
        const uint4 vu = *reinterpret_cast<const uint4*>(
            vb + (long long)(kt + key) * sv.s + c * VEC);
        unpack(ku, kf, static_cast<const T*>(nullptr));
        unpack(vu, vf, static_cast<const T*>(nullptr));
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Ks[key * KP + c * VEC + e] = kf[e];
        Vs[key * D + c * VEC + e] = vf[e];
      }
    }
    __syncthreads();

    // scores: one (row, key) pair a thread at a time
    for (int p = tid; p < nrows * BK; p += THREADS) {
      const int row = p / BK, key = p % BK;
      const int kp = kvp_s[key];
      const int rel = qp_s[row] - kp;
      const bool vis = kp >= 0 && (!causal || rel >= 0) &&
                       (window <= 0 || rel < window);
      float s = NEG_INF;
      if (vis) {
        const float* qr = Qs + row * D;
        const float* kr = Ks + key * KP;
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 2) {
          a0 = fmaf(qr[d], kr[d], a0);
          a1 = fmaf(qr[d + 1], kr[d + 1], a1);
        }
        s = a0 + a1;
      }
      Ss[row * BK + key] = s;
    }
    __syncthreads();

    // online softmax, base 2: warp w owns rows w, w + 4, ...
    for (int row = warp; row < nrows; row += WARPS) {
      const float s0 = Ss[row * BK + lane], s1 = Ss[row * BK + lane + 32];
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      float p0 = 0.f, p1 = 0.f, a = 1.f;
      if (m_new != NEG_INF) {
        p0 = exp2f(s0 - m_new);       // exp2f(-inf) = 0
        p1 = exp2f(s1 - m_new);
        a = exp2f(m_old - m_new);
      }
      const float sum = warp_sum(p0 + p1);
      Ss[row * BK + lane] = p0;
      Ss[row * BK + lane + 32] = p1;
      if (lane == 0) {
        l_s[row] = l_s[row] * a + sum;
        m_s[row] = m_new;
        alpha_s[row] = a;
      }
    }
    __syncthreads();

    // P.V into the thread's accumulators
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      const int oi = tid + THREADS * j;
      const int row = oi / D, d = oi % D;
      if (row < nrows) {
        const float* pr = Ss + row * BK;
        float s = 0.f;
        for (int key = 0; key < nk; ++key)
          s = fmaf(pr[key], Vs[key * D + d], s);
        acc[j] = acc[j] * alpha_s[row] + s;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < OPT; ++j) {
    const int oi = tid + THREADS * j;
    const int row = oi / D, d = oi % D;
    if (row >= nrows) continue;
    const int r = r0 + row;
    const int h = kvh * G + r / Sq, i = r % Sq;
    if (n_split == 1) {
      const float l = l_s[row];
      from_f(o + b * so.b + h * so.h + i * so.s + d,
             l > 0.f ? acc[j] / l : 0.f);
    } else {
      const long long grow = ((long long)b * H + h) * Sq + i;
      const long long nr = (long long)gridDim.x / Hkv * H * Sq;
      part_acc[(split * nr + grow) * D + d] = acc[j];
      if (d == 0) {
        part_ml[(split * nr + grow) * 2] = m_s[row];
        part_ml[(split * nr + grow) * 2 + 1] = l_s[row];
      }
    }
  }
}

// merges the n_split partial results of one output row (b, h, i)
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ part_acc,
               const float* __restrict__ part_ml, T* __restrict__ o,
               Strides so, int H, int Sq, long long n_rows, int n_split) {
  const long long grow = blockIdx.x;
  const int b = static_cast<int>(grow / ((long long)H * Sq));
  const int h = static_cast<int>(grow / Sq % H);
  const int i = static_cast<int>(grow % Sq);
  float M = NEG_INF;
  for (int s = 0; s < n_split; ++s)
    M = fmaxf(M, part_ml[(s * n_rows + grow) * 2]);
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float L = 0.f, O = 0.f;
    if (M != NEG_INF) {
      for (int s = 0; s < n_split; ++s) {
        const float m = part_ml[(s * n_rows + grow) * 2];
        if (m == NEG_INF) continue;
        const float w = exp2f(m - M);
        L += w * part_ml[(s * n_rows + grow) * 2 + 1];
        O += w * part_acc[(s * n_rows + grow) * D + d];
      }
    }
    from_f(o + b * so.b + h * so.h + i * so.s + d, L > 0.f ? O / L : 0.f);
  }
}

struct Args {
  const void *q, *k, *v;
  const int *q_pos, *kv_pos;
  void* o;
  float *part_acc, *part_ml;
  Strides sq, sk, sv, so;
  int B, H, Hkv, Sq, Sk, causal, window, keys_per_split, n_split;
  float qscale;
};

template <typename T, int D>
int launch_t(const Args& a, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * (ROWS * D + BK * (D + 1) + BK * D + ROWS * BK);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        cached_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int R = a.H / a.Hkv * a.Sq;
  const dim3 grid(a.B * a.Hkv, (R + ROWS - 1) / ROWS, a.n_split);
  if (grid.y > 65535u || grid.z > 65535u)
    return static_cast<int>(cudaErrorInvalidValue);
  cached_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.q_pos, a.kv_pos, static_cast<T*>(a.o),
      a.part_acc, a.part_ml, a.sq, a.sk, a.sv, a.so, a.H, a.Hkv, a.Sq, a.Sk,
      a.keys_per_split, a.n_split, a.qscale, a.causal, a.window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return static_cast<int>(err);
  const long long n_rows = (long long)a.B * a.H * a.Sq;
  combine_kernel<T, D><<<static_cast<unsigned>(n_rows), THREADS, 0,
                         stream>>>(a.part_acc, a.part_ml,
                                   static_cast<T*>(a.o), a.so, a.H, a.Sq,
                                   n_rows, a.n_split);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const Args& a, cudaStream_t s) {
  if (dtype == 0) return launch_t<float, D>(a, s);
  if (dtype == 1) return launch_t<__nv_bfloat16, D>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, H, Sq, D), k and v (B, Hkv, Sk, D), o (B, H, Sq, D): element
// (b, h, i, c) of each lies at base + b*st[0] + h*st[1] + i*st[2] + c, the
// strides (in elements) given for q, k, v, o in that order in st[12].
// q_pos (B, Sq) and kv_pos (B, Sk) are contiguous int32. dtype 0 is f32,
// 1 is bf16; D is one of 16, 32, 64, 80, 112, 128, 160, 192;
// H % Hkv == 0. The keys
// split into n_split ranges of keys_per_split slots (a multiple of 64);
// with n_split > 1, part_acc holds n_split * B*H*Sq * D floats and part_ml
// n_split * B*H*Sq * 2, and a second kernel merges them into o.
// Returns cudaGetLastError() (cudaErrorInvalidValue for another D or dtype).
extern "C" int attention_cached_launch(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* kv_pos, void* o, float* part_acc, float* part_ml,
    const long long* st, int dtype, int B, int H, int Hkv, int Sq, int Sk,
    int D, int causal, int window, int keys_per_split, int n_split,
    void* stream) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const Args a{q, k, v, q_pos, kv_pos, o, part_acc, part_ml,
               Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
               Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
               B, H, Hkv, Sq, Sk, causal, window, keys_per_split, n_split,
               scale * 1.4426950408889634f};
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
