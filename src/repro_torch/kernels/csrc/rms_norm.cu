// RMS norm of rows, optionally times a SiLU gate, in one pass, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the reference's `rms_norm`
// (src/repro/models/layers.py) and Mamba2's gated norm `rms_norm(y, gn) *
// silu(z)` (src/repro/models/mamba2.py) are jnp expressions that XLA fuses
// into one pass over a row. Run eagerly (kernels/ref.py, rms_norm_ref) the
// same expression is eight launches and about 40 bytes of traffic an
// element: x to f32, x^2, the mean, + eps, rsqrt, x * r, * gamma, the cast;
// the gate adds silu(z) and the product. Per row of width d:
//
//     n   = T((x * rsqrt(mean(x^2) + eps)) * gamma)       (f32 inside)
//     out = n                                              (no gate)
//     out = T(n * T(z / (1 + exp(-z))))                    (gated)
//
// rounding where the plain expression rounds (T is x's type: bf16 or f32);
// only the order of the sum of squares differs.
//
// What bounds it on an H100: bytes. bf16 x in and out is 4 bytes an
// element (6 with the gate's z), against 3.35 TB/s: hubert-xlarge's
// (16384, 1280) is 84 MB, 25 us; zamba2-7b's (32768, 3584) 470 MB, 140 us,
// and its gated (32768, 7168) 1.41 GB, 420 us. gamma (d values) is read by
// every row from L2.
//
// Design: one row is read once, in 16-byte loads (8 bf16 or 4 f32 values;
// one value a load where a pointer, a row stride or d does not allow it),
// and kept in registers as f32, CH vectors a thread, or, for rows wider
// than 1024 threads hold that way, in shared memory. Each thread sums its
// squares in f32; the row's lanes add theirs by warp shuffles, and a row of
// several warps adds the warps' sums through shared memory. The row is then
// scaled and written once, in x's type; the gate reads z once in the same
// pass, through its own row stride (a split view of the in-projection, no
// copy). A block holds rpb rows of tpr threads each (tpr a power of two,
// 32..1024; a row never shares a warp): the launch plan is a function of d
// and the row count alone (kernels/rms_norm.py, launch_plan).

#include "recurrence.cuh"
#include "launch_plan.cuh"

#include <cstdint>

namespace {

constexpr int CH = 4;              // vectors a thread keeps in registers
constexpr int MAX_THREADS = 1024;

using recurrence::from_f32;
using recurrence::to_f32;
using recurrence::warp_sum;

// VEC values at p as f32: one 16-byte load when VEC values fill 16 bytes
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&o)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = to_f32(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_f32<T>(v[i]);
  }
}

// v as the plain expression leaves it: rounded to T
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return to_f32(from_f32<T>(v));
}

// The VEC outputs of vector i of a row: the normalised values a (f32), r
// the row's rsqrt, the gate's row zr or null.
template <typename T, int VEC, bool GATE>
__device__ __forceinline__ void finish(const float (&a)[VEC], float r,
                                       const T* __restrict__ gamma,
                                       const T* __restrict__ zr,
                                       T* __restrict__ orow, int i) {
  float g[VEC], o[VEC];
  load<T, VEC>(gamma + i * VEC, g);
#pragma unroll
  for (int e = 0; e < VEC; ++e) o[e] = __fmul_rn(__fmul_rn(a[e], r), g[e]);
  if constexpr (GATE) {
    float zz[VEC];
    load<T, VEC>(zr + i * VEC, zz);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float s = rounded<T>(zz[e] / (1.f + expf(-zz[e])));
      o[e] = __fmul_rn(rounded<T>(o[e]), s);
    }
  }
  store<T, VEC>(orow + i * VEC, o);
}

// Row `row` of x (rows, d) at x + row * x_row, of z at z + row * z_row, of
// out (contiguous) at out + row * d. SMEM: the row waits in dynamic shared
// memory (rpb * d floats), else in CH vectors of registers a thread.
template <typename T, int VEC, bool SMEM, bool GATE>
__global__ void __launch_bounds__(MAX_THREADS)
rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                const T* __restrict__ z, T* __restrict__ out,
                long long rows, int d, long long x_row, long long z_row,
                int tpr, float eps) {
  extern __shared__ float srow[];
  __shared__ float part[MAX_THREADS / 32];
  const int t = threadIdx.x % tpr;      // the thread's place in its row
  const int slot = threadIdx.x / tpr;   // the row's place in the block
  const long long row = (long long)blockIdx.x * (blockDim.x / tpr) + slot;
  const bool live = row < rows;
  const int nvec = d / VEC;
  const T* xr = x + (live ? row : 0) * x_row;
  float* sr = srow + (long long)slot * d;

  float v[SMEM ? 1 : CH][VEC];
  float ss = 0.f;
  if (live) {
    if constexpr (SMEM) {
      for (int i = t; i < nvec; i += tpr) {
        float a[VEC];
        load<T, VEC>(xr + (long long)i * VEC, a);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ss = fmaf(a[e], a[e], ss);
          sr[i * VEC + e] = a[e];
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int i = t + c * tpr;
        if (i < nvec) load<T, VEC>(xr + (long long)i * VEC, v[c]);
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (t + c * tpr < nvec) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) ss = fmaf(v[c][e], v[c][e], ss);
        }
      }
    }
  }
  // the row's sum: its lanes, then (tpr > 32) its warps
  ss = warp_sum(ss);
  if (tpr > 32) {
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
    __syncthreads();
    const int w0 = slot * (tpr >> 5);
    ss = 0.f;
    for (int w = 0; w < (tpr >> 5); ++w) ss += part[w0 + w];
  }
  if (!live) return;
  // mean, + eps, rsqrt: each rounded as the plain expression rounds it
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.f / d), eps));
  T* orow = out + row * d;
  const T* zr = GATE ? z + row * z_row : nullptr;
  if constexpr (SMEM) {
    for (int i = t; i < nvec; i += tpr) {
      float a[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) a[e] = sr[i * VEC + e];
      finish<T, VEC, GATE>(a, r, gamma, zr, orow, i);
    }
  } else {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int i = t + c * tpr;
      if (i < nvec) finish<T, VEC, GATE>(v[c], r, gamma, zr, orow, i);
    }
  }
}

template <typename T, int VEC, bool SMEM, bool GATE>
int launch(const void* x, const void* gamma, const void* z, void* out,
           long long rows, int d, long long x_row, long long z_row, int tpr,
           int rpb, float eps, cudaStream_t s) {
  const int smem = SMEM ? static_cast<int>(sizeof(float)) * rpb * d : 0;
  static int allowed = 48 * 1024;  // dynamic shared memory without opting in
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        rms_norm_kernel<T, VEC, SMEM, GATE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  const long long blocks = (rows + rpb - 1) / rpb;
  COVER(0, rows, rpb);
  LAUNCH((rms_norm_kernel<T, VEC, SMEM, GATE>),
         dim3(static_cast<unsigned>(blocks)), tpr * rpb, smem, s,
         static_cast<const T*>(x), static_cast<const T*>(gamma),
         static_cast<const T*>(z), static_cast<T*>(out), rows, d, x_row,
         z_row, tpr, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_mode(int smem, const void* x, const void* gamma, const void* z,
                void* out, long long rows, int d, long long x_row,
                long long z_row, int tpr, int rpb, float eps,
                cudaStream_t s) {
  const bool gate = z != nullptr;
  if (smem)
    return gate ? launch<T, VEC, true, true>(x, gamma, z, out, rows, d, x_row, z_row, tpr, rpb, eps, s)
                : launch<T, VEC, true, false>(x, gamma, z, out, rows, d, x_row, z_row, tpr, rpb, eps, s);
  return gate ? launch<T, VEC, false, true>(x, gamma, z, out, rows, d, x_row, z_row, tpr, rpb, eps, s)
              : launch<T, VEC, false, false>(x, gamma, z, out, rows, d, x_row, z_row, tpr, rpb, eps, s);
}

}  // namespace

// x (rows, d) with row stride x_row and contiguous rows; gamma (d,); z
// (rows, d) with row stride z_row, or null for no gate; out (rows, d)
// contiguous. dtype 0 is f32, 1 is bf16 (all four tensors). vec 1: 16-byte
// loads (every pointer and row stride 16-byte aligned, d a multiple of
// 16 bytes' values), 0: one value a load. tpr (threads a row) a power of
// two from 32 to 1024, rpb rows a block, tpr * rpb <= 1024; smem 0 needs
// d <= CH * tpr vectors, smem 1 takes rpb * d floats of shared memory.
// Returns cudaGetLastError() (cudaErrorInvalidValue for another plan).
extern "C" int rms_norm_launch(const void* x, const void* gamma,
                               const void* z, void* out, long long rows,
                               int d, long long x_row, long long z_row,
                               int dtype, int vec, int tpr, int rpb, int smem,
                               float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = vec ? (dtype == 1 ? 8 : 4) : 1;
  if (rows < 1 || d < 1 || tpr < 32 || tpr > MAX_THREADS || (tpr & (tpr - 1))
      || rpb < 1 || tpr * rpb > MAX_THREADS || d % width
      || (!smem && d / width > CH * tpr) || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return vec ? launch_mode<__nv_bfloat16, 8>(smem, x, gamma, z, out, rows, d, x_row, z_row, tpr, rpb, eps, s)
               : launch_mode<__nv_bfloat16, 1>(smem, x, gamma, z, out, rows, d, x_row, z_row, tpr, rpb, eps, s);
  return vec ? launch_mode<float, 4>(smem, x, gamma, z, out, rows, d, x_row, z_row, tpr, rpb, eps, s)
             : launch_mode<float, 1>(smem, x, gamma, z, out, rows, d, x_row, z_row, tpr, rpb, eps, s);
}
