// Device helpers shared by the sequential-recurrence kernels (the f32
// routes of wkv6.cu, ssd.cu and of their backwards, wkv6_bwd.cu,
// ssd_bwd.cu). Each holds its state in registers, one column (or row) per
// group of four adjacent lanes, and stages each tile of steps in shared
// memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace recurrence {

// Element strides of a (B, H, T, ...) view with a contiguous last dim.
struct Strides {
  long long b, h, t;
};

// The strides of `n` tensors, packed as st[3 * i .. 3 * i + 2].
template <int n>
inline void unpack(const long long* st, Strides (&s)[n]) {
  for (int i = 0; i < n; ++i)
    s[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The backward sweeps' accumulation type: f64 for their f32 inputs, whose
// prefix sums over all of T cancel where the decay is strong (wkv6_bwd.cu's
// header). (bf16 inputs take the chunked routes, which sweep nothing.)
template <typename T>
struct Acc {
  using type = float;
};
template <>
struct Acc<float> {
  using type = double;
};

__device__ __forceinline__ float mad(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double mad(double a, double b, double c) {
  return fma(a, b, c);
}

// Sum over the four adjacent lanes that share one state column.
template <typename A>
__device__ __forceinline__ A quad_sum(A x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Sum over the 32 lanes of a warp.
template <typename A>
__device__ __forceinline__ A warp_sum(A x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

}  // namespace recurrence
