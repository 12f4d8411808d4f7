// A variant of csrc/flash_attention.cu whose bf16 kernel runs both
// products on wgmma: kept so that compare.py can time it beside the kernel
// the package builds; the package never builds this file.
//
//   python3 src/repro_torch/kernels/compare.py --tree new=. \
//       --flash wgmma=new:src/repro_torch/kernels/variants/flash_attention_wgmma.cu
//
// Same interface and semantics as csrc/flash_attention.cu (its header says
// which): queries at the tail of the keys, causal / window / prefix masks,
// GQA, scale 1/sqrt(D), f32 (m, l, acc), 0 for rows with no visible key,
// keys past Sk masked. The bf16 kernel: one warpgroup (four warps) owns 64
// queries of one (b, h) and visits only the key tiles that hold a visible
// key (the rule of key_tile_range in kernels/flash_attention.py). Q, K and
// V arrive by 16-byte cp.async; S = Q.K^T is wgmma m64n64k16 with Q's A
// fragments from registers and K from shared memory in the canonical
// no-swizzle layout of 8-row x 16-byte core matrices; P.V is wgmma
// m64nDk16 with P from the S accumulators in registers and V read N-major
// (the transpose bit) from the same kind of layout. Each wgmma group is
// waited on before the softmax reads its results: no overlap of products
// and softmax, and no swizzled layouts. m64n64k16 with a transposed V at
// D = 64 gave wrong results past the first key tile; two n32 halves are
// right. The f32 kernel is the package's.

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

// The key tiles query block qb visits: [0, n_pre) then [lo, hi). The same
// arithmetic as key_tile_range in kernels/flash_attention.py.
__device__ __forceinline__ void key_tiles(int qb, int Sq, int Sk, int causal,
                                          int window, int prefix, int& n_pre,
                                          int& lo, int& hi) {
  const int qf = qb * BQ + Sk - Sq;
  const int ql = min(Sq, (qb + 1) * BQ) - 1 + Sk - Sq;
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

// False only when every (query, key) pair of the tile is visible to the
// block's rows (tile_needs_mask in kernels/flash_attention.py).
__device__ __forceinline__ bool tile_needs_mask(int tile, int qb, int Sq,
                                                int Sk, int causal,
                                                int window, int prefix) {
  const int k0 = tile * BKV;
  if (k0 + BKV > Sk) return true;
  if (k0 + BKV <= prefix) return false;
  const int qf = qb * BQ + Sk - Sq;
  const int ql = min(Sq, (qb + 1) * BQ) - 1 + Sk - Sq;
  return (causal && k0 + BKV - 1 > qf) || (window > 0 && ql - k0 >= window);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, asynchronously; src_bytes = 0 writes
// zeros (rows past the end) and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives element (l / 4, 2 (l % 4) .. + 1) of each, or with
// .trans element (2 (l % 4) .. + 1, l / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

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

// wgmma m64nNk16, f32 += bf16 x bf16: A (64 x 16) from registers in the
// mma.sync A layout per warp, B (16 x N) from shared memory by descriptor;
// TB = 1 reads B N-major (rows of K with N contiguous), 0 K-major.
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<64, 0>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rs<16, 1>(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rs<32, 1>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rs<64, 1>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rs<80, 1>(float (&d)[40],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rs<112, 1>(float (&d)[56],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rs<128, 1>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}


// S = Q.K^T and O += P.V by wgmma (one warpgroup, 64 query rows). Q comes
// from registers (ldmatrix from the padded row-major Q tile); K and V sit
// in shared memory in the canonical no-swizzle layout of 8-row x 16-byte
// core matrices, each 128 contiguous bytes:
//   K (K-major, B of S):  key j, dim c at (c / 8) KL + (j / 8) 128 + (j % 8) 16
//                         KL = BKV / 8 * 128 bytes (LBO), SBO = 128
//   V (N-major, B of PV): key j, dim c at (j / 8) VL + (c / 8) 128 + (j % 8) 16
//                         VL = D / 8 * 128 bytes (LBO), SBO = 128
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void fence_regs(float (&d)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int n>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[n][4]) {
#pragma unroll
  for (int i = 0; i < n; ++i)
    asm volatile("" : "+r"(d[i][0]), "+r"(d[i][1]), "+r"(d[i][2]),
                 "+r"(d[i][3])::"memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, Strides sq, Strides sk,
                 Strides sv, Strides so, int H, int Hkv, int Sq, int Sk,
                 float scale_log2, int causal, int window, int prefix,
                 int nst) {
  constexpr int KD = D / 16;              // k-steps of Q.K^T
  constexpr int DP = D + 8;               // Q row pitch (bf16 elements)
  constexpr int CH = D / 8;               // 16-byte chunks per row
  constexpr int TILE = BKV * D;           // K or V tile (bf16 elements)
  constexpr uint32_t KL = BKV / 8 * 128, VL = D / 8 * 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * DP;
  __nv_bfloat16* Vs = Ks + nst * TILE;

  const int nqb = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqb;
  const int qb = nqb - 1 - blockIdx.x % nqb;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int r0 = qb * BQ + warp * 16 + g;
  const int qp0 = r0 + Sk - Sq, qp1 = qp0 + 8;

  int n_pre, lo, hi;
  key_tiles(qb, Sq, Sk, causal, window, prefix, n_pre, lo, hi);
  const int n_vis = n_pre + hi - lo;

  const __nv_bfloat16* qb_ptr = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + hk * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + hk * sv.h;
  for (int e = t; e < BQ * CH; e += MMA_THREADS) {
    const int r = e / CH, c = e % CH;
    const int qi = qb * BQ + r;
    const bool ok = qi < Sq;
    cp_async16(smem_u32(Qs + r * DP + 8 * c),
               qb_ptr + (long long)(ok ? qi : 0) * sq.s + 8 * c, ok ? 16 : 0);
  }
  // thread pairs copy the two 16-byte halves of one 32-byte sector
  auto load_kv = [&](int idx) {
    const int tile = idx < n_pre ? idx : lo + idx - n_pre;
    const uint32_t kd = smem_u32(Ks + (idx % nst) * TILE);
    const uint32_t vd = smem_u32(Vs + (idx % nst) * TILE);
    for (int e = t; e < BKV * CH; e += MMA_THREADS) {
      const int j = (e / 2) % BKV, c = 2 * (e / (2 * BKV)) + e % 2;
      const int kp = tile * BKV + j;
      const bool ok = kp < Sk;
      const long long row = ok ? kp : 0;
      cp_async16(kd + c * KL + (j / 8) * 128 + (j % 8) * 16,
                 kb + row * sk.s + 8 * c, ok ? 16 : 0);
      cp_async16(vd + (j / 8) * VL + c * 128 + (j % 8) * 16,
                 vb + row * sv.s + 8 * c, ok ? 16 : 0);
    }
  };
  if (n_vis > 0) load_kv(0);
  cp_async_commit();

  uint32_t qa[KD][4];
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  for (int idx = 0; idx < n_vis; ++idx) {
    cp_async_wait_all();
    fence_proxy_async();  // the copies are visible to wgmma's reads
    __syncthreads();
    if (idx + 1 < n_vis) load_kv(idx + 1);
    cp_async_commit();
    if (idx == 0) {
#pragma unroll
      for (int ks = 0; ks < KD; ++ks)
        ldsm_x4(qa[ks], smem_u32(Qs + (warp * 16 + lane % 16) * DP +
                                 16 * ks + 8 * (lane / 16)));
    }
    const int tile = idx < n_pre ? idx : lo + idx - n_pre;
    const int k0 = tile * BKV;
    const uint32_t kt = smem_u32(Ks + (idx % nst) * TILE);
    const uint32_t vt = smem_u32(Vs + (idx % nst) * TILE);

    float s[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KD; ++ks)
      wgmma_rs<BKV, 0>(s, qa[ks], gmma_desc(kt + 2 * ks * KL, KL, 128),
                       ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // s[4n + e]: row g (e < 2) or g + 8, key 8n + 2tq + (e & 1)
    if (tile_needs_mask(tile, qb, Sq, Sk, causal, window, prefix)) {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int kp = k0 + 8 * (i / 4) + 2 * tq + (i & 1);
        if (!visible((i & 2) ? qp1 : qp0, kp, Sk, causal, window, prefix))
          s[i] = NEG;
      }
    }
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      if (s[i] != NEG) s[i] *= scale_log2;
      if (i & 2) mx1 = fmaxf(mx1, s[i]);
      else mx0 = fmaxf(mx0, s[i]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const float mn = (i & 2) ? mn1 : mn0;
      const float p = s[i] == NEG ? 0.f : exp2f(s[i] - mn);
      s[i] = p;
      if (i & 2) ps1 += p;
      else ps0 += p;
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, off);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, off);
    }
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    l0 = al0 * l0 + ps0;
    l1 = al1 * l1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? al1 : al0;
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const float* s0 = s + 8 * kk;     // n-tiles 2kk and 2kk + 1
      pa[kk][0] = pack_bf16(s0[0], s0[1]);
      pa[kk][1] = pack_bf16(s0[2], s0[3]);
      pa[kk][2] = pack_bf16(s0[4], s0[5]);
      pa[kk][3] = pack_bf16(s0[6], s0[7]);
    }
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      if constexpr (D == 64) {
        wgmma_rs<32, 1>(*reinterpret_cast<float(*)[16]>(acc), pa[kk],
                        gmma_desc(vt + 2 * kk * VL, VL, 128), 1);
        wgmma_rs<32, 1>(*reinterpret_cast<float(*)[16]>(acc + 16), pa[kk],
                        gmma_desc(vt + 2 * kk * VL + 512, VL, 128), 1);
      } else
      wgmma_rs<D, 1>(acc, pa[kk], gmma_desc(vt + 2 * kk * VL, VL, 128), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(pa);
  }

  cp_async_wait_all();
  __syncthreads();
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* os = Qs + warp * 16 * DP;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * tq;
    *reinterpret_cast<uint32_t*>(os + g * DP + c) =
        pack_bf16(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * DP + c) =
        pack_bf16(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
  }
  __syncwarp();
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
  for (int e = lane; e < 16 * CH; e += 32) {
    const int r = e / CH, c = e % CH;
    const int qi = qb * BQ + warp * 16 + r;
    if (qi < Sq)
      *reinterpret_cast<uint4*>(ob + (long long)qi * so.s + 8 * c) =
          *reinterpret_cast<const uint4*>(os + r * DP + 8 * c);
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
  constexpr size_t qbytes = sizeof(__nv_bfloat16) * BQ * (D + 8);
  constexpr size_t tbytes = sizeof(__nv_bfloat16) * BKV * D;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(qbytes + 4 * tbytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaError_t err2 = cudaFuncSetAttribute(
        flash_mma_kernel<D>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err2 != cudaSuccess) return static_cast<int>(err2);
    configured = true;
  }
  const int nst = a.Sk > BKV ? 2 : 1;
  const size_t smem = qbytes + 2 * nst * tbytes;
  const long long blocks = (long long)a.B * a.H * ((a.Sq + BQ - 1) / BQ);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  flash_mma_kernel<D><<<static_cast<unsigned>(blocks), MMA_THREADS, smem,
                        stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.o), a.sq, a.sk, a.sv, a.so, a.H, a.Hkv,
      a.Sq, a.Sk, a.scale * 1.4426950408889634f, a.causal, a.window,
      a.prefix, nst);
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
