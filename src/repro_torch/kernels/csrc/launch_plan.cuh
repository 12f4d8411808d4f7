// The launch plan of a source: what its launch function would launch, for
// one call's shapes, without launching it.
//
// Every kernel launch of a source goes through LAUNCH, which launches
// as <<<grid, block, smem, stream>>> would, or, between
// launch_plan_begin and launch_plan_end, records the instance instead:
// its kernel, grid, block and dynamic shared memory, the kernel's
// registers, static shared memory and local (spill) bytes from
// cudaFuncGetAttributes, and its blocks an SM from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor at that block and shared
// memory. A plan is the launch function itself called between the two,
// so the plan is the launch's own geometry and cannot drift from it
// (kernels/_build.py: planning). Device pointers are never read on the
// host, so a plan may be taken with tensors that hold anything.
//
// COVER(axis, extent, per_block), just before a LAUNCH, states the
// operand extent that the grid's axis walks (rows, (b, h) pairs, key
// slots, ...) and how much of it one block takes: analysis/pallas_rules.py
// (CUDA-GRID) holds grid[axis] * per_block to at least the extent, so no
// row is dropped.
#pragma once

#include <cuda_runtime.h>

#include <cstring>

struct PlanInstance {
  char name[160];         // mangled kernel name (or the LAUNCH text)
  int grid[3];
  int block[3];
  long long dyn_smem;     // bytes of dynamic shared memory a block
  long long cover_extent[3]; // COVER's extent per axis (0: none stated)
  long long cover_tile[3];   // COVER's per-block share per axis
  int static_smem;        // cudaFuncAttributes::sharedSizeBytes
  int regs;               // numRegs
  int local_bytes;        // localSizeBytes (spills, local arrays)
  int max_threads;        // maxThreadsPerBlock
  int max_dyn_smem;       // maxDynamicSharedSizeBytes (opted in)
  int blocks_per_sm;      // occupancy at this block and dyn_smem
  int status;             // cudaError_t of the queries
};

namespace launch_plan {

struct Sink {
  PlanInstance* out = nullptr;
  int cap = 0;
  int n = 0;
  long long extent[3] = {0, 0, 0}, tile[3] = {0, 0, 0};  // next COVER
};

inline Sink*& active() {
  static thread_local Sink* s = nullptr;
  return s;
}

inline Sink& storage() {
  static thread_local Sink s;
  return s;
}

inline void cover(int axis, long long extent, long long per_block) {
  if (Sink* s = active()) {
    s->extent[axis] = extent;
    s->tile[axis] = per_block;
  }
}

template <typename... KArgs>
void record(const char* text, void (*kernel)(KArgs...), dim3 grid,
            dim3 block, size_t smem) {
  Sink* s = active();
  if (s->n < s->cap) {
    PlanInstance& r = s->out[s->n];
    std::memset(&r, 0, sizeof r);
    const void* fn = reinterpret_cast<const void*>(kernel);
    const char* name = text;
#if CUDART_VERSION >= 12030
    const char* mangled = nullptr;
    if (cudaFuncGetName(&mangled, fn) == cudaSuccess && mangled != nullptr)
      name = mangled;
#endif
    std::strncpy(r.name, name, sizeof r.name - 1);
    r.grid[0] = static_cast<int>(grid.x);
    r.grid[1] = static_cast<int>(grid.y);
    r.grid[2] = static_cast<int>(grid.z);
    r.block[0] = static_cast<int>(block.x);
    r.block[1] = static_cast<int>(block.y);
    r.block[2] = static_cast<int>(block.z);
    r.dyn_smem = static_cast<long long>(smem);
    for (int i = 0; i < 3; ++i) {
      r.cover_extent[i] = s->extent[i];
      r.cover_tile[i] = s->tile[i];
    }
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, fn);
    if (err == cudaSuccess) {
      r.static_smem = static_cast<int>(a.sharedSizeBytes);
      r.regs = a.numRegs;
      r.local_bytes = static_cast<int>(a.localSizeBytes);
      r.max_threads = a.maxThreadsPerBlock;
      r.max_dyn_smem = a.maxDynamicSharedSizeBytes;
      int nb = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &nb, kernel, static_cast<int>(block.x * block.y * block.z), smem);
      r.blocks_per_sm = nb;
    }
    r.status = static_cast<int>(err);
    cudaGetLastError();  // a failed query is in the record, not sticky
  }
  s->n++;
  for (int i = 0; i < 3; ++i) s->extent[i] = s->tile[i] = 0;
}

template <typename... KArgs, typename... Args>
void launch(const char* text, void (*kernel)(KArgs...), dim3 grid,
            dim3 block, size_t smem, cudaStream_t stream, Args... args) {
  if (active() != nullptr) {
    record(text, kernel, grid, block, smem);
    return;
  }
  kernel<<<grid, block, smem, stream>>>(args...);
}

}  // namespace launch_plan

#define COVER(axis, extent, per_block) \
  launch_plan::cover((axis), (extent), (per_block))
#define LAUNCH(kernel, grid, block, smem, stream, ...) \
  launch_plan::launch(#kernel, kernel, grid, block, smem, stream, __VA_ARGS__)

// Record instead of launching until launch_plan_end, into out[0, cap).
extern "C" int launch_plan_begin(PlanInstance* out, int cap) {
  launch_plan::Sink& s = launch_plan::storage();
  s = launch_plan::Sink{};
  s.out = out;
  s.cap = cap;
  launch_plan::active() = &s;
  return 0;
}

// Launch again; returns the instances recorded (more than cap: some were
// not written).
extern "C" int launch_plan_end() {
  launch_plan::active() = nullptr;
  return launch_plan::storage().n;
}
