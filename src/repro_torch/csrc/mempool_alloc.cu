// mempool_alloc: the paper's Alg. 1 (in-kernel dynamic memory allocation),
// in its deterministic form.
//
// Replaces the TPU kernel
// src/repro/kernels/mempool_alloc/kernel.py::alloc_offsets (_alloc_kernel):
// from sizes int32[N] it writes offsets int32[N] and head int32[1]. Each size
// is aligned up to `align` (floor division, as jnp's //), an exclusive scan
// gives the offsets, and the head (the pool's idle_memory_head after the
// bump) is carried across tiles. All sums wrap in 32 bits, as the int32
// jnp.cumsum of the reference does, so the result equals
// alloc_offsets_ref bit for bit for every input.
//
// Bound on the H100: launch latency at the device feed's N = 5; bytes at
// large N (4 bytes read and 4 written per request). The single block below
// walks the tiles one after another, so at N = 10^6 it runs far above the
// byte bound: simple and exact first (a decoupled look-back over many blocks
// is the faster form).
//
// Design: the TPU kernel runs its grid sequentially and carries the head in
// SMEM scratch from one grid step to the next. Blocks on Hopper run in no
// order, so one block of 1024 threads walks the requests in tiles of
// 1024 x 8 in order and carries the head in a register. Each thread owns 8
// consecutive requests: it aligns and sums them, a block-wide exclusive scan
// of the per-thread sums (warp shuffles, then one warp scans the 32 warp
// totals) gives its base, and it writes its 8 offsets. Tail lanes past N are
// masked to size 0. The paper's atomic-head form, whose order across blocks
// is not fixed, is not built here.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 8;
constexpr int kWarps = kThreads / 32;  // 32: one warp scans the warp totals

// (s + (align - 1)) // align * align in wrapping int32 arithmetic with floor
// division, exactly as the reference computes it.
__device__ __forceinline__ uint32_t align_up(int32_t s, int32_t align) {
  const int32_t t = static_cast<int32_t>(static_cast<uint32_t>(s) +
                                         static_cast<uint32_t>(align - 1));
  int32_t q = t / align;
  if (t % align != 0 && t < 0) --q;  // C++ truncates; the reference floors
  return static_cast<uint32_t>(q) * static_cast<uint32_t>(align);
}

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t up = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += up;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
alloc_offsets_kernel(const int32_t* __restrict__ sizes, int64_t n, int32_t align,
                     int32_t* __restrict__ offsets, int32_t* __restrict__ head) {
  __shared__ uint32_t warp_base[kWarps];
  __shared__ uint32_t tile_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t base = 0;  // idle_memory_head before this tile's bump
  for (int64_t tile = 0; tile < n; tile += static_cast<int64_t>(kThreads) * kItems) {
    const int64_t first = tile + static_cast<int64_t>(threadIdx.x) * kItems;
    uint32_t aligned[kItems];
    uint32_t sum = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = first + k;
      aligned[k] = i < n ? align_up(__ldg(sizes + i), align) : 0u;
      sum += aligned[k];
    }
    const uint32_t incl = warp_inclusive_scan(sum, lane);
    if (lane == 31) warp_base[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const uint32_t w = warp_base[lane];
      const uint32_t w_incl = warp_inclusive_scan(w, lane);
      warp_base[lane] = w_incl - w;  // exclusive prefix of the warp totals
      if (lane == 31) tile_total = w_incl;
    }
    __syncthreads();
    uint32_t run = base + warp_base[warp] + (incl - sum);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = first + k;
      if (i < n) offsets[i] = static_cast<int32_t>(run);
      run += aligned[k];
    }
    base += tile_total;  // atomic_add(idle_memory_head, prefix_N), in order
    __syncthreads();     // warp_base and tile_total are rewritten next tile
  }
  if (threadIdx.x == 0) head[0] = static_cast<int32_t>(base);
}

}  // namespace

extern "C" {

int fbk_alloc_offsets(const int32_t* sizes, int64_t n, int32_t align,
                      int32_t* offsets, int32_t* head, void* stream) {
  if (n < 0 || align <= 0) return cudaErrorInvalidValue;
  alloc_offsets_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sizes, n, align, offsets, head);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
