// embedding_bag: weighted-sum EmbeddingBag over a working-set table.
//
// Replaces the TPU kernel
// src/repro/kernels/embedding_bag/kernel.py::embedding_bag (_bag_kernel):
// from ids int32[B, L], weights f32[B, L] and table f32[U, D] it writes
// out[b, :] = sum_l weights[b, l] * table[ids[b, l], :] in f32[B, D]. A slot
// whose weight is 0 contributes nothing and its row is never loaded, so its
// id may be garbage. An id outside [0, U) with a non-zero weight also
// contributes 0 and is never dereferenced: that is what the TPU kernel's
// one-hot product gives (no vocab block matches it), where the JAX package's
// jnp.take oracle gives NaN for id >= U and wraps a negative id.
//
// Bound on the H100: bytes. Each slot's id and weight are read once
// (8 B), each non-zero slot reads one row (4 D B) and each bag writes one
// row (4 D B), for 2 D FLOP per non-zero slot: under 0.5 FLOP per byte.
//
// Design: the TPU kernel contracts a blocked one-hot matrix with the table
// on the MXU (256 bags x 512 rows per grid step), a TPU artifact that reads
// the whole table once per batch tile. Here the gather is direct: one warp
// per bag, lanes along D. For D a multiple of 4 (and 16-byte aligned
// pointers) each lane loads 16 bytes of the row at a time, so a warp reads
// 512 contiguous bytes per load; otherwise lanes stride over D one float at
// a time. Slots are accumulated in fp32 in order l = 0..L-1, one fused
// multiply-add per element. The slot's id and weight are read by every lane
// of the warp (one broadcast transaction).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const int32_t* __restrict__ ids, const float* __restrict__ w,
                     int64_t n_bags, int32_t bag_len, const float* __restrict__ table,
                     int64_t n_rows, int32_t dim, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= n_bags) return;
  const int32_t* bag_ids = ids + b * bag_len;
  const float* bag_w = w + b * bag_len;
  float* ob = out + b * dim;
  if constexpr (kVec) {
    // 128 columns per pass: 32 lanes x 4
    for (int32_t c = lane * 4; c < dim; c += 128) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int32_t l = 0; l < bag_len; ++l) {
        const float wl = __ldg(bag_w + l);
        const int32_t id = __ldg(bag_ids + l);
        if (wl == 0.f || id < 0 || id >= n_rows) continue;
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            table + static_cast<int64_t>(id) * dim + c));
        acc.x = fmaf(wl, v.x, acc.x);
        acc.y = fmaf(wl, v.y, acc.y);
        acc.z = fmaf(wl, v.z, acc.z);
        acc.w = fmaf(wl, v.w, acc.w);
      }
      *reinterpret_cast<float4*>(ob + c) = acc;
    }
  } else {
    for (int32_t c = lane; c < dim; c += 32) {
      float acc = 0.f;
      for (int32_t l = 0; l < bag_len; ++l) {
        const float wl = __ldg(bag_w + l);
        const int32_t id = __ldg(bag_ids + l);
        if (wl == 0.f || id < 0 || id >= n_rows) continue;
        acc = fmaf(wl, __ldg(table + static_cast<int64_t>(id) * dim + c), acc);
      }
      ob[c] = acc;
    }
  }
}

}  // namespace

extern "C" {

int fbk_embedding_bag(const int32_t* ids, const float* w, int64_t n_bags, int32_t bag_len,
                      const float* table, int64_t n_rows, int32_t dim, float* out,
                      void* stream) {
  if (n_bags < 0 || bag_len < 0 || n_rows < 0 || dim < 0) return cudaErrorInvalidValue;
  if (n_bags == 0 || dim == 0) return cudaSuccess;
  const int64_t blocks = (n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const bool vec = dim % 4 == 0 && (reinterpret_cast<uintptr_t>(table) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    embedding_bag_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        ids, w, n_bags, bag_len, table, n_rows, dim, out);
  } else {
    embedding_bag_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        ids, w, n_bags, bag_len, table, n_rows, dim, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
