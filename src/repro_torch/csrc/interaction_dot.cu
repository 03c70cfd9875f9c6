// interaction_dot: DLRM pairwise-dot feature interaction, forward and backward.
//
// Replaces the TPU kernel
// src/repro/kernels/interaction_dot/kernel.py::dot_interaction
// (_interaction_kernel): from x f32[B, F, D] it writes f32[B, F(F-1)/2], the
// strictly-lower triangle of x x^T per row in np.tril_indices(F, -1) order
// (row-major: (1,0), (2,0), (2,1), (3,0), ...).
//
// Bound on the H100: bytes. A row moves F*D*4 bytes in and P*4 out
// (P = F(F-1)/2) for P*D FMAs; for dlrm-mlperf (F = 27, D = 128) that is
// 5.9 FLOP per byte, below the 20 FLOP/byte where the fp32 rate outside the
// tensor cores (67 TFLOP/s) would take over from HBM (3.35 TB/s).
//
// Design: the TPU kernel runs x x^T on the MXU and compacts the triangle
// with a gather; here nothing of the square is ever formed. Each block
// stages one row x[b] (13.8 KB for F = 27, D = 128) into shared memory with
// coalesced loads, then its threads stride over the P pairs and accumulate
// each dot over D in fp32 FMA, writing the compacted triangle directly. Rows
// are staged with a stride of D + 1 floats so the lanes of a warp, which
// read the same column k of different rows j, hit different banks.
//
// Backward (the TPU kernel has none; JAX differentiates the einsum): from x
// and dy f32[B, P] it writes dx[b, i, :] = sum_j G[b, i, j] x[b, j, :], where
// G is symmetric with G[i, j] = G[j, i] = dy[pair (i, j)] and a zero
// diagonal. Bound: bytes again (2 F D + P floats per row for 2 F F D flops,
// 6.2 flop/byte at F = 27, D = 128). One block per row stages x[b] and
// builds G from dy[b] in shared memory; each thread owns outputs (i, k),
// consecutive k across a warp, and loops over j: G[i, j] is a broadcast and
// x[j, k] a conflict-free row read, so rows need no padding here.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kDefaultSmem = 48 * 1024;

// p = i(i-1)/2 + j with 0 <= j < i: invert the triangular number, then
// correct the float estimate by at most a step either way.
__device__ __forceinline__ void pair_of(int p, int* i_out, int* j_out) {
  int i = static_cast<int>((1.0f + sqrtf(1.0f + 8.0f * p)) * 0.5f);
  while (i * (i - 1) / 2 > p) --i;
  while ((i + 1) * i / 2 <= p) ++i;
  *i_out = i;
  *j_out = p - i * (i - 1) / 2;
}

__global__ void dot_interaction_kernel(const float* __restrict__ x,
                                       float* __restrict__ out, int f, int d,
                                       int n_pairs) {
  extern __shared__ float tile[];  // f rows of d floats, row stride d + 1
  const int ld = d + 1;
  const int64_t b = blockIdx.x;
  const float* xb = x + b * f * d;
  for (int e = threadIdx.x; e < f * d; e += blockDim.x) {
    tile[(e / d) * ld + e % d] = __ldg(xb + e);
  }
  __syncthreads();
  float* ob = out + b * n_pairs;
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
    int i, j;
    pair_of(p, &i, &j);
    const float* ri = tile + i * ld;
    const float* rj = tile + j * ld;
    float acc = 0.0f;
    for (int k = 0; k < d; ++k) acc = fmaf(ri[k], rj[k], acc);
    ob[p] = acc;
  }
}

__global__ void dot_interaction_bwd_kernel(const float* __restrict__ x,
                                           const float* __restrict__ dy,
                                           float* __restrict__ dx, int f, int d,
                                           int n_pairs) {
  extern __shared__ float smem[];
  float* tile = smem;       // f rows of d floats
  float* g = smem + f * d;  // f x f symmetric pair gradients, zero diagonal
  const int64_t b = blockIdx.x;
  const float* xb = x + b * f * d;
  const float* dyb = dy + b * n_pairs;
  for (int e = threadIdx.x; e < f * d; e += blockDim.x) tile[e] = __ldg(xb + e);
  for (int e = threadIdx.x; e < f * f; e += blockDim.x) g[e] = 0.0f;
  __syncthreads();
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
    int i, j;
    pair_of(p, &i, &j);
    const float v = __ldg(dyb + p);
    g[i * f + j] = v;
    g[j * f + i] = v;
  }
  __syncthreads();
  float* dxb = dx + b * f * d;
  for (int e = threadIdx.x; e < f * d; e += blockDim.x) {
    const float* gi = g + (e / d) * f;
    const int k = e % d;
    float acc = 0.0f;
    for (int j = 0; j < f; ++j) acc = fmaf(gi[j], tile[j * d + k], acc);
    dxb[e] = acc;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

int fbk_dot_interaction(const float* x, int64_t b, int32_t f, int32_t d,
                        float* out, void* stream) {
  if (b < 0 || f < 2 || d < 1) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * static_cast<size_t>(f) * (d + 1);
  const cudaError_t err = allow_smem(dot_interaction_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_pairs = f * (f - 1) / 2;
  dot_interaction_kernel<<<static_cast<unsigned>(b), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(x, out, f, d,
                                                                n_pairs);
  return static_cast<int>(cudaGetLastError());
}

int fbk_dot_interaction_bwd(const float* x, const float* dy, int64_t b, int32_t f,
                            int32_t d, float* dx, void* stream) {
  if (b < 0 || f < 2 || d < 1) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (static_cast<size_t>(f) * d +
                                       static_cast<size_t>(f) * f);
  const cudaError_t err = allow_smem(dot_interaction_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_pairs = f * (f - 1) / 2;
  dot_interaction_bwd_kernel<<<static_cast<unsigned>(b), kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(x, dy, dx, f, d,
                                                                    n_pairs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
