// feature_hash: one launch runs a whole FE layer of hash/cross/mod ops.
//
// Replaces the TPU kernel src/repro/kernels/feature_hash/kernel.py::hash_layer
// (_hash_layer_kernel), the paper's per-layer meta-kernel for hash/cross
// feature extraction.
//
// Bound on the H100: bytes. Each op is a few 32-bit integer multiplies, xors
// and shifts plus one modulo, so a row costs far fewer ALU cycles than the
// HBM time of its K input and n_ops output words
// (K*N*4 + n_ops*N*4 bytes). At serving batch sizes (N = 512) the launch
// itself dominates, which is the paper's Table I point and why the whole
// layer is one launch.
//
// Design: one thread per row with a grid-stride loop over N. The static op
// program (at most kMaxOps ops of (kind, a, b, m)) is passed by value as a
// kernel parameter, so every thread reads it from the constant bank and no
// device copy of the program is made per call. Inputs are int32[K, N] and
// outputs int32[n_ops, N], both row-major, so the threads of a warp read
// and write neighbouring addresses of one column. Each input column is read
// from global memory once per op that uses it; repeated reads hit L1/L2.
//
// Semantics (held against the JAX plan under jit with x64 off):
//   cross: fmix32(uint32(a) * GOLDEN + fmix32(uint32(b))) % uint32(m)
//   hash:  fmix32(uint32(a)) % uint32(m)
//   mod:   signed int32 floor-mod of a by m (the compiler's sparse_ids mod),
//          not the TPU kernel's uint32 mod; the two agree on a >= 0.
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOps = 64;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // enough resident blocks to fill every SM

// op kinds (repro_torch/kernels/feature_hash/ops.py _KIND_CODES); 2 is mod
constexpr int32_t kCross = 0;
constexpr int32_t kHash = 1;

constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kGolden = 0x9E3779B9u;

struct Program {
  int4 ops[kMaxOps];  // (kind, a, b, m)
  int32_t n_ops;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= kC1;
  x ^= x >> 13;
  x *= kC2;
  x ^= x >> 16;
  return x;
}

__global__ void hash_layer_kernel(const int32_t* __restrict__ cols,
                                  int32_t* __restrict__ out, int64_t n,
                                  Program prog) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    for (int k = 0; k < prog.n_ops; ++k) {
      const int4 op = prog.ops[k];
      const int32_t a = __ldg(cols + op.y * n + i);
      int32_t r;
      if (op.x == kCross) {
        const uint32_t b = static_cast<uint32_t>(__ldg(cols + op.z * n + i));
        const uint32_t h = fmix32(static_cast<uint32_t>(a) * kGolden + fmix32(b));
        r = static_cast<int32_t>(h % static_cast<uint32_t>(op.w));
      } else if (op.x == kHash) {
        const uint32_t h = fmix32(static_cast<uint32_t>(a));
        r = static_cast<int32_t>(h % static_cast<uint32_t>(op.w));
      } else {  // mod
        r = a % op.w;
        if (r < 0) r += op.w;
      }
      out[k * n + i] = r;
    }
  }
}

}  // namespace

extern "C" {

// Host program: n_ops rows of (kind, a, b, m) as int32, validated by the
// Python wrapper (kinds, column indices in [0, K), 0 < m < 2**31).
int fbk_hash_layer(const int32_t* cols, int64_t n, const int32_t* program,
                   int32_t n_ops, int32_t* out, void* stream) {
  if (n_ops < 0 || n_ops > kMaxOps || n < 0) return cudaErrorInvalidValue;
  Program prog;
  std::memset(&prog, 0, sizeof(prog));
  std::memcpy(prog.ops, program, sizeof(int4) * n_ops);
  prog.n_ops = n_ops;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  hash_layer_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(cols, out, n, prog);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
