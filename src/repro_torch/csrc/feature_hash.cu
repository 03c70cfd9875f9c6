// feature_hash: one launch runs a whole FE layer of hash/cross/mod ops.
//
// Replaces the TPU kernel src/repro/kernels/feature_hash/kernel.py::hash_layer
// (_hash_layer_kernel), the paper's per-layer meta-kernel for hash/cross
// feature extraction.
//
// Bound on the H100: bytes. Each op is a few 32-bit integer multiplies, xors
// and shifts plus one modulo, so a row costs fewer ALU cycles than the HBM
// time of its K input and n_ops output words (K*N*4 + n_ops*N*4 bytes).
//
// Design: ops x row tiles over the grid. blockIdx.y is the op and blockIdx.x
// a tile of kThreads * kRows = 1,024 rows, so every thread of a block runs
// the same op: the kernel branches once on the op's kind, uniformly, into a
// loop templated on it. Each thread takes kRows = 4 rows of its op per tile.
// Where n % 4 == 0 and the column block and the output are 16-byte aligned
// (a contiguous tensor's data_ptr() may carry a storage offset), its 4 rows
// are consecutive and move as one int4 load per input column and one 16-byte
// store: __stwb gives one STG.E.128, where a plain int4 assignment compiles
// to four 32-bit STG.E on sm_90a. Otherwise the 4 rows are kThreads apart and
// move as coalesced scalars. Index math is int64.
//
// The grid is at most one wave of resident blocks: blocks per op are capped
// at kWave / n_ops (kWave = 132 SMs x 8 blocks of 256 threads, the H100
// SXM's resident blocks at this kernel's 32 registers), spread evenly over
// the tiles, and each block strides over its tiles. So the ops of a layer
// work on neighbouring tiles at once, and a column that several ops read
// (column 0 of the dlrm crosses feeds 7 of 16) comes from HBM once and
// from the L2 after. The cap acts only past 66 tiles per op for the 16
// crosses (67,584 rows) and 105 for the 10 sparse ids (107,520 rows), a
// size no path runs (they run N = 512 and 8,192); it matters at large N,
// where the byte bound is read: without it, blocks run op after op, and at
// N = 2**20 such a column is read from HBM again by each op.
//
// Modulo: a run-time `%` by the op's field size. Its reciprocal depends on
// m alone: on the int4 path it is computed once per thread and tile and
// shared by the tile's 4 rows; on the scalar path once per row. The static
// op program (at most kMaxOps ops) is a __grid_constant__ kernel parameter
// read from the constant bank; no device copy is made per call.
//
// Launch floor: at the path's shape (N = 8,192: 8 tiles per op, 128 blocks
// for the 16 dlrm crosses and 80 for the 10 sparse ids) the layer's bytes
// take less time at HBM rate than one empty launch (chip_smoke.py phase 3
// times both), so there the launch sets the time; the byte bound is read
// at N = 2**20 with the inputs past the L2.
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
constexpr int kRows = 4;  // rows per thread and tile: one int4
constexpr int64_t kTile = static_cast<int64_t>(kThreads) * kRows;
constexpr int64_t kWave = 132 * 8;  // resident blocks: see the header

// op kinds (repro_torch/kernels/feature_hash/ops.py _KIND_CODES)
constexpr int32_t kCross = 0;
constexpr int32_t kHash = 1;
constexpr int32_t kMod = 2;

constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kGolden = 0x9E3779B9u;

struct Program {
  int4 ops[kMaxOps];  // (kind, a, b, m)
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= kC1;
  x ^= x >> 13;
  x *= kC2;
  x ^= x >> 16;
  return x;
}

template <int32_t kKind>
__device__ __forceinline__ int32_t apply(int32_t a, int32_t b, int32_t m) {
  if (kKind == kCross) {
    const uint32_t h = fmix32(static_cast<uint32_t>(a) * kGolden +
                              fmix32(static_cast<uint32_t>(b)));
    return static_cast<int32_t>(h % static_cast<uint32_t>(m));
  } else if (kKind == kHash) {
    return static_cast<int32_t>(fmix32(static_cast<uint32_t>(a)) % static_cast<uint32_t>(m));
  } else {
    const int32_t r = a % m;
    return r < 0 ? r + m : r;
  }
}

template <int32_t kKind, bool kVec>
__device__ __forceinline__ void run_op(const int32_t* __restrict__ a_col,
                                       const int32_t* __restrict__ b_col,
                                       int32_t* __restrict__ o, int64_t n, int32_t m) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kTile;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kTile; base < n; base += stride) {
    if (kVec) {  // n % 4 == 0, so a thread's 4 rows are all in or all out
      const int64_t i = base + static_cast<int64_t>(threadIdx.x) * kRows;
      if (i < n) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(a_col + i));
        const int4 b = kKind == kCross ? __ldg(reinterpret_cast<const int4*>(b_col + i)) : a;
        __stwb(reinterpret_cast<int4*>(o + i),
               make_int4(apply<kKind>(a.x, b.x, m), apply<kKind>(a.y, b.y, m),
                         apply<kKind>(a.z, b.z, m), apply<kKind>(a.w, b.w, m)));
      }
    } else {
      int32_t a[kRows], b[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int64_t i = base + j * kThreads + threadIdx.x;
        a[j] = i < n ? __ldg(a_col + i) : 0;
        b[j] = kKind == kCross && i < n ? __ldg(b_col + i) : 0;
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int64_t i = base + j * kThreads + threadIdx.x;
        if (i < n) o[i] = apply<kKind>(a[j], b[j], m);
      }
    }
  }
}

template <bool kVec>
__global__ void hash_layer_kernel(const int32_t* __restrict__ cols, int32_t* __restrict__ out,
                                  int64_t n, const __grid_constant__ Program prog) {
  const int4 op = prog.ops[blockIdx.y];
  const int32_t* a_col = cols + op.y * n;
  int32_t* o = out + static_cast<int64_t>(blockIdx.y) * n;
  if (op.x == kCross) {
    run_op<kCross, kVec>(a_col, cols + op.z * n, o, n, op.w);
  } else if (op.x == kHash) {
    run_op<kHash, kVec>(a_col, a_col, o, n, op.w);
  } else {
    run_op<kMod, kVec>(a_col, a_col, o, n, op.w);
  }
}

template <bool kVec>
cudaError_t launch(const int32_t* cols, int64_t n, const Program& prog, int32_t n_ops,
                   int32_t* out, cudaStream_t stream) {
  // one wave: at most kWave / n_ops blocks per op, over the fewest rounds
  // of tiles, spread evenly so no block takes a round more than most
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t cap = kWave / n_ops;
  const int64_t rounds = (tiles + cap - 1) / cap;
  const int64_t blocks = (tiles + rounds - 1) / rounds;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_ops));
  hash_layer_kernel<kVec><<<grid, kThreads, 0, stream>>>(cols, out, n, prog);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Host program: n_ops rows of (kind, a, b, m) as int32, validated by the
// Python wrapper (kinds, column indices in [0, K), 0 < m < 2**31).
int fbk_hash_layer(const int32_t* cols, int64_t n, const int32_t* program,
                   int32_t n_ops, int32_t* out, void* stream) {
  if (n_ops < 1 || n_ops > kMaxOps || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  Program prog;
  std::memset(&prog, 0, sizeof(prog));
  std::memcpy(prog.ops, program, sizeof(int4) * n_ops);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = n % kRows == 0 && reinterpret_cast<uintptr_t>(cols) % sizeof(int4) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % sizeof(int4) == 0;
  return static_cast<int>(vec ? launch<true>(cols, n, prog, n_ops, out, s)
                              : launch<false>(cols, n, prog, n_ops, out, s));
}

}  // extern "C"
