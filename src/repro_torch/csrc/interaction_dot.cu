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
// Forward design. The TPU kernel runs x x^T on the MXU and compacts the
// triangle with a gather; here nothing of the square is formed. A block
// takes one row b and stages x[b] into shared memory (chunks of up to 128
// columns, float4 loads), then each thread owns a 4 x 4 tile of pairs and
// runs the whole k range for its 16 outputs: per 4 columns it reads 8
// float4s (4 fields of each side) and does 64 FMAs, 0.125 shared loads per
// FMA, against 2 in the first design (one pair per thread at a time, both
// operands of each FMA from shared memory: some 174,000 shared wavefronts
// per SM at B = 8,192, 0.134 ms). F is covered by T = ceil(F/4) tile rows;
// a tile's 4 fields are strided, t, t + T, t + 2T, t + 3T, so that the T
// tiles that one read reaches hit T consecutive fields, and a row stride of
// an odd number of float4s puts those in distinct banks. Tile (ti, tj),
// ti >= tj, holds the pairs of fields ti + T r and tj + T c: all 16 off the
// diagonal, those with r > c on it, each written to its place in the
// output; fields past F are read as field F - 1 and their pairs dropped.
// F = 27 gives 28 tiles, one warp to a row. k is not split over threads:
// each output is one fp32 FMA chain over k = 0..D-1 in order, from 0, the
// order of the first design and of cuBLAS's fp32 batched product, so the
// kernel gives the bits it gave (a tree order differs from that chain by
// more than rtol/atol 1e-5 in a few of 23M outputs at B = 65,536, as the
// exactly rounded dot does too). A chunk is 128 columns with a row stride
// of 33 float4s; where F such rows do not fit in shared memory the stride
// is unpadded, then the chunk narrower. The chunks are walked in order and
// a thread carries its sums from one chunk to the next through its own
// outputs, which keeps the chain. So any D runs, and F up to 14,528 on the
// H100 (a chunk of 4 columns; the first design took F up to 29,056 at
// D = 1, a row of 116 KB).
// fp32 FMA in IEEE order: wgmma has no fp32 mode (TF32 would break the 1e-5
// tolerance), and the staged row is 14 KB, loaded once by its own warp with
// 512-byte float4 loads, 16 fields in flight per lane, so a TMA copy or an
// mbarrier ring would add a barrier protocol without removing a byte. No
// __launch_bounds__: ptxas takes 168 registers (12 one-warp blocks per SM);
// held to 128 it spilled, and the forms that fit 128 without spilling (the
// k loop not unrolled, 8 fields in flight) ran slower than this one on the
// H100 at B = 8,192 and 65,536, F = 27, D = 128, though 15 blocks fit.
//
// Backward (the TPU kernel has none; JAX differentiates the einsum): from x
// and dy f32[B, P] it writes dx[b, i, :] = sum_j G[b, i, j] x[b, j, :], where
// G is symmetric with G[i, j] = G[j, i] = dy[pair (i, j)] and a zero
// diagonal. Bound: bytes (2 F D + P floats per row for 2 F F D flops, 6.2
// flop/byte at F = 27, D = 128: 238 MB, 0.071 ms at B = 8,192), so the only
// job is to keep HBM busy without another unit setting the pace.
//
// The first design staged x[b] and G in shared memory behind a barrier and
// read both operands of every FMA from there: 2 shared loads per FMA, some
// 362,000 warp loads per SM at B = 8,192, about 0.2 ms on a pipe that takes
// one a clock, well above the byte bound. Here x never enters shared memory.
// A block takes one row. It builds G in shared memory, dy read once and
// coalesced, zero-padded to fp x fp with fp = F rounded up to 4. Each lane
// owns one column k and holds x[b, j, k] for a chunk of fields j in
// registers, loaded straight from global memory: one 128-byte warp load
// per j, all in flight together, issued before G's barrier. Four outputs i
// at a time, it reads G[i, chunk] as float4 broadcasts, each feeding 4
// FMAs: 0.25 shared loads per FMA (196 loads for a column's 756 FMAs at
// F = 27). The chunk's width is a template parameter and G's padding is
// zero, so the unrolled loops test nothing, the four FMA chains interleave
// and a lane holds its x values, 4 sums and their G reads (62 registers at
// F = 27, no spills). For F <= 32 one chunk holds the
// whole row; past that the chunks of 4 fields are walked in order, so the
// sum over j runs 0..F-1 in order in every case, as before.
// fp32 FMA in IEEE order throughout: TF32 tensor cores would break the
// 1e-5 tolerance, and TMA, mbarrier rings or wgmma add nothing to a kernel
// bound by bytes whose tiles are a few KB: occupancy (32 warps per SM)
// keeps the loads in flight instead.
#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kFwdChunk = 128;       // forward: columns staged at a time
constexpr int kFwdMaxThreads = 256;  // forward: threads per block (one row)
constexpr int kStageBatch = 16;      // forward: field loads in flight per lane
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kBwdMaxWarps = 8;   // backward: warps per block

// p = i(i-1)/2 + j with 0 <= j < i: invert the triangular number, then
// correct the float estimate by at most a step either way.
__device__ __forceinline__ void pair_of(int p, int* i_out, int* j_out) {
  int i = static_cast<int>((1.0f + sqrtf(1.0f + 8.0f * p)) * 0.5f);
  while (i * (i - 1) / 2 > p) --i;
  while ((i + 1) * i / 2 <= p) ++i;
  *i_out = i;
  *j_out = p - i * (i - 1) / 2;
}

// One row b per block. x[b, :, k0:k0 + kc] is staged into s (f rows of
// ld floats, zeros from the chunk's width up to a multiple of 4); each
// thread then runs its tiles of 4 x 4 pairs over the chunk.
__global__ void dot_interaction_kernel(const float* __restrict__ x, float* __restrict__ out,
                                       int f, int d, int n_pairs, int t_rows, int kc, int ld,
                                       bool vec) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int64_t b = blockIdx.x;
  const float* xb = x + b * f * d;
  float* ob = out + b * n_pairs;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_tiles = t_rows * (t_rows + 1) / 2;
  for (int k0 = 0; k0 < d; k0 += kc) {
    const int kw = min(kc, d - k0);   // the chunk's columns
    const int kw4 = (kw + 3) / 4 * 4;
    if (vec) {  // d % 4 == 0: float4 loads, kStageBatch fields in flight per lane
      for (int c = lane; c < kw4 / 4; c += 32) {
        for (int i0 = warp; i0 < f; i0 += kStageBatch * n_warps) {
          float4 v[kStageBatch];
#pragma unroll
          for (int u = 0; u < kStageBatch; ++u) {
            const int i = i0 + u * n_warps;
            const float* src = xb + static_cast<int64_t>(i) * d + k0;
            if (i < f) v[u] = __ldg(reinterpret_cast<const float4*>(src) + c);
          }
#pragma unroll
          for (int u = 0; u < kStageBatch; ++u) {
            const int i = i0 + u * n_warps;
            if (i < f) smem4[i * (ld / 4) + c] = v[u];
          }
        }
      }
    } else {
      for (int i = warp; i < f; i += n_warps) {
        const float* src = xb + static_cast<int64_t>(i) * d + k0;
        for (int c = lane; c < kw4; c += 32) s[i * ld + c] = c < kw ? __ldg(src + c) : 0.0f;
      }
    }
    __syncthreads();
    for (int tile = threadIdx.x; tile < n_tiles; tile += blockDim.x) {
      int ti, tj;  // tile = ti (ti + 1) / 2 + tj, tj <= ti
      pair_of(tile, &ti, &tj);
      --ti;
      int ia[4], jb[4], sa[4], sb[4];  // fields, and their offsets in s in float4s
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ia[r] = ti + t_rows * r;
        jb[r] = tj + t_rows * r;
        sa[r] = min(ia[r], f - 1) * (ld / 4);
        sb[r] = min(jb[r], f - 1) * (ld / 4);
      }
      // the output of the pair (ia[r], jb[c]), or -1: past F, or on or above
      // the diagonal of a diagonal tile
      auto place = [&](int r, int c) -> int64_t {
        if (ia[r] >= f || jb[c] >= f || (ti == tj && r <= c)) return -1;
        const int hi = max(ia[r], jb[c]), lo = min(ia[r], jb[c]);
        return static_cast<int64_t>(hi) * (hi - 1) / 2 + lo;
      };
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int64_t p = place(r, c);
          acc[r][c] = (k0 > 0 && p >= 0) ? ob[p] : 0.0f;
        }
      }
#pragma unroll 2
      for (int k4 = 0; k4 < kw4 / 4; ++k4) {
        float4 va[4], vb[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          va[r] = smem4[sa[r] + k4];
          vb[r] = smem4[sb[r] + k4];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][c] = fmaf(va[r].x, vb[c].x, acc[r][c]);
            acc[r][c] = fmaf(va[r].y, vb[c].y, acc[r][c]);
            acc[r][c] = fmaf(va[r].z, vb[c].z, acc[r][c]);
            acc[r][c] = fmaf(va[r].w, vb[c].w, acc[r][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int64_t p = place(r, c);
          if (p >= 0) ob[p] = acc[r][c];
        }
      }
    }
    if (k0 + kc < d) __syncthreads();  // the next chunk overwrites s
  }
}

// x[b, j0 + jj, k] for jj < C into registers (0 past F or off the row).
template <int C>
__device__ __forceinline__ void load_fields(float (&xr)[C], const float* __restrict__ col,
                                            int j0, int f, int d, bool live) {
#pragma unroll
  for (int jj = 0; jj < C; ++jj) {
    const int j = j0 + jj;
    xr[jj] = (live && j < f) ? __ldg(col + static_cast<int64_t>(j) * d) : 0.0f;
  }
}

// NQ float4s of G per row of a chunk: a chunk holds C = 4 NQ fields. G is
// fp x fp, fp = F rounded up to C, zero past F, so the loops over a chunk
// have no bounds to test. Four outputs i at a time keep four FMA chains in
// flight while a lane holds only its C values of x and 4 sums. One block
// per row; its warps walk the row's chunks of 32 columns. No
// __launch_bounds__: with one (256 threads), ptxas held the F = 25-28
// instance to 64 registers and spilled; without, it takes 62 and none, and
// 256 threads at up to 255 registers each still fit an SM's 65,536.
template <int NQ>
__global__ void dot_interaction_bwd_kernel(const float* __restrict__ x,
                                           const float* __restrict__ dy,
                                           float* __restrict__ dx, int f, int d,
                                           int n_pairs, int fp) {
  constexpr int C = 4 * NQ;
  extern __shared__ float4 smem4[];
  float* g = reinterpret_cast<float*>(smem4);  // fp x fp
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int col_chunks = (d + 31) / 32;
  const int f_chunks = fp / C;
  const float* xb = x + b * f * d;

  float xr[C];
  if (warp < col_chunks) {  // the first chunk's loads go out before G's barrier
    const int k = warp * 32 + lane;
    load_fields<C>(xr, xb + k, 0, f, d, k < d);
  }

  // G: zeros, then the pairs (dy read once, coalesced, each thread's loads
  // issued together)
  for (int e = threadIdx.x; e < fp * fp / 4; e += blockDim.x) {
    smem4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  const float* dyb = dy + b * n_pairs;
  for (int p0 = threadIdx.x; p0 < n_pairs; p0 += 4 * blockDim.x) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = p0 + u * blockDim.x;
      v[u] = p < n_pairs ? __ldg(dyb + p) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = p0 + u * blockDim.x;
      if (p < n_pairs) {
        int i, j;
        pair_of(p, &i, &j);
        g[i * fp + j] = v[u];
        g[j * fp + i] = v[u];
      }
    }
  }
  __syncthreads();

  for (int chunk = warp; chunk < col_chunks; chunk += n_warps) {
    const int k = chunk * 32 + lane;
    const bool live = k < d;
    if (chunk != warp) load_fields<C>(xr, xb + k, 0, f, d, live);
    for (int i0 = 0; i0 < f; i0 += 4) {  // four outputs i at a time
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int jc = 0; jc < f_chunks; ++jc) {  // one chunk unless F > 32
        if (f_chunks > 1 && (i0 > 0 || jc > 0)) {
          load_fields<C>(xr, xb + k, jc * C, f, d, live);
        }
        const float* gc = g + i0 * fp + jc * C;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const float4 gv = reinterpret_cast<const float4*>(gc + ii * fp)[q];  // a broadcast
            acc[ii] = fmaf(gv.x, xr[4 * q], acc[ii]);
            acc[ii] = fmaf(gv.y, xr[4 * q + 1], acc[ii]);
            acc[ii] = fmaf(gv.z, xr[4 * q + 2], acc[ii]);
            acc[ii] = fmaf(gv.w, xr[4 * q + 3], acc[ii]);
          }
        }
      }
      if (live) {
        float* out = dx + b * f * d + static_cast<int64_t>(i0) * d + k;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          if (i0 + ii < f) out[static_cast<int64_t>(ii) * d] = acc[ii];
        }
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int NQ>
int launch_bwd(const float* x, const float* dy, float* dx, int64_t b, int f, int d,
               cudaStream_t stream) {
  constexpr int C = 4 * NQ;
  const int fp = (f + C - 1) / C * C;
  const size_t smem = sizeof(float) * static_cast<size_t>(fp) * fp;
  const cudaError_t err = allow_smem(dot_interaction_bwd_kernel<NQ>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = std::min((d + 31) / 32, kBwdMaxWarps);
  dot_interaction_bwd_kernel<NQ><<<static_cast<unsigned>(b), warps * 32, smem, stream>>>(
      x, dy, dx, f, d, f * (f - 1) / 2, fp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fbk_dot_interaction(const float* x, int64_t b, int32_t f, int32_t d,
                        float* out, void* stream) {
  if (b < 0 || f < 2 || d < 1) return cudaErrorInvalidValue;
  if (static_cast<int64_t>(f) * (f - 1) / 2 > INT32_MAX) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // a chunk of kc columns, its row stride an odd number of float4s where it
  // fits; else unpadded and, for wide F, narrower
  int kc = (std::min(d, kFwdChunk) + 3) / 4 * 4;
  int ld = (kc / 4) % 2 ? kc : kc + 4;
  const int fit = max_smem / (4 * f) / 4 * 4;  // widest row of float4s that fits
  if (ld > fit) kc = ld = std::min(kc, fit);
  if (kc < 4) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * static_cast<size_t>(f) * ld;
  err = allow_smem(dot_interaction_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int t_rows = (f + 3) / 4;
  const int64_t n_tiles = static_cast<int64_t>(t_rows) * (t_rows + 1) / 2;
  const int threads = static_cast<int>(std::min<int64_t>((n_tiles + 31) / 32 * 32,
                                                         kFwdMaxThreads));
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  dot_interaction_kernel<<<static_cast<unsigned>(b), threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      x, out, f, d, static_cast<int>(static_cast<int64_t>(f) * (f - 1) / 2), t_rows, kc, ld,
      vec);
  return static_cast<int>(cudaGetLastError());
}

int fbk_dot_interaction_bwd(const float* x, const float* dy, int64_t b, int32_t f,
                            int32_t d, float* dx, void* stream) {
  if (b < 0 || f < 2 || d < 1) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (f <= 32 ? (f + 3) / 4 : 1) {  // one chunk of F rounded up to 4 fields
    case 2: return launch_bwd<2>(x, dy, dx, b, f, d, s);
    case 3: return launch_bwd<3>(x, dy, dx, b, f, d, s);
    case 4: return launch_bwd<4>(x, dy, dx, b, f, d, s);
    case 5: return launch_bwd<5>(x, dy, dx, b, f, d, s);
    case 6: return launch_bwd<6>(x, dy, dx, b, f, d, s);
    case 7: return launch_bwd<7>(x, dy, dx, b, f, d, s);
    case 8: return launch_bwd<8>(x, dy, dx, b, f, d, s);
    default: return launch_bwd<1>(x, dy, dx, b, f, d, s);  // F <= 4, or chunks of 4 past 32
  }
}

}  // extern "C"
