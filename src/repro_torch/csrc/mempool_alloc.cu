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
// alloc_offsets_ref bit for bit for every input. The JAX kernel is
// deterministic; so is this.
//
// Bound on the H100: bytes at large N (4 bytes read and 4 written per
// request, an align and an add each); launch latency at the device feed's
// N = 5, which fits one tile.
//
// Design: a single-pass scan over many blocks with a decoupled look-back.
// Each block scans one tile of kTile = 512 threads x 16 = 8,192 requests.
// A warp owns 512 consecutive requests as 4 chunks of 128; in chunk j lane
// l holds the 4 requests at j * 128 + 4 l, loaded as one int4 where
// n % 4 == 0 and sizes and offsets are 16-byte aligned (so every warp load
// and store moves 512 contiguous bytes, with the streaming hints __ldcs and
// __stcs: each byte is touched once), else as 4 scalars (a view such as
// sizes[1:]). Lanes past N count as size 0. Aligning uses t & -align when
// align is a power of two (floor(t / align) * align in two's complement,
// negative t included) and the floored division otherwise. Four warp
// shuffle scans, one per chunk, give each lane its offsets within the warp;
// one warp scans the 16 warp totals into the tile's aggregate.
//
// The look-back: the tile publishes its aggregate, then its inclusive
// prefix, in a 64-bit status word (flag in the high half, value in the low
// half), each in one release store, so a reader never sees a flag without
// its value. Warp 0 reads its 32 nearest predecessors' words with acquire
// loads, adds the run of aggregates up to the first word that is not one,
// and stops there if that word is an inclusive prefix; an empty word is
// read again, a run of 32 aggregates moves the window back by 32.
// Addition mod 2**32 is associative, so every grouping of the sums gives
// the same bits: the look-back is as exact as the sequential carry of the
// TPU kernel, with no tolerance.
//
// Forward progress: a block takes its tile number from an atomic ticket in
// the workspace, not from blockIdx.x. Blocks need not start in index order,
// and at N = 2**23 (1,024 tiles; 4 blocks of 512 threads at 32 registers
// fit an SM, 528 on the card) the grid is more than one wave; a block that
// waited on a predecessor which never got an SM would hang the card. With
// tickets, every tile a block waits on belongs to a block that is already
// running, and that block waits only on earlier ones.
//
// Tile size (chip_smoke.py phase 6 at N = 2**23 past the L2): the time
// followed the number of tiles, each behind its own look-back, so tiles of
// 8,192 beat tiles of 4,096 and 2,048; wider look-back windows (128 or 256
// words a round) and persistent blocks that prefetch their next tile were
// slower, as both cost resident blocks.
//
// The workspace is (tiles + 1) zeroed 64-bit words, word 0 the ticket, from
// the caller's caching allocator; the caller zeroes it on the launch's own
// stream before the launch, so no block can read a status word that was not
// yet zeroed. When N fits one tile (the feed's N = 5, and N = 0) the kernel
// runs as one block with no workspace: one launch, no memset.
#include <cstdint>

#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;      // 16: one warp scans the warp totals
constexpr int kVec = 4;                    // requests per chunk and lane: one int4
constexpr int kChunks = 4;                 // chunks per lane
constexpr int kChunk = 32 * kVec;          // 128 requests per warp chunk
constexpr int kWarpItems = kChunks * kChunk;                       // 512
constexpr int64_t kTile = static_cast<int64_t>(kWarps) * kWarpItems;  // 8,192
constexpr unsigned kFull = 0xffffffffu;

// status word: flag << 32 | value
constexpr uint64_t kAggregate = 1ull << 32;
constexpr uint64_t kInclusive = 2ull << 32;

using Status = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

// (s + (align - 1)) // align * align in wrapping int32 arithmetic with floor
// division, exactly as the reference computes it.
template <bool kPow2>
__device__ __forceinline__ uint32_t align_up(int32_t s, int32_t align) {
  const uint32_t t = static_cast<uint32_t>(s) + static_cast<uint32_t>(align - 1);
  if (kPow2) return t & static_cast<uint32_t>(-align);
  const int32_t ts = static_cast<int32_t>(t);
  int32_t q = ts / align;
  if (ts % align != 0 && ts < 0) --q;  // C++ truncates; the reference floors
  return static_cast<uint32_t>(q) * static_cast<uint32_t>(align);
}

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t up = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += up;
  }
  return v;
}

__device__ __forceinline__ void publish(unsigned long long* word, uint64_t flag,
                                        uint32_t value) {
  Status(*word).store(flag | value, cuda::std::memory_order_release);
}

// Run by all of warp 0: the sum of every tile before `tile`, published as
// this tile's inclusive prefix on the way out. Each round reads the 32
// nearest predecessors not yet added (lane l the l-th nearest), adds the
// run of aggregates up to the first word that is not one, and stops there
// if that word is an inclusive prefix; if it is still empty, the next round
// starts from it.
__device__ uint32_t look_back(unsigned long long* status, int32_t tile, uint32_t aggregate,
                              int lane) {
  if (tile == 0) {
    if (lane == 0) publish(status, kInclusive, aggregate);
    return 0;
  }
  if (lane == 0) publish(status + tile, kAggregate, aggregate);
  uint32_t prefix = 0;
  for (int32_t nearest = tile - 1;;) {
    // tile 0's word is never an aggregate, so a round stops at it or
    // nearer: a lane past it is never added (it reads as an inclusive 0)
    const int32_t pred = nearest - lane;
    const uint64_t word =
        pred >= 0 ? Status(status[pred]).load(cuda::std::memory_order_acquire) : kInclusive;
    const unsigned stopped = __ballot_sync(kFull, (word >> 32) != (kAggregate >> 32));
    const int stop_lane = stopped ? __ffs(stopped) - 1 : 32;
    prefix += __reduce_add_sync(kFull, lane < stop_lane ? static_cast<uint32_t>(word) : 0u);
    if (!stopped) {
      nearest -= 32;
      continue;
    }
    const uint64_t stop = __shfl_sync(kFull, word, stop_lane);
    if ((stop >> 32) == (kInclusive >> 32)) {
      prefix += static_cast<uint32_t>(stop);
      break;
    }
    nearest -= stop_lane;  // still empty: everything nearer is added; read it again
  }
  if (lane == 0) publish(status + tile, kInclusive, prefix + aggregate);
  return prefix;
}

// `status` is null when N fits one tile (one block, tile 0, no look-back);
// otherwise status[0] is the ticket and status[1 + t] tile t's word.
template <bool kVec4, bool kPow2>
__global__ void __launch_bounds__(kThreads)
alloc_offsets_kernel(const int32_t* __restrict__ sizes, int64_t n, int32_t align,
                     int32_t* __restrict__ offsets, int32_t* __restrict__ head,
                     unsigned long long* __restrict__ status) {
  __shared__ uint32_t warp_base[kWarps];
  __shared__ uint32_t tile_prefix;
  __shared__ int32_t ticket;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t tile = 0;
  if (status != nullptr) {
    if (threadIdx.x == 0) ticket = static_cast<int32_t>(atomicAdd(status, 1ull));
    __syncthreads();
    tile = ticket;
  }
  const int64_t first = tile * kTile + warp * kWarpItems + lane * kVec;  // chunk 0

  int32_t s[kChunks][kVec];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int64_t i = first + j * kChunk;
    if (kVec4) {  // n % 4 == 0: a lane's 4 requests are all in or all out
      const int4 v = i < n ? __ldcs(reinterpret_cast<const int4*>(sizes + i))
                           : make_int4(0, 0, 0, 0);
      s[j][0] = v.x;
      s[j][1] = v.y;
      s[j][2] = v.z;
      s[j][3] = v.w;
    } else {
#pragma unroll
      for (int c = 0; c < kVec; ++c) s[j][c] = i + c < n ? __ldg(sizes + i + c) : 0;
    }
  }
  uint32_t a[kChunks][kVec];  // aligned sizes; align_up(0) == 0 for lanes past N
  uint32_t excl[kChunks];     // the lane's chunk offset within the warp
  uint32_t warp_total = 0;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    uint32_t sum = 0;
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      a[j][c] = align_up<kPow2>(s[j][c], align);
      sum += a[j][c];
    }
    const uint32_t incl = warp_inclusive_scan(sum, lane);
    excl[j] = warp_total + incl - sum;
    warp_total += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) warp_base[warp] = warp_total;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = lane < kWarps ? warp_base[lane] : 0u;
    const uint32_t w_incl = warp_inclusive_scan(w, lane);
    const uint32_t aggregate = __shfl_sync(kFull, w_incl, 31);
    if (lane < kWarps) warp_base[lane] = w_incl - w;  // exclusive prefix of the warp totals
    const uint32_t prefix = status == nullptr ? 0u : look_back(status + 1, tile, aggregate, lane);
    if (lane == 0) {
      tile_prefix = prefix;
      if ((tile + 1) * kTile >= n) head[0] = static_cast<int32_t>(prefix + aggregate);
    }
  }
  __syncthreads();
  const uint32_t base = tile_prefix + warp_base[warp];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int64_t i = first + j * kChunk;
    uint32_t o[kVec];
    uint32_t run = base + excl[j];
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      o[c] = run;
      run += a[j][c];
    }
    if (kVec4) {
      if (i < n)
        __stcs(reinterpret_cast<int4*>(offsets + i),
               make_int4(static_cast<int32_t>(o[0]), static_cast<int32_t>(o[1]),
                         static_cast<int32_t>(o[2]), static_cast<int32_t>(o[3])));
    } else {
#pragma unroll
      for (int c = 0; c < kVec; ++c)
        if (i + c < n) offsets[i + c] = static_cast<int32_t>(o[c]);
    }
  }
}

template <bool kVec4, bool kPow2>
cudaError_t launch(const int32_t* sizes, int64_t n, int32_t align, int32_t* offsets,
                   int32_t* head, unsigned long long* status, int64_t tiles,
                   cudaStream_t stream) {
  alloc_offsets_kernel<kVec4, kPow2><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      sizes, n, align, offsets, head, status);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Requests per block: N above this takes the multi-block form and a
// workspace of (tiles + 1) zeroed 64-bit words.
int64_t fbk_alloc_offsets_tile() { return kTile; }

int fbk_alloc_offsets(const int32_t* sizes, int64_t n, int32_t align, int32_t* offsets,
                      int32_t* head, void* workspace, int64_t workspace_words,
                      void* stream) {
  if (n < 0 || align <= 0) return cudaErrorInvalidValue;
  const int64_t tiles = n <= kTile ? 1 : (n + kTile - 1) / kTile;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;  // tile numbers are int32
  auto* status = tiles > 1 ? static_cast<unsigned long long*>(workspace) : nullptr;
  if (tiles > 1 && (status == nullptr || workspace_words < tiles + 1))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = n % kVec == 0 && reinterpret_cast<uintptr_t>(sizes) % sizeof(int4) == 0 &&
                   reinterpret_cast<uintptr_t>(offsets) % sizeof(int4) == 0;
  const bool pow2 = (align & (align - 1)) == 0;
  cudaError_t err;
  if (vec) {
    err = pow2 ? launch<true, true>(sizes, n, align, offsets, head, status, tiles, s)
               : launch<true, false>(sizes, n, align, offsets, head, status, tiles, s);
  } else {
    err = pow2 ? launch<false, true>(sizes, n, align, offsets, head, status, tiles, s)
               : launch<false, false>(sizes, n, align, offsets, head, status, tiles, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
