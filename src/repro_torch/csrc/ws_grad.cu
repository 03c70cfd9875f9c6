// ws_grad: the backward of the working-set gather, a deterministic segment sum.
//
// Replaces no TPU kernel. The sparse train step takes each id's row from the
// working set through the dedup's inverse (rows[inverse], jnp.take's fill
// semantics); JAX differentiates that gather into a segment_sum that XLA
// lowers itself, and the port left it to autograd's index backward, which
// sorts the indices and gives each distinct index to one warp that adds its
// duplicates one after another. Under skewed ids one working row is
// referenced by tens of thousands of positions (a field of vocabulary 3 puts
// half a batch on one id), so that warp's serial loop set the time of the
// whole op while the rest of the card had finished.
//
// From g f32[N, D] (the gradient of the gathered rows), the slot of each
// position sorted stably (keys int32[N]; a position whose index lies outside
// [-cap, cap) has key cap and sorts last) and the sort's order int64[N], it
// writes out f32[cap, D]: out[s] = the sum of g[i] over the positions i of
// slot s, in increasing i, and 0 for a slot no position references.
//
// Bound on the H100: bytes. The op reads each gradient row once (4 N D), its
// keys and order, and writes each output row once (4 cap D), for one add per
// element read: 1.76 GB, 0.525 ms at 3.35 TB/s for the DLRM training cell
// (N = cap = 65,536 x 26, D = 128).
//
// Design. The work is split by sorted positions, not by slots: a warp takes
// a fixed chunk of kChunk consecutive sorted positions, so a run of one
// position and a run of 33,000 cost the same per row and a hot slot is
// spread over some 260 warps across the card. Each lane owns D/32 floats of
// a row (one float4 at D = 128, so a warp moves 512 contiguous bytes a
// load) and keeps kInFlight row loads in flight. The warp sums in registers
// while the key holds; a segment that begins and ends inside the chunk is
// stored to its slot directly. The chunk's first and last segments go to a
// carry buffer of two rows per chunk, and ws_grad_finish_kernel adds each
// segment's carries in chunk order and stores it. The order of every sum is
// set by the positions alone (a chain in position order inside a chunk,
// then the chunks' partials in chunk order), so the result is the same bits
// from run to run, with no atomics; its rounding error is at most
// (min(c, kChunk) + ceil(c / kChunk) + 1) 2^-24 times the sum of |g| over
// the c terms of a slot, against (c + 1) 2^-24 for one serial chain.
// Every output row is written by one of these kernels: a referenced slot by
// the chunk kernel or the finish kernel's carries, an unreferenced one
// (marked 0 by ws_grad_keys_kernel and not marked 1 by the chunk kernel) as
// zeros by the finish kernel, so no memset of the output precedes them. The
// finish kernel runs both jobs in one launch, the carries in its first
// blocks: the walk of a hot slot's some 260 carries is latency-bound, and
// runs beside the zero rows' writes instead of after them.
// fp32 adds in IEEE order; no shared memory: each warp's rows are its own.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;      // sorted positions a warp sums (ops.CHUNK)
constexpr int kInFlight = 8;     // row loads a lane keeps in flight
constexpr int kWalk = 16;        // carry rows a lane loads at a time
constexpr int kWarps = 8;        // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

template <bool kVec>
struct Lane;

template <>
struct Lane<true> {  // D % 4 == 0, 16-byte aligned rows: one float4 a lane
  using V = float4;
  static constexpr int kWidth = 4;
  __device__ static V zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static V stream(const float* row, int q) {
    return __ldcs(reinterpret_cast<const float4*>(row) + q);
  }
  __device__ static V load(const float* row, int q) {
    return reinterpret_cast<const float4*>(row)[q];
  }
  __device__ static void store(float* row, int q, V v) { reinterpret_cast<float4*>(row)[q] = v; }
  __device__ static void add(V& a, const V& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
};

template <>
struct Lane<false> {  // any D: one float a lane
  using V = float;
  static constexpr int kWidth = 1;
  __device__ static V zero() { return 0.f; }
  __device__ static V stream(const float* row, int q) { return __ldcs(row + q); }
  __device__ static V load(const float* row, int q) { return row[q]; }
  __device__ static void store(float* row, int q, V v) { row[q] = v; }
  __device__ static void add(V& a, const V& b) { a += b; }
};

// keys[i]: the slot of position i (idx wrapped as jnp.take wraps), or cap
// where idx[i] lies outside [-cap, cap); marks[s] = 0 for every slot.
template <typename I>
__global__ void __launch_bounds__(kThreads)
ws_grad_keys_kernel(const I* __restrict__ idx, int64_t n, int64_t cap,
                    int32_t* __restrict__ keys, uint8_t* __restrict__ marks) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t end = n > cap ? n : cap;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < end;
       i += stride) {
    if (i < n) {
      const int64_t v = static_cast<int64_t>(idx[i]);
      keys[i] = static_cast<int32_t>(v >= -cap && v < cap ? (v < 0 ? v + cap : v) : cap);
    }
    if (i < cap) marks[i] = 0;
  }
}

// One warp a chunk of kChunk sorted positions: interior segments to out,
// the first segment to carry row 2c, the last (when another) to 2c + 1,
// and a mark for the slot of each segment that starts in the chunk.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ws_grad_chunk_kernel(const float* __restrict__ g, const int32_t* __restrict__ keys,
                     const int64_t* __restrict__ order, int64_t n, int64_t n_chunks,
                     int32_t cap, int32_t d, float* __restrict__ out,
                     float* __restrict__ carry, uint8_t* __restrict__ marks) {
  using L = Lane<kVec>;
  using V = typename L::V;
  constexpr int kSub = kChunk / 32;  // positions a lane holds
  const int lane = threadIdx.x & 31;
  const int w = d / L::kWidth;       // vectors a row
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       c < n_chunks; c += n_warps) {
    const int64_t lo = c * kChunk;
    const int64_t hi = lo + kChunk < n ? lo + kChunk : n;
    int32_t k_l[kSub];
    long long r_l[kSub];
#pragma unroll
    for (int t = 0; t < kSub; ++t) {
      const int64_t p = lo + 32 * t + lane;
      k_l[t] = p < hi ? keys[p] : cap;
      r_l[t] = p < hi ? static_cast<long long>(order[p]) : 0;
    }
    const int32_t first = __shfl_sync(kFull, k_l[0], 0);
    if (first >= cap) continue;  // only positions outside the working set
    const int32_t last = keys[hi - 1];
    int32_t prev_tail = -1;
#pragma unroll
    for (int t = 0; t < kSub; ++t) {
      const int32_t up = __shfl_up_sync(kFull, k_l[t], 1);
      const int32_t prev = lane == 0 ? prev_tail : up;
      prev_tail = __shfl_sync(kFull, k_l[t], 31);
      if (k_l[t] < cap && k_l[t] != prev) marks[k_l[t]] = 1;
    }
    float* first_row = carry + 2 * c * d;
    float* last_row = first_row + d;
    for (int q0 = 0; q0 < w; q0 += 32) {
      const int q = q0 + lane;
      const bool on = q < w;
      V acc = L::zero();
      int32_t cur = first;
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
#pragma unroll
        for (int j0 = 0; j0 < 32; j0 += kInFlight) {
          int32_t kk[kInFlight];
          V v[kInFlight];
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
            kk[u] = __shfl_sync(kFull, k_l[t], j0 + u);
            const long long r = __shfl_sync(kFull, r_l[t], j0 + u);
            v[u] = on && kk[u] < cap ? L::stream(g + r * d, q) : L::zero();
          }
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
            if (kk[u] != cur) {  // warp-uniform: the keys are broadcast
              if (cur < cap && on) {
                float* dst = cur == first ? first_row
                                          : (cur == last ? last_row
                                                         : out + static_cast<int64_t>(cur) * d);
                L::store(dst, q, acc);
              }
              acc = L::zero();
              cur = kk[u];
            }
            L::add(acc, v[u]);
          }
        }
      }
      if (cur < cap && on) {
        float* dst = cur == first ? first_row
                                  : (cur == last ? last_row : out + static_cast<int64_t>(cur) * d);
        L::store(dst, q, acc);
      }
    }
  }
}

// Chunk c's segments that start in it and reach its edge (its first
// segment when it starts there, its last when another): each is its carry
// row plus the first-segment carries of the following chunks that open with
// the same slot, added in chunk order. The carries are loaded kWalk at a
// time whatever their chunks' keys, so that no load waits on a key's.
template <bool kVec>
__device__ void resolve_chunk(int64_t c, const int32_t* __restrict__ keys, int64_t n,
                              int64_t n_chunks, int32_t cap, int32_t d,
                              const float* __restrict__ carry, float* __restrict__ out) {
  using L = Lane<kVec>;
  using V = typename L::V;
  const int lane = threadIdx.x & 31;
  const int w = d / L::kWidth;
  const int64_t lo = c * kChunk;
  const int64_t hi = lo + kChunk < n ? lo + kChunk : n;
  const int32_t first = keys[lo];
  if (first >= cap) return;
  const int32_t last = keys[hi - 1];
  for (int side = 0; side < 2; ++side) {
    const int32_t key = side == 0 ? first : last;
    if (side == 0 ? c > 0 && keys[lo - 1] == first : last == first || last >= cap) continue;
    const float* own = carry + (2 * c + side) * d;
    for (int q0 = 0; q0 < w; q0 += 32) {
      const int q = q0 + lane;
      const bool on = q < w;
      V acc = on ? L::load(own, q) : L::zero();
      // the chunks that open with `key` follow c without a gap
      for (int64_t c2 = c + 1; c2 < n_chunks; c2 += kWalk) {
        int32_t kk[kWalk];
        V v[kWalk];
#pragma unroll
        for (int u = 0; u < kWalk; ++u) {
          const int64_t cc = c2 + u;
          kk[u] = cc < n_chunks ? keys[cc * kChunk] : -1;
          v[u] = on && cc < n_chunks ? L::load(carry + 2 * cc * d, q) : L::zero();
        }
#pragma unroll
        for (int u = 0; u < kWalk; ++u) {
          if (kk[u] == key) L::add(acc, v[u]);
        }
        if (kk[kWalk - 1] != key) break;
      }
      if (on) L::store(out + static_cast<int64_t>(key) * d, q, acc);
    }
  }
}

// Zeros for each of the 32 slots of group grp that no position marked.
template <bool kVec>
__device__ void zero_group(int64_t grp, const uint8_t* __restrict__ marks, int64_t cap,
                           int32_t d, float* __restrict__ out) {
  using L = Lane<kVec>;
  const int lane = threadIdx.x & 31;
  const int w = d / L::kWidth;
  const int64_t s0 = grp * 32;
  const bool unmarked = s0 + lane < cap && marks[s0 + lane] == 0;
  unsigned todo = __ballot_sync(kFull, unmarked);
  while (todo) {
    const int j = __ffs(todo) - 1;
    todo &= todo - 1;
    float* row = out + (s0 + j) * d;
    for (int q = lane; q < w; q += 32) L::store(row, q, L::zero());
  }
}

// One warp an item: the first n_chunks items resolve a chunk's carries, the
// rest zero a slot group. One launch, the chunks first, so that a hot
// slot's walk starts in the launch's first blocks and runs beside the zero
// rows' writes.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ws_grad_finish_kernel(const int32_t* __restrict__ keys, const uint8_t* __restrict__ marks,
                      int64_t n, int64_t n_chunks, int32_t cap, int32_t d,
                      const float* __restrict__ carry, float* __restrict__ out) {
  const int64_t items = n_chunks + (static_cast<int64_t>(cap) + 31) / 32;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t item = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       item < items; item += n_warps) {
    if (item < n_chunks) {
      resolve_chunk<kVec>(item, keys, n, n_chunks, cap, d, carry, out);
    } else {
      zero_group<kVec>(item - n_chunks, marks, cap, d, out);
    }
  }
}

unsigned blocks_for(int64_t items, int64_t per_block) {
  const int64_t b = (items + per_block - 1) / per_block;
  return static_cast<unsigned>(b < 1 ? 1 : (b > 0x7fffffff ? 0x7fffffff : b));
}

template <bool kVec>
void launch_sum(const float* g, const int32_t* keys, const int64_t* order, int64_t n,
                int32_t cap, int32_t d, float* out, float* carry, uint8_t* marks,
                cudaStream_t s) {
  const int64_t n_chunks = (n + kChunk - 1) / kChunk;
  if (n_chunks > 0) {
    ws_grad_chunk_kernel<kVec><<<blocks_for(n_chunks, kWarps), kThreads, 0, s>>>(
        g, keys, order, n, n_chunks, cap, d, out, carry, marks);
  }
  const int64_t n_groups = (static_cast<int64_t>(cap) + 31) / 32;
  ws_grad_finish_kernel<kVec><<<blocks_for(n_chunks + n_groups, kWarps), kThreads, 0, s>>>(
      keys, marks, n, n_chunks, cap, d, carry, out);
}

}  // namespace

extern "C" {

// Keys and cleared marks from the gather's indices (int32, or int64 when
// idx64 is non-zero).
int fbk_ws_grad_keys(const void* idx, int32_t idx64, int64_t n, int64_t cap, int32_t* keys,
                     uint8_t* marks, void* stream) {
  if (n < 0 || cap < 0 || cap > 0x7fffffff) return cudaErrorInvalidValue;
  if (n == 0 && cap == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(n > cap ? n : cap, kThreads);
  if (idx64) {
    ws_grad_keys_kernel<int64_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const int64_t*>(idx), n, cap, keys, marks);
  } else {
    ws_grad_keys_kernel<int32_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const int32_t*>(idx), n, cap, keys, marks);
  }
  return static_cast<int>(cudaGetLastError());
}

// out f32[cap, d] from g f32[n, d] and the stably sorted keys and their
// order; carry holds 2 ceil(n / kChunk) rows of d.
int fbk_ws_grad_sum(const float* g, const int32_t* keys, const int64_t* order, int64_t n,
                    int64_t cap, int32_t d, float* out, float* carry, uint8_t* marks,
                    void* stream) {
  if (n < 0 || cap < 0 || cap > 0x7fffffff || d < 0) return cudaErrorInvalidValue;
  if (cap == 0 || d == 0) return cudaSuccess;
  const bool vec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(carry) & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    launch_sum<true>(g, keys, order, n, static_cast<int32_t>(cap), d, out, carry, marks, s);
  } else {
    launch_sum<false>(g, keys, order, n, static_cast<int32_t>(cap), d, out, carry, marks, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
