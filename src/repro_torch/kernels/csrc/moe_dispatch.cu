// The MoE dispatch: each (token, choice) pair's slot in its expert's part
// of the buffer, and the [n_local, C, d] expert buffer itself, for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// repro_torch/kernels/moe_dispatch.py.
//
// Replaces no TPU kernel: the JAX package dispatches in jnp
// (src/repro/models/moe.py:72-84, a cumulative sum of a one-hot and an
// `.at[].add`), which XLA fuses. The port's plain route
// (kernels/ref.py: ref_moe_dispatch, its twin) runs them on a card as a
// cumulative sum along the outer dimension of a [TK, E] int64 one-hot (E
// columns to spread over the card) and an accumulating index_put_, which
// sorts the indices and adds the duplicates in series: every dropped pair
// adds its zeros into slot 0 of its expert.
//
// What it computes, for the TK pairs p = t * k + j in row-major order, e_p
// the expert of pair p:
//   rank_p  = #{q < p : e_q = e_p}          (the cumulative sum's slot)
//   pos_p   = rank_p + offset[e_p]          (offset: the pairs of earlier
//                                            rows held elsewhere; 0 if none)
//   keep_p  = pos_p < C;   pos_c_p = keep_p ? pos_p : 0
//   ours_p  = first <= e_p < first + n_local
//   experts_p = ours_p ? e_p - first : 0;   mine_p = keep_p && ours_p
//   buf[e_p - first, pos_p] = the source row of each mine pair; zeros in
//   every other cell.
// Pair p reads source row p / (TK / rows): token rows [T, d] (k pairs a
// row) or pair rows [TK, d]. The rows are copied, never added to zero, so
// -0 stays -0.
//
// What bounds it: bytes. The buffer is written once and each kept pair's
// row read once: at the phi3.5-MoE prefill cell's shape (T 8,192, k 2,
// E 16, C 1,280, d 4,096, bf16) 167.8 MB written and at most 134.2 MB read
// a layer, 0.090 ms at 3.35 TB/s. The ranking reads TK expert ids and
// writes TK-long outputs (about 0.5 MB).
// The design:
//   1. Rank (moe_dispatch_rank): G blocks, at most one an SM, each a
//      contiguous chunk of the pairs. A block takes its chunk by an atomic
//      ticket, so it only ever waits on blocks that are already running.
//      a. The chunk's count of each expert: __match_any_sync groups a
//         warp's lanes by expert, and each group's lowest lane adds the
//         group's size to a shared-memory histogram. Counts are int32.
//      b. Decoupled look-back: the block publishes its counts as an
//         aggregate; a warp an expert then sums the counts of the blocks
//         before it, 32 blocks a step, back to the nearest one that has
//         published its inclusive prefix, and publishes its own. A status
//         and a count share one 64-bit word, so one load reads both.
//      c. The chunk again, 256 pairs a step: a pair's rank is its expert's
//         pairs before the block, before its warp (a scan over the warps in
//         shared memory, one thread an expert) and before its lane (the
//         popcount of its group's lower lanes). It writes the pair's
//         outputs and, for a mine pair, its index in a slot -> pair table.
//         The last block writes each local expert's range [lo, hi) of
//         owned slots: [min(offset, C), min(offset + count, C)).
//   2. Gather (moe_dispatch_gather): a warp a slot row, across the card.
//      A slot in [lo, hi) copies the row of its pair from the table, any
//      other writes zeros. Loads and stores are 16 bytes wide where the
//      rows are 16-byte aligned, else 2 bytes, a bfloat16 (a row of
//      d * size bytes that is no multiple of 16 starts unaligned in every
//      other buffer row, so a 16-byte body with a scalar tail would not
//      do). Every cell is written exactly once: no memset of the buffer,
//      no accumulate.
// One cudaMemsetAsync zeroes the look-back's words and the ticket,
// (G * E + 1) * 8 bytes.
//
// The backward (moe_dispatch_grad) is a gather too: each source row's
// gradient is the sum, in ascending choice order in float32 and rounded
// once to the row's type, of the buffer's gradient at each of its mine
// pairs' slots; a warp a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kRankThreads = 256;
constexpr int kRankWarps = kRankThreads / 32;
// Experts the rank launch takes: one scanning thread an expert
// (moe_dispatch.MAX_EXPERTS).
constexpr int kMaxExperts = kRankThreads;
constexpr int kGatherThreads = 256;
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kGatherBlocksPerSm = 4;
constexpr int kUnroll = 4;  // a lane's loads in flight in the gather
// The look-back's status, in the high word beside the count.
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

struct RankArgs {
  const int64_t* ids;     // expert of pair t * k + j at ids[t * s0 + j * s1]
  const int64_t* offset;  // [E], or null
  int64_t* experts;       // [TK]
  int64_t* pos_c;         // [TK]
  bool* keep;             // [TK]
  bool* mine;             // [TK]
  int* table;             // [n_local * C]: slot -> pair, owned slots only
  int* range;             // [n_local, 2]: lo, hi
  unsigned long long* state;  // [G, E]: status | count
  unsigned int* ticket;
  long long s0, s1;
  int k, TK, E, C, first, n_local, chunk, G;
};

__device__ __forceinline__ unsigned long long load_state(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_state(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// The expert of pair p (an id outside [0, E) is a caller's fault: trap).
__device__ __forceinline__ int expert_of(const RankArgs& a, int p) {
  const int t = p / a.k;
  const long long v = a.ids[t * a.s0 + (p - t * a.k) * a.s1];
  if (v < 0 || v >= a.E) __trap();
  return static_cast<int>(v);
}

__global__ void __launch_bounds__(kRankThreads) moe_dispatch_rank(RankArgs a) {
  __shared__ int s_block;
  __shared__ int hist[kMaxExperts];    // the chunk's pairs of each expert
  __shared__ int before[kMaxExperts];  // each expert's pairs before the step
  __shared__ long long off[kMaxExperts];
  // tag << 8 | a warp's pairs of an expert in the step (tag: the step + 1)
  __shared__ int warp_n[kRankWarps][kMaxExperts];
  __shared__ int warp_pre[kRankWarps][kMaxExperts];  // pairs before the warp

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  if (tid == 0) s_block = static_cast<int>(atomicAdd(a.ticket, 1u));
  if (tid < a.E) {
    hist[tid] = 0;
    off[tid] = a.offset != nullptr ? a.offset[tid] : 0;
    for (int w = 0; w < kRankWarps; ++w) warp_n[w][tid] = 0;
  }
  __syncthreads();
  const int b = s_block;
  const int p0 = static_cast<int>(min(static_cast<long long>(b) * a.chunk,
                                      static_cast<long long>(a.TK)));
  const int p1 = min(p0 + a.chunk, a.TK);

  // a. The chunk's count of each expert.
  for (int t0 = p0; t0 < p1; t0 += kRankThreads) {
    const int p = t0 + tid;
    const int e = p < p1 ? expert_of(a, p) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    if (e >= 0 && (peers & below) == 0) atomicAdd(&hist[e], __popc(peers));
  }
  __syncthreads();

  // b. Publish the counts, then sum those of the blocks before this one.
  unsigned long long* own = a.state + static_cast<size_t>(b) * a.E;
  if (tid < a.E)
    store_state(own + tid, (b == 0 ? kPrefix : kAggregate) | static_cast<unsigned>(hist[tid]));
  for (int e = warp; e < a.E; e += kRankWarps) {
    int sum = 0;
    for (int top = b - 1; top >= 0; top -= 32) {
      const int q = top - lane;  // lane 0 the nearest block
      unsigned long long v = kPrefix;  // before block 0: a prefix of 0 pairs
      if (q >= 0) {
        const unsigned long long* word = a.state + static_cast<size_t>(q) * a.E + e;
        do {
          v = load_state(word);
        } while ((v >> 32) == 0);
      }
      const unsigned done = __ballot_sync(0xffffffffu, (v >> 32) == (kPrefix >> 32));
      const int stop = done != 0 ? __ffs(done) - 1 : 32;
      int n = lane <= stop ? static_cast<int>(v & 0xffffffffu) : 0;
      for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
      sum += n;
      if (done != 0) break;
    }
    if (lane == 0) {
      before[e] = sum;
      if (b > 0) store_state(own + e, kPrefix | static_cast<unsigned>(sum + hist[e]));
    }
  }
  __syncthreads();
  if (b == a.G - 1) {  // every pair is counted: the owned slots of each expert
    for (int le = tid; le < a.n_local; le += kRankThreads) {
      const int e = a.first + le;
      const long long lo = min(off[e], static_cast<long long>(a.C));
      const long long hi = min(off[e] + before[e] + hist[e], static_cast<long long>(a.C));
      a.range[2 * le] = static_cast<int>(lo);
      a.range[2 * le + 1] = static_cast<int>(max(lo, hi));
    }
  }

  // c. Ranks, 256 pairs a step, and the pairs' outputs.
  int tag = 0;
  for (int t0 = p0; t0 < p1; t0 += kRankThreads) {
    ++tag;
    const int p = t0 + tid;
    const int e = p < p1 ? expert_of(a, p) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    if (e >= 0 && (peers & below) == 0) warp_n[warp][e] = tag << 8 | __popc(peers);
    __syncthreads();
    if (tid < a.E) {
      int run = before[tid];
      for (int w = 0; w < kRankWarps; ++w) {
        const int v = warp_n[w][tid];
        warp_pre[w][tid] = run;
        run += (v >> 8) == tag ? (v & 0xff) : 0;
      }
      before[tid] = run;
    }
    __syncthreads();
    if (e >= 0) {
      const long long pos = off[e] + warp_pre[warp][e] + __popc(peers & below);
      const bool keep = pos < a.C;
      const bool ours = e >= a.first && e < a.first + a.n_local;
      const bool mine = keep && ours;
      a.experts[p] = ours ? e - a.first : 0;
      a.pos_c[p] = keep ? pos : 0;
      a.keep[p] = keep;
      a.mine[p] = mine;
      if (mine && pos >= 0) a.table[static_cast<size_t>(e - a.first) * a.C + pos] = p;
    }
  }
}

template <int VB> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<2> { using T = unsigned short; };

struct GatherArgs {
  const char* src;
  long long src_row;  // bytes from one source row to the next
  char* buf;          // [n_local, C, d], rows of row_bytes
  const int* table;
  const int* range;
  int per;  // pairs a source row
  int n_rows, C, row_bytes;
};

// VB bytes a load and a store.
template <int VB>
__global__ void __launch_bounds__(kGatherThreads) moe_dispatch_gather(GatherArgs a) {
  using V = typename Vec<VB>::T;
  const int lane = threadIdx.x & 31;
  const int n_vec = a.row_bytes / VB;
  const int warps = gridDim.x * kGatherWarps;
  for (int r = blockIdx.x * kGatherWarps + (threadIdx.x >> 5); r < a.n_rows; r += warps) {
    const int le = r / a.C, c = r - le * a.C;
    V* dst = reinterpret_cast<V*>(a.buf + static_cast<size_t>(r) * a.row_bytes);
    if (c >= a.range[2 * le] && c < a.range[2 * le + 1]) {
      const V* s = reinterpret_cast<const V*>(
          a.src + static_cast<long long>(a.table[r] / a.per) * a.src_row);
      for (int v0 = lane; v0 < n_vec; v0 += 32 * kUnroll) {
        V x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (v0 + 32 * u < n_vec) x[u] = __ldg(s + v0 + 32 * u);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (v0 + 32 * u < n_vec) dst[v0 + 32 * u] = x[u];
      }
    } else {
      const V zero{};
      for (int v = lane; v < n_vec; v += 32) dst[v] = zero;
    }
  }
}

template <typename T, int VE>
struct alignas(sizeof(T) * VE) Pack {
  T v[VE];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct GradArgs {
  const void* grad;  // [n_local, C, d]
  const int64_t* experts;
  const int64_t* slots;
  const bool* mine;
  void* out;  // [rows, d]
  int rows, per, C, d;
};

// VE elements a load and a store.
template <typename T, int VE>
__global__ void __launch_bounds__(kGatherThreads) moe_dispatch_grad_kernel(GradArgs a) {
  using P = Pack<T, VE>;
  const int lane = threadIdx.x & 31;
  const int n_vec = a.d / VE;
  const int warps = gridDim.x * kGatherWarps;
  const T* g = static_cast<const T*>(a.grad);
  for (int r = blockIdx.x * kGatherWarps + (threadIdx.x >> 5); r < a.rows; r += warps) {
    P* out = reinterpret_cast<P*>(static_cast<T*>(a.out) + static_cast<size_t>(r) * a.d);
    for (int v = lane; v < n_vec; v += 32) {
      float acc[VE];
#pragma unroll
      for (int i = 0; i < VE; ++i) acc[i] = 0.f;
      for (int j = 0; j < a.per; ++j) {
        const size_t p = static_cast<size_t>(r) * a.per + j;
        if (!a.mine[p]) continue;
        const P x = reinterpret_cast<const P*>(
            g + (static_cast<size_t>(a.experts[p]) * a.C + a.slots[p]) * a.d)[v];
#pragma unroll
        for (int i = 0; i < VE; ++i) acc[i] += to_float(x.v[i]);
      }
      P y;
#pragma unroll
      for (int i = 0; i < VE; ++i) y.v[i] = from_float<T>(acc[i]);
      out[v] = y;
    }
  }
}

template <int VB>
int launch_gather(const GatherArgs& a, int blocks, cudaStream_t st) {
  moe_dispatch_gather<VB><<<blocks, kGatherThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_grad(const GradArgs& a, bool wide, int blocks, cudaStream_t st) {
  constexpr int kWide = 16 / sizeof(T);
  if (wide)
    moe_dispatch_grad_kernel<T, kWide><<<blocks, kGatherThreads, 0, st>>>(a);
  else
    moe_dispatch_grad_kernel<T, 1><<<blocks, kGatherThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int blocks_for(long long rows) {
  const long long want = (rows + kGatherWarps - 1) / kGatherWarps;
  return static_cast<int>(max(1LL, min(want, static_cast<long long>(sm90::sm_count()) *
                                                 kGatherBlocksPerSm)));
}

}  // namespace

// Rank then gather, on `stream`: TK pairs, the expert of pair t * k + j at
// ids[t * s0 + j * s1], source rows `rows` (TK / rows pairs a row) of
// row_bytes, src_row bytes apart. `work` holds (G * E + 1) 64-bit words
// (the ticket, then the look-back's [G, E]), then n_local * C + 2 * n_local
// int32 (the slot table and the ranges). Returns the cudaError_t of the
// memset and the launches.
extern "C" int moe_dispatch(const void* src, long long src_row, int rows, int row_bytes,
                            const int64_t* ids, long long s0, long long s1, int k, int TK,
                            const int64_t* offset, int E, int C, int first, int n_local,
                            int G, int64_t* experts, int64_t* pos_c, bool* keep, bool* mine,
                            void* buf, void* work, void* stream) {
  // The gather copies 16 or 2 bytes at a time (rows of float32 or bfloat16).
  const unsigned long long align =
      static_cast<unsigned long long>(reinterpret_cast<uintptr_t>(src)) |
      static_cast<unsigned long long>(reinterpret_cast<uintptr_t>(buf)) |
      static_cast<unsigned long long>(src_row) | static_cast<unsigned long long>(row_bytes);
  if (rows <= 0 || TK <= 0 || TK > INT_MAX / 2 || TK % rows != 0 || k <= 0 || TK % k != 0 ||
      row_bytes <= 0 || align % 2 != 0 || E <= 0 || E > kMaxExperts || C <= 0 || first < 0 ||
      n_local <= 0 || first + n_local > E || G <= 0 ||
      static_cast<long long>(n_local) * C > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* words = static_cast<unsigned long long*>(work);
  cudaError_t err = cudaMemsetAsync(
      words, 0, (static_cast<size_t>(G) * E + 1) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);

  RankArgs r;
  r.ids = ids;
  r.offset = offset;
  r.experts = experts;
  r.pos_c = pos_c;
  r.keep = keep;
  r.mine = mine;
  r.ticket = reinterpret_cast<unsigned int*>(words);
  r.state = words + 1;
  r.table = reinterpret_cast<int*>(words + 1 + static_cast<size_t>(G) * E);
  r.range = r.table + static_cast<size_t>(n_local) * C;
  r.s0 = s0;
  r.s1 = s1;
  r.k = k;
  r.TK = TK;
  r.E = E;
  r.C = C;
  r.first = first;
  r.n_local = n_local;
  r.chunk = (TK + G - 1) / G;
  r.G = G;
  moe_dispatch_rank<<<G, kRankThreads, 0, st>>>(r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  GatherArgs g;
  g.src = static_cast<const char*>(src);
  g.src_row = src_row;
  g.buf = static_cast<char*>(buf);
  g.table = r.table;
  g.range = r.range;
  g.per = TK / rows;
  g.n_rows = n_local * C;
  g.C = C;
  g.row_bytes = row_bytes;
  const int blocks = blocks_for(g.n_rows);
  if (align % 16 == 0) return launch_gather<16>(g, blocks, st);
  return launch_gather<2>(g, blocks, st);
}

// The gradient [rows, d] of the source rows from the buffer's gradient
// `grad` [n_local, C, d] (contiguous): per = TK / rows pairs a row, each
// pair's expert and slot in `experts` and `slots`, `mine` the pairs that
// hold a slot. dtype 0 float32, 1 bfloat16.
extern "C" int moe_dispatch_grad(int dtype, const void* grad, const int64_t* experts,
                                 const int64_t* slots, const bool* mine, void* out, int rows,
                                 int per, int C, int d, void* stream) {
  if (rows <= 0 || per <= 0 || C <= 0 || d <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  GradArgs a;
  a.grad = grad;
  a.experts = experts;
  a.slots = slots;
  a.mine = mine;
  a.out = out;
  a.rows = rows;
  a.per = per;
  a.C = C;
  a.d = d;
  const bool wide =
      (static_cast<long long>(d) * (dtype == 1 ? 2 : 4)) % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(grad) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(rows);
  if (dtype == 1) return launch_grad<__nv_bfloat16>(a, wide, blocks, st);
  return launch_grad<float>(a, wide, blocks, st);
}
