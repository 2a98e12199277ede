// Batched max-plus critical path and the §IV-A combined bound, for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// repro_torch/kernels/cpm.py.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/cpm.py:
//   _kernel           (:56)  -> cpm_critical_path
//   _lb_kernel        (:93)  -> cpm_combined_lb,        cpm_fleet_lb
//   _lb_kernel_masked (:101) -> cpm_combined_lb_masked, cpm_fleet_lb_masked
// The cpm_fleet_* entry points also take in the device program around the
// Pallas call, src/repro/core/vectorized.py:_fleet_lb_device (the adjacency
// scatter, the feasibility mask and the contention terms), so the scheduler's
// stage 1 is one launch.
//
// Per row b, from dist = 0, n_iters Jacobi max-plus rounds
//     dist[v] <- max(dist[v], max_u dist[u] + w[u, v])
// where every round reads only the previous round's dist (cpm.py:_relax), so
// the result equals the Pallas kernel for any n_iters, including n_iters
// below the DAG's depth. The LB entry points then take
//     lb = max(max_v dist[v] + p[v], extra)
// and the masked ones relax over (w + mask), the sum taken in float32 before
// the first round exactly as _lb_kernel_masked does. Non-finite w and extra
// map to -1e30 (cpm.py:NEG_INF). Every operation is a float32 add or max, and
// in the fleet entry points one IEEE division, in a fixed association, so
// results are bit-identical to the plain PyTorch versions
// (repro_torch/kernels/ref.py) and to the JAX package.
//
// The relaxation core (n <= 32). A row is owned by a group of L lanes of one
// warp (L = 2, 4, 16 at n <= 8, 16, 32); lane g holds the columns
// [g*C, g*C + C) of the row's adjacency in registers (C = n_pad / L, at most
// 64 values a lane) and its C entries of dist. A round gets the other lanes'
// dist[u] by __shfl_sync within the group and maxes in registers: no shared
// memory and no barrier inside a round. Loops are unrolled over the padded
// size, so every register index is a compile-time constant. A warp stops
// after the first round that changes no bit of its rows' dist: that round
// is a fixed point, so every later one would repeat it and the result is
// the same for any n_iters (the production DAGs need about 2 rounds of 9).
//
// Front end A, cpm_combined_lb / cpm_combined_lb_masked / cpm_critical_path
// over a [B, n, n] tile: each lane loads its columns of every u row straight
// from HBM into registers, 16 bytes a load (8 at n = 32), a row's lanes on
// adjacent pieces. What bounds it: the bytes of w (and mask), B*n*n*4 each;
// at the offline shape (B 131,072, n 16, 9 rounds) 134 MB, 40 us at
// 3.35 TB/s, against at most 0.6 G max/add. The previous design staged the
// tile in shared memory and read d[u] and w[u][v] from it for every u of
// every round, with 2-way bank conflicts and a barrier a round: shared-memory
// wavefronts, not HBM, set its time (0.155 ms). Front end A uses no shared
// memory at all; two blocks an SM (<= 128 registers a thread) keep one
// block's loads in flight while the other relaxes.
//
// Front end B, cpm_fleet_lb / cpm_fleet_lb_masked: stage 1 of the scheduler
// in one launch. Per row it reads only the candidate's racks [n_pad] and its
// instance id (int32, as the host copies them) and writes one float; the
// per-instance edge tables (a few KB) come through the read-only cache. The
// row's lanes scatter its edges into a per-row shared tile set to -1e30 (padded
// edges, src == dst, write nothing; DagJob rejects real self-loops and
// duplicate edges), read their columns into registers once, and relax them
// in the core. The contention terms follow the reference's fixed order:
// per rack a sequential sum over v (lanes split the racks, the row's racks
// and durations in registers); work (and forced) a sequential sum over e,
// its terms made by the lane that scatters the edge (lanes take the edges
// in chunks of L, four chunks' loads in flight at once) and added in edge
// order by shuffle; then max(lb_load, work / chan_div) (and forced), an
// IEEE division (no fast-math in build.py). The [B, n, n] adjacency and
// mask never reach device memory: at the offline shape a launch reads
// 9.5 MB, and its time goes to building the rows (the tile, the edges and
// the contention terms take about two thirds of it), not to HBM.
//
// n > 32 (up to MAX_N = 128, cpm.py) keeps the shared-tile body: thread
// (r, v) owns dist[v] of row r, the tile is staged in shared memory and
// rounds are separated by __syncthreads(). The engine's size buckets are
// n_pad 8 and 16.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // cpm.py:NEG_INF
constexpr float kFltMax = 3.402823466e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;      // threads a block (at most, n > 32)
constexpr int kSmemTarget = 48 * 1024;
constexpr int kU = 4;              // edge chunks in flight in the fleet kernel

__device__ __forceinline__ float finite_or_neg(float x) {
  // fabsf(NaN) <= kFltMax is false, so NaN maps like +-inf.
  return fabsf(x) <= kFltMax ? x : kNegInf;
}

// ---------------------------------------------------------------------------
// The relaxation core: a row in the registers of L lanes
// ---------------------------------------------------------------------------

template <int NP>
struct Lanes {
  static constexpr int L = NP <= 8 ? 2 : (NP <= 16 ? 4 : 16);
  static constexpr int C = NP / L;             // columns a lane: 4, 4, 2
  static constexpr int kRows = kThreads / L;   // rows a block
  // The fleet kernel's per-row tile, padded so that the column reads of one
  // quarter-warp (16-byte) or half-warp (8-byte, NP = 32) hit distinct banks.
  static constexpr int kTile = NP * NP + (NP == 32 ? 0 : NP);
  static constexpr int kRack = NP + 1;         // per-row racks, odd stride
};

// C adjacent floats at p (16- or 8-byte aligned) from global memory.
template <int C>
__device__ __forceinline__ void ldg_vec(const float* p, float (&x)[C]) {
  if constexpr (C == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = t.x; x[1] = t.y;
  }
}

// The same from shared memory.
template <int C>
__device__ __forceinline__ void lds_vec(const float* p, float (&x)[C]) {
  if constexpr (C == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  }
}

template <int C>
__device__ __forceinline__ void sts_fill(float* p, float x) {
  if constexpr (C == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x, x, x, x);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x, x);
  }
}

// n_iters Jacobi rounds over the lane's columns w[u][c] = w[u][g*C + c];
// d holds dist[g*C + c]. Every lane of the group sends its round-r dist
// before any lane replaces it, so each round reads only the previous one.
// Two accumulators per column (even and odd u) for instruction-level
// parallelism; max is exact, so the split changes no bit. A round that
// changes no bit of any dist in the warp is a fixed point: every later
// round would repeat it, so the warp stops there with the same result.
template <int NP>
__device__ __forceinline__ void relax(const float (&w)[NP][Lanes<NP>::C],
                                      float (&d)[Lanes<NP>::C], int n_iters) {
  constexpr int L = Lanes<NP>::L, C = Lanes<NP>::C;
  for (int it = 0; it < n_iters; ++it) {
    float a0[C], a1[C];
#pragma unroll
    for (int c = 0; c < C; ++c) a0[c] = a1[c] = d[c];
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      const float du = __shfl_sync(kFull, d[u % C], u / C, L);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (u % 2 == 0) {
          a0[c] = fmaxf(a0[c], du + w[u][c]);
        } else {
          a1[c] = fmaxf(a1[c], du + w[u][c]);
        }
      }
    }
    bool changed = false;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float x = fmaxf(a0[c], a1[c]);
      changed |= __float_as_uint(x) != __float_as_uint(d[c]);
      d[c] = x;
    }
    if (!__any_sync(kFull, changed)) break;
  }
}

// Max over the L lanes of a group.
template <int L>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off, L));
  }
  return x;
}

// ---------------------------------------------------------------------------
// Front end A: [B, n, n] tiles, n <= 32
// ---------------------------------------------------------------------------

// vec: n == NP and every row's pieces aligned for vector loads.
template <int NP, bool kMasked, bool kEpilogue>
__global__ void __launch_bounds__(kThreads, 2)
cpm_lanes_kernel(const float* __restrict__ w, const float* __restrict__ mask,
                 const float* __restrict__ p, const float* __restrict__ extra,
                 float* __restrict__ out, int B, int n, int n_iters, int vec) {
  constexpr int L = Lanes<NP>::L, C = Lanes<NP>::C;
  const int g = threadIdx.x % L;
  const int64_t b = (int64_t)blockIdx.x * Lanes<NP>::kRows + threadIdx.x / L;
  const bool live = b < B;
  const int v0 = g * C;
  const int64_t base = b * n * n;

  float wr[NP][C];
  if (vec && live) {
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      ldg_vec<C>(w + base + u * NP + v0, wr[u]);
      if (kMasked) {
        float mk[C];
        ldg_vec<C>(mask + base + u * NP + v0, mk);
#pragma unroll
        for (int c = 0; c < C; ++c) wr[u][c] = finite_or_neg(wr[u][c]) + mk[c];
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) wr[u][c] = finite_or_neg(wr[u][c]);
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < NP; ++u) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int v = v0 + c;
        float x = kNegInf;
        if (live && u < n && v < n) {
          const int64_t k = base + u * n + v;
          x = finite_or_neg(__ldg(w + k));
          if (kMasked) x = x + __ldg(mask + k);
        }
        wr[u][c] = x;
      }
    }
  }

  float d[C];
#pragma unroll
  for (int c = 0; c < C; ++c) d[c] = 0.0f;
  relax<NP>(wr, d, n_iters);

  if (kEpilogue) {
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int v = v0 + c;
      if (live && v < n) m = fmaxf(m, d[c] + __ldg(p + b * n + v));
    }
    m = group_max<L>(m);
    if (live && g == 0) out[b] = fmaxf(m, finite_or_neg(__ldg(extra + b)));
  } else if (live) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int v = v0 + c;
      if (v < n) out[b * n + v] = d[c];
    }
  }
}

// ---------------------------------------------------------------------------
// Front end B: the fleet's stage 1 from racks, instance ids and edge tables
// ---------------------------------------------------------------------------

struct FleetArgs {
  const int* racks;       // [B, n_pad]
  const int* inst_id;     // [B]
  const int64_t* src;     // [I, m_pad] edge source task (0 on padding)
  const int64_t* dst;     // [I, m_pad] edge destination task (0 on padding)
  const float* p_src;     // [I, m_pad] source-task duration
  const float* c_local;   // [I, m_pad] local delay (-inf on padding)
  const float* c_net;     // [I, m_pad] optimistic network duration
  const float* net_work;  // [I, m_pad] min network duration (0 on padding)
  const float* p_task;    // [I, n_pad] task durations (0 on padding)
  const float* chan_div;  // [I] 1 + |K|
  const float* pair_ok;   // [I, M_pad, M_pad] (masked body only)
  const float* uplift;    // [I, m_pad] forced-wired uplift (masked body only)
  float* out;             // [B]
  int B, n_pad, m_pad, M_pad, n_iters, contention;
};

// An edge's rack pair under the row's racks: co-located, and whether the
// pair shares a reachable subchannel (always, without a topology).
struct Pair {
  bool same, ok;
};

template <bool kTopo>
__device__ __forceinline__ Pair pair_of(const FleetArgs& a, int64_t i, int ru, int rv) {
  return Pair{ru == rv,
              !kTopo || __ldg(a.pair_ok + (i * a.M_pad + ru) * a.M_pad + rv) > 0.5f};
}

// The adjacency cell of edge ie = i * m_pad + e:
// finite_or_neg(where(same, c_local, c_net) + p_src), plus, in the masked
// body, the uplift where the pair is neither co-located nor connected.
template <bool kTopo>
__device__ __forceinline__ float edge_cell(const FleetArgs& a, int64_t ie, Pair q) {
  float cell = finite_or_neg((q.same ? __ldg(a.c_local + ie) : __ldg(a.c_net + ie)) +
                             __ldg(a.p_src + ie));
  if (kTopo) cell = cell + ((q.same || q.ok) ? 0.0f : __ldg(a.uplift + ie));
  return cell;
}

// The edge's terms of the work and forced sums: ne = net_work (+ uplift
// where not connected), counted unless co-located (forced: unless
// co-located or connected).
template <bool kTopo>
__device__ __forceinline__ void edge_terms(const FleetArgs& a, int64_t ie, Pair q,
                                           float& tw, float& tf) {
  float ne = __ldg(a.net_work + ie);
  if (kTopo) ne = ne + (q.ok ? 0.0f : __ldg(a.uplift + ie));
  tw = q.same ? 0.0f : ne;
  tf = (q.same || q.ok) ? 0.0f : ne;
}

// max_k load[k] of the row, load[k] a sequential sum over v of p[v] where
// rack[v] == k (src/repro/core/vectorized.py:_fleet_lb_device), by one
// thread. rk: the row's racks in shared memory.
__device__ float rack_load_max(const FleetArgs& a, const int* rk, int64_t i) {
  const float* pt = a.p_task + i * a.n_pad;
  float m = -INFINITY;
  for (int k = 0; k < a.M_pad; ++k) {
    float acc = 0.0f;
    for (int v = 0; v < a.n_pad; ++v) acc = acc + (rk[v] == k ? __ldg(pt + v) : 0.0f);
    m = fmaxf(m, acc);
  }
  return m;
}

template <bool kTopo>
__device__ __forceinline__ float contention_bound(const FleetArgs& a, int64_t i,
                                                  float lb_load, float work,
                                                  float forced) {
  float x = fmaxf(lb_load, __fdiv_rn(work, __ldg(a.chan_div + i)));
  if (kTopo) x = fmaxf(x, forced);
  return x;
}

// n_pad <= NP <= 32: L lanes a row, the tile in shared memory only while it
// is built.
template <int NP, bool kTopo>
__global__ void __launch_bounds__(kThreads, 2) cpm_fleet_kernel(const FleetArgs a) {
  constexpr int L = Lanes<NP>::L, C = Lanes<NP>::C, R = Lanes<NP>::kRows;
  extern __shared__ float smem[];
  const int g = threadIdx.x % L;
  const int r = threadIdx.x / L;
  const int64_t b = (int64_t)blockIdx.x * R + r;
  const bool live = b < a.B;
  const int n = a.n_pad;
  const int v0 = g * C;
  float* tile = smem + r * Lanes<NP>::kTile;
  int* rk = reinterpret_cast<int*>(smem + R * Lanes<NP>::kTile) + r * Lanes<NP>::kRack;
  // Rows past B relax an empty tile of instance 0 and write nothing.
  const int64_t i = live ? a.inst_id[b] : 0;

  for (int v = g; v < NP; v += L) rk[v] = (live && v < n) ? a.racks[b * n + v] : 0;
#pragma unroll
  for (int u = 0; u < NP; ++u) sts_fill<C>(tile + u * NP + v0, kNegInf);
  __syncwarp();

  // Edges in chunks of L, kU chunks at a time so that their loads are in
  // flight together: lane g scatters edge c0 + k*L + g and makes its
  // terms; the group then adds the terms in edge order (by shuffle), so
  // work and forced stay sequential sums over e.
  const int64_t e0 = i * a.m_pad;
  float work = 0.0f, forced = 0.0f;
  for (int c0 = 0; c0 < a.m_pad; c0 += kU * L) {
    int s[kU], t[kU];
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const int e = c0 + k * L + g;
      s[k] = e < a.m_pad ? (int)__ldg(a.src + e0 + e) : 0;
      t[k] = e < a.m_pad ? (int)__ldg(a.dst + e0 + e) : 0;
    }
    Pair q[kU];
#pragma unroll
    for (int k = 0; k < kU; ++k) q[k] = pair_of<kTopo>(a, i, rk[s[k]], rk[t[k]]);
    float tw[kU], tf[kU];
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const int e = c0 + k * L + g;
      tw[k] = tf[k] = 0.0f;
      if (e < a.m_pad) {
        if (live && s[k] != t[k]) tile[s[k] * NP + t[k]] = edge_cell<kTopo>(a, e0 + e, q[k]);
        edge_terms<kTopo>(a, e0 + e, q[k], tw[k], tf[k]);
      }
    }
    if (a.contention) {
#pragma unroll
      for (int k = 0; k < kU; ++k) {
#pragma unroll
        for (int j = 0; j < L; ++j) {
          const float xw = __shfl_sync(kFull, tw[k], j, L);
          const float xf = kTopo ? __shfl_sync(kFull, tf[k], j, L) : 0.0f;
          if (c0 + k * L + j < a.m_pad) {
            work = work + xw;
            if (kTopo) forced = forced + xf;
          }
        }
      }
    }
  }
  __syncwarp();

  float extra = -INFINITY;
  if (a.contention) {
    // Per-rack loads with the row's racks and durations in registers.
    int rv[NP];
    float pv[NP];
#pragma unroll
    for (int v = 0; v < NP; ++v) {
      rv[v] = rk[v];
      pv[v] = v < n ? __ldg(a.p_task + i * n + v) : 0.0f;
    }
    float lb_load = -INFINITY;
    for (int k = g; k < a.M_pad; k += L) {
      float acc = 0.0f;
#pragma unroll
      for (int v = 0; v < NP; ++v) {
        if (v < n) acc = acc + (rv[v] == k ? pv[v] : 0.0f);
      }
      lb_load = fmaxf(lb_load, acc);
    }
    extra = contention_bound<kTopo>(a, i, group_max<L>(lb_load), work, forced);
  }

  float w[NP][C];
#pragma unroll
  for (int u = 0; u < NP; ++u) lds_vec<C>(tile + u * NP + v0, w[u]);
  float d[C];
#pragma unroll
  for (int c = 0; c < C; ++c) d[c] = 0.0f;
  relax<NP>(w, d, a.n_iters);

  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int v = v0 + c;
    if (v < n) m = fmaxf(m, d[c] + __ldg(a.p_task + i * n + v));
  }
  m = group_max<L>(m);
  if (live && g == 0) a.out[b] = fmaxf(m, finite_or_neg(extra));
}

// ---------------------------------------------------------------------------
// n > 32: the shared-tile body, thread (r, v) owns dist[v] of row r
// ---------------------------------------------------------------------------

// n_iters Jacobi rounds over the block's staged [rows, n, n] tile, dist
// double-buffered in cur / nxt; returns this thread's dist[v], with cur
// holding the last round and nxt free.
__device__ float relax_tile(const float* tile, float*& cur, float*& nxt, int n,
                            int r, int v, int n_iters) {
  const int tid = r * n + v;
  cur[tid] = 0.0f;
  __syncthreads();
  const float* col = tile + (size_t)r * n * n + v;  // w[r][u][v] at col[u * n]
  for (int it = 0; it < n_iters; ++it) {
    const float* d = cur + r * n;
    float best = d[v];
    for (int u = 0; u < n; ++u) best = fmaxf(best, d[u] + col[u * n]);
    nxt[tid] = best;
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur[tid];
}

// max_v term[v] of row r through the free buffer s; valid on thread v == 0.
__device__ float row_max(float* s, int n, int r, int v, float term) {
  s[r * n + v] = term;
  __syncthreads();
  float m = -INFINITY;
  if (v == 0) {
    m = s[r * n];
    for (int u = 1; u < n; ++u) m = fmaxf(m, s[r * n + u]);
  }
  return m;
}

template <bool kMasked, bool kEpilogue>
__global__ void cpm_rows_kernel(const float* __restrict__ w,
                                const float* __restrict__ mask,
                                const float* __restrict__ p,
                                const float* __restrict__ extra,
                                float* __restrict__ out, int B, int n,
                                int n_iters, int rows) {
  extern __shared__ float smem[];
  const int nn = n * n;
  float* tile = smem;                       // [rows, n, n]: w (+ mask)
  float* cur = tile + (size_t)rows * nn;    // [rows, n]: dist, this round
  float* nxt = cur + rows * n;              // [rows, n]: dist, next round
  const int tid = threadIdx.x;              // == r * n + v
  const int r = tid / n;
  const int v = tid - r * n;
  const int64_t b0 = (int64_t)blockIdx.x * rows;
  const int64_t b = b0 + r;
  const bool live = b < B;

  // Stage the block's contiguous rows of w (+ mask): coalesced, ragged tail
  // masked.
  const int64_t base = b0 * nn;
  const int64_t total = (int64_t)B * nn;
  for (int k = tid; k < rows * nn; k += blockDim.x) {
    const int64_t q = base + k;
    float x = kNegInf;
    if (q < total) {
      x = finite_or_neg(w[q]);
      if (kMasked) x = x + mask[q];
    }
    tile[k] = x;
  }
  const float dv = relax_tile(tile, cur, nxt, n, r, v, n_iters);

  if (kEpilogue) {
    const float m = row_max(nxt, n, r, v, live ? dv + p[b * n + v] : 0.0f);
    if (live && v == 0) out[b] = fmaxf(m, finite_or_neg(extra[b]));
  } else if (live) {
    out[b * n + v] = dv;
  }
}

template <bool kTopo>
__global__ void cpm_fleet_rows_kernel(const FleetArgs a, int rows) {
  extern __shared__ float smem[];
  const int n = a.n_pad, nn = n * n;
  float* tile = smem;                       // [rows, n, n]
  float* cur = tile + (size_t)rows * nn;    // [rows, n]
  float* nxt = cur + rows * n;              // [rows, n]
  float* ext = nxt + rows * n;              // [rows]: the contention bound
  int* rk = reinterpret_cast<int*>(ext + rows);  // [rows, n]: racks
  const int tid = threadIdx.x;
  const int r = tid / n;
  const int v = tid - r * n;
  const int64_t b = (int64_t)blockIdx.x * rows + r;
  const bool live = b < a.B;
  const int64_t i = live ? a.inst_id[b] : 0;

  for (int k = tid; k < rows * nn; k += blockDim.x) tile[k] = kNegInf;
  rk[tid] = live ? a.racks[b * n + v] : 0;
  __syncthreads();
  const int* rkr = rk + r * n;
  const int64_t e0 = i * a.m_pad;
  if (live) {
    for (int e = v; e < a.m_pad; e += n) {
      const int s = (int)__ldg(a.src + e0 + e);
      const int t = (int)__ldg(a.dst + e0 + e);
      if (s != t) {
        tile[(size_t)r * nn + s * n + t] =
            edge_cell<kTopo>(a, e0 + e, pair_of<kTopo>(a, i, rkr[s], rkr[t]));
      }
    }
  }
  if (v == 0) {
    // The row's contention bound, by one thread in the reference's order.
    float extra = -INFINITY;
    if (a.contention) {
      float work = 0.0f, forced = 0.0f;
      for (int e = 0; e < a.m_pad; ++e) {
        const Pair q = pair_of<kTopo>(a, i, rkr[__ldg(a.src + e0 + e)],
                                      rkr[__ldg(a.dst + e0 + e)]);
        float tw, tf;
        edge_terms<kTopo>(a, e0 + e, q, tw, tf);
        work = work + tw;
        if (kTopo) forced = forced + tf;
      }
      extra = contention_bound<kTopo>(a, i, rack_load_max(a, rkr, i), work, forced);
    }
    ext[r] = extra;
  }
  // relax_tile's first barrier also publishes the scattered tile and ext.
  const float dv = relax_tile(tile, cur, nxt, n, r, v, a.n_iters);
  const float m = row_max(nxt, n, r, v, dv + __ldg(a.p_task + i * n + v));
  if (live && v == 0) a.out[b] = fmaxf(m, finite_or_neg(ext[r]));
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

int rows_per_block(int n, int row_bytes) {
  int rows = kThreads / n;
  const int by_smem = kSmemTarget / row_bytes;
  if (by_smem < rows) rows = by_smem;
  return rows < 1 ? 1 : rows;
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <int NP, bool kMasked, bool kEpilogue>
int launch_lanes(const float* w, const float* mask, const float* p,
                 const float* extra, float* out, int B, int n, int n_iters,
                 void* stream) {
  constexpr int R = Lanes<NP>::kRows;
  constexpr uintptr_t kAlign = Lanes<NP>::C * sizeof(float);
  const int vec = n == NP && (uintptr_t)w % kAlign == 0 &&
                  (!kMasked || (uintptr_t)mask % kAlign == 0);
  const int grid = (int)(((int64_t)B + R - 1) / R);
  cpm_lanes_kernel<NP, kMasked, kEpilogue><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      w, mask, p, extra, out, B, n, n_iters, vec);
  return (int)cudaGetLastError();
}

template <bool kMasked, bool kEpilogue>
int launch(const float* w, const float* mask, const float* p,
           const float* extra, float* out, int B, int n, int n_iters,
           void* stream) {
  if (B <= 0) return 0;
  if (n <= 8) return launch_lanes<8, kMasked, kEpilogue>(w, mask, p, extra, out, B, n, n_iters, stream);
  if (n <= 16) return launch_lanes<16, kMasked, kEpilogue>(w, mask, p, extra, out, B, n, n_iters, stream);
  if (n <= 32) return launch_lanes<32, kMasked, kEpilogue>(w, mask, p, extra, out, B, n, n_iters, stream);
  const int rows = rows_per_block(n, (n * n + 2 * n) * (int)sizeof(float));
  const size_t smem = ((size_t)rows * n * n + 2 * (size_t)rows * n) * sizeof(float);
  const int err = set_smem(cpm_rows_kernel<kMasked, kEpilogue>, smem);
  if (err != 0) return err;
  const int grid = (int)(((int64_t)B + rows - 1) / rows);
  cpm_rows_kernel<kMasked, kEpilogue>
      <<<grid, rows * n, smem, (cudaStream_t)stream>>>(w, mask, p, extra, out,
                                                       B, n, n_iters, rows);
  return (int)cudaGetLastError();
}

template <int NP, bool kTopo>
int launch_fleet_lanes(const FleetArgs& a, void* stream) {
  constexpr int R = Lanes<NP>::kRows;
  constexpr size_t smem = (size_t)R * (Lanes<NP>::kTile + Lanes<NP>::kRack) * sizeof(float);
  // Once per instantiation: the size is a constant (and a call stays legal
  // inside a CUDA graph capture).
  static const int err = set_smem(cpm_fleet_kernel<NP, kTopo>, smem);
  if (err != 0) return err;
  const int grid = (int)(((int64_t)a.B + R - 1) / R);
  cpm_fleet_kernel<NP, kTopo><<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kTopo>
int launch_fleet(const FleetArgs& a, void* stream) {
  if (a.B <= 0) return 0;
  const int n = a.n_pad;
  if (n <= 8) return launch_fleet_lanes<8, kTopo>(a, stream);
  if (n <= 16) return launch_fleet_lanes<16, kTopo>(a, stream);
  if (n <= 32) return launch_fleet_lanes<32, kTopo>(a, stream);
  const int row_bytes = (n * n + 4 * n + 1) * (int)sizeof(float);
  const int rows = rows_per_block(n, row_bytes);
  const size_t smem = (size_t)rows * row_bytes;
  const int err = set_smem(cpm_fleet_rows_kernel<kTopo>, smem);
  if (err != 0) return err;
  const int grid = (int)(((int64_t)a.B + rows - 1) / rows);
  cpm_fleet_rows_kernel<kTopo><<<grid, rows * n, smem, (cudaStream_t)stream>>>(a, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// lb[B] = max(max_v dist[v] + p[v], extra) over w[B, n, n].
int cpm_combined_lb(const float* w, const float* p, const float* extra,
                    float* out, int B, int n, int n_iters, void* stream) {
  return launch<false, true>(w, nullptr, p, extra, out, B, n, n_iters, stream);
}

// The same over w + mask (forced-wired uplift), mask[B, n, n].
int cpm_combined_lb_masked(const float* w, const float* mask, const float* p,
                           const float* extra, float* out, int B, int n,
                           int n_iters, void* stream) {
  return launch<true, true>(w, mask, p, extra, out, B, n, n_iters, stream);
}

// dist[B, n] after n_iters rounds, no epilogue.
int cpm_critical_path(const float* w, float* out, int B, int n, int n_iters,
                      void* stream) {
  return launch<false, false>(w, nullptr, nullptr, nullptr, out, B, n, n_iters,
                              stream);
}

// Stage 1 of the fleet engine: lb[B] from int32 racks [B, n_pad] and
// inst_id [B] and the per-instance tables of
// core/vectorized.py:_build_lb_arrays. contention = 0 disables the
// contention bound (extra = -inf).
int cpm_fleet_lb(const int* racks, const int* inst_id, const int64_t* src,
                 const int64_t* dst, const float* p_src, const float* c_local,
                 const float* c_net, const float* net_work, const float* p_task,
                 const float* chan_div, float* out, int B, int n_pad, int m_pad,
                 int M_pad, int n_iters, int contention, void* stream) {
  const FleetArgs a{racks, inst_id, src, dst, p_src, c_local, c_net, net_work,
                    p_task, chan_div, nullptr, nullptr, out, B, n_pad, m_pad,
                    M_pad, n_iters, contention};
  return launch_fleet<false>(a, stream);
}

// The same under a topology: pair_ok [I, M_pad, M_pad], uplift [I, m_pad].
int cpm_fleet_lb_masked(const int* racks, const int* inst_id, const int64_t* src,
                        const int64_t* dst, const float* p_src,
                        const float* c_local, const float* c_net,
                        const float* net_work, const float* p_task,
                        const float* chan_div, const float* pair_ok,
                        const float* uplift, float* out, int B, int n_pad,
                        int m_pad, int M_pad, int n_iters, int contention,
                        void* stream) {
  const FleetArgs a{racks, inst_id, src, dst, p_src, c_local, c_net, net_work,
                    p_task, chan_div, pair_ok, uplift, out, B, n_pad, m_pad,
                    M_pad, n_iters, contention};
  return launch_fleet<true>(a, stream);
}

}  // extern "C"
