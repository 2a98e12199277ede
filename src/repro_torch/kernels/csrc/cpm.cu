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
// stage 1 is one launch; they relax over the DAG's edges instead of the
// dense adjacency, with the same bits (front end B below).
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
// The relaxation core of front end A (n <= 32). A row is owned by a group of L lanes of one
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
// in one launch, for any n_pad. It reads each row's int16 racks and int32
// instance id and the instances' tables packed once a fleet
// (cpm.py:pack_lb_tables, layout cpm.py:lb_layout): a record an edge (src |
// dst, the co-located and the cross-rack cell, finite_or_neg(c + p_src) made
// by the host's one float32 add, and net_work), the DAG's in-edge lists by
// destination column, the durations, chan_div and, under a topology, the
// uplift and each rack's 32-bit connectivity mask (past 32 racks the float
// pair_ok table of the blob). Which cell an edge fills is the same for every
// row of an instance; only the rows' racks differ. So the structure is built
// once a fleet, and a row's work is in proportion to its DAG's edges, not
// to n_pad^2: no tile is filled, scattered or read back.
//  - One thread a row, its state in shared memory as [slot][row] (racks,
//    each edge's cell, two rounds of dist): a warp's rows read one slot at
//    32 consecutive words, and all walk the same lists in step when the
//    block's rows share an instance, as they do at the
//    engine's launches (8,192 or 512 rows an instance). One thread starts
//    two 1-D bulk copies (TMA) on an mbarrier: the block's int16 racks and
//    its first row's kernel section. A row of another instance walks its
//    own blob through the read-only cache with the same template.
//  - The edges in edge order give each cell (where(same, co-located,
//    cross-rack), plus the uplift where neither co-located nor connected)
//    and the work (and forced) terms, summed in edge order as the reference
//    sums them (an edge with src == dst adds 0 and no list holds it); the
//    per-rack loads add each task's duration into its rack's register, 8
//    racks at a time, in task order (the reference's other adds are of
//    +0.0); then max(lb_load, __fdiv_rn(work, chan_div)) (and forced).
//  - The rounds relax over the in-edge lists. The dense round's max over
//    every u also takes dist[u] + -1e30 from each absent cell: with
//    rounding monotone, all those terms together are T = M + -1e30 (M the
//    largest dist) or below it, and an edge's own term is never below its
//    source's absent-cell term (the pack refuses cells under -1e30). So
//    dist'[v] = max(dist[v], T, the in-edges' terms) is the dense round bit
//    for bit; tasks without in-edges (the DAG's sources and the padding)
//    always share one dist and are one column, whose epilogue term takes
//    their largest duration. A row stops after depth rounds (the most edges
//    on a path: every path taken) while M <= 1e30 (T then decides nothing),
//    else after its first round that changes no bit; both are the fixed
//    point the dense rounds reach.
//  - Rows a block: 128, 64, 32 or 16, the largest that still gives every SM
//    a block (128 at the offline shape, 16 at the serving shape's 4,096
//    rows: 256 blocks), fewer where a row's state is large.
// What bounds it: a launch must read the rows' racks and ids and the
// instances' kernel sections and write a float a row, 5.3 MB at the
// offline shape (B 131,072, n_pad 16), 1.6 us at 3.35 TB/s; its float work
// is about 20 adds and maxes a row a round. Neither sets its time: the
// launch and the blocks' set-up (the bulk copies' round trip, the racks'
// move) take about 60% of it offline and half at the serving shape, the
// walk's chain through shared memory the rest (chip_smoke.py's
// fleet_lb_parts).

#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // cpm.py:NEG_INF
constexpr float kFltMax = 3.402823466e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;      // threads a block (front end A)
constexpr int kSmemTarget = 48 * 1024;

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
// Front end B: the fleet's stage 1 from int16 racks, instance ids and the
// packed edge tables (kernels/cpm.py:pack_lb_tables)
// ---------------------------------------------------------------------------

constexpr int kTopoNone = 0, kTopoMasks = 1, kTopoTable = 2;  // cpm.py TOPO_*
constexpr int kMaskRacks = 32;       // cpm.py MAX_MASK_RACKS
constexpr int kLoadRacks = 8;        // per-rack loads in registers at a time
constexpr int kFleetRowsMax = 128;
constexpr int kFleetRowsMin = 16;    // the serving shape's 4,096 rows on 132 SMs
// Largest shared memory a block may ask for on sm_90 (227 KB), the target
// a block's rows stay under, and the largest kernel section a block stages.
constexpr int kSmemMax = 232448;
constexpr int kFleetSmemTarget = 96 * 1024;
constexpr int kBlobMax = 32 * 1024;
constexpr int kMaxDevices = 64;

// Word offsets in one instance's blob (cpm.py:lb_layout).
struct Layout {
  int rec, col_cnt, col_p, col_in, p_task, uplift, mask, kernel_words, pair_ok, words;
};

__host__ __device__ __forceinline__ int quad(int words) { return (words + 3) / 4 * 4; }

__host__ __device__ inline Layout fleet_layout(int n_pad, int m_pad, int M_pad, int topo) {
  Layout l;
  l.rec = 8;
  l.col_cnt = l.rec + 4 * m_pad;
  l.col_p = l.col_cnt + n_pad + 1;
  l.col_in = l.col_p + n_pad + 1;
  l.p_task = l.col_in + m_pad;
  l.uplift = l.p_task + n_pad;
  l.mask = l.uplift + (topo != kTopoNone ? m_pad : 0);
  l.kernel_words = quad(l.mask + (topo == kTopoMasks ? M_pad : 0));
  l.pair_ok = l.kernel_words + 3 * m_pad;  // after c_local, c_net, p_src
  l.words = quad(l.pair_ok + (topo != kTopoNone ? M_pad * M_pad : 0));
  return l;
}

// Words of one row's state (cpm.py:fleet_state_words): its racks [n_pad],
// edge cells [m_pad] and two rounds of dist [n_pad + 1].
__host__ __device__ __forceinline__ int fleet_state_words(int n_pad, int m_pad) {
  return 3 * n_pad + 2 + m_pad;
}

struct FleetArgs {
  const int16_t* rack;  // [B, n_pad]
  const int* inst_id;   // [B]
  const int* blob;      // [I, l.words]
  float* out;           // [B]
  int B, n_pad, m_pad, M_pad, topo, n_iters, contention;
  Layout l;
  int stage;       // 1: a block stages its first row's kernel section
  int bulk_racks;  // 1: the block's racks come by one bulk copy (n_pad % 8 == 0)
};

// A load from the staged kernel section (shared memory) or in place
// (read-only cache).
template <bool kShared, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// One row's state, each slot R words after the last (a warp's rows on 32
// consecutive words).
struct RowState {
  int* rk;      // [n_pad] racks
  float* w;     // [m_pad] the row's adjacency cell of each edge
  float* cur;   // [n_pad + 1] dist of each relaxation column
  float* nxt;   // [n_pad + 1] the next round's
  int R;
};

// The row's bound from its instance's kernel section kb.
template <int kTopo, bool kShared>
__device__ float fleet_row(const int* kb, const float* pair_ok, const FleetArgs& a,
                           RowState s) {
  // The runtime loops stay rolled (#pragma unroll 1): unrolled, they took
  // more registers, and ptxas spilled some of them, for no gain measured.
  const Layout& l = a.l;
  const int R = s.R;
  const int n_cols = ld<kShared>(kb), m_walk = ld<kShared>(kb + 1);
  const int n_loads = ld<kShared>(kb + 2);
  const float chan_div = __int_as_float(ld<kShared>(kb + 3));
  const int depth = ld<kShared>(kb + 4);
  const int4* rec = reinterpret_cast<const int4*>(kb + l.rec);

  // The edges in edge order: each one's cell into w[e], its work and
  // forced terms added as the reference adds them (an edge with src ==
  // dst is co-located: it adds 0 to both, and no column lists it).
  float work = 0.0f, forced = 0.0f;
#pragma unroll 1
  for (int e = 0; e < m_walk; ++e) {
    const int4 q = ld<kShared>(rec + e);
    const int ru = s.rk[(q.x & 0xFFFF) * R];
    const int rv = s.rk[((unsigned)q.x >> 16) * R];
    const bool same = ru == rv;
    float cell = __int_as_float(same ? q.y : q.z);
    if constexpr (kTopo != kTopoNone) {
      bool ok;
      if constexpr (kTopo == kTopoMasks) {
        ok = ((unsigned)ld<kShared>(kb + l.mask + ru) >> rv) & 1u;
      } else {
        ok = __ldg(pair_ok + ru * a.M_pad + rv) > 0.5f;
      }
      const float up = __int_as_float(ld<kShared>(kb + l.uplift + e));
      cell = cell + ((same || ok) ? 0.0f : up);
      if (a.contention) {
        const float ne = __int_as_float(q.w) + (ok ? 0.0f : up);
        work = work + (same ? 0.0f : ne);
        forced = forced + ((same || ok) ? 0.0f : ne);
      }
    } else if (a.contention) {
      work = work + (same ? 0.0f : __int_as_float(q.w));
    }
    s.w[e * R] = cell;
  }

  // Per-rack loads, each the tasks' durations in task order, in registers
  // for kLoadRacks racks at a time (the reference's other adds are of
  // +0.0, which change no bit; tasks from n_loads on have duration 0),
  // then the contention bound.
  float extra = -INFINITY;
  if (a.contention) {
    const float* pt = reinterpret_cast<const float*>(kb + l.p_task);
    float lb_load = -INFINITY;
#pragma unroll 1
    for (int k0 = 0; k0 < a.M_pad; k0 += kLoadRacks) {
      float load[kLoadRacks];
#pragma unroll
      for (int j = 0; j < kLoadRacks; ++j) load[j] = 0.0f;
#pragma unroll 1
      for (int v = 0; v < n_loads; ++v) {
        const int k = s.rk[v * R] - k0;
        const float p = ld<kShared>(pt + v);
#pragma unroll
        for (int j = 0; j < kLoadRacks; ++j)
          if (k == j) load[j] = load[j] + p;
      }
#pragma unroll
      for (int j = 0; j < kLoadRacks; ++j)
        if (k0 + j < a.M_pad) lb_load = fmaxf(lb_load, load[j]);
    }
    extra = fmaxf(lb_load, __fdiv_rn(work, chan_div));
    if (kTopo != kTopoNone) extra = fmaxf(extra, forced);
  }

  // Jacobi rounds over the relaxation columns: a task with in-edges, or
  // the one column of all tasks without (their dist is always equal). A
  // task u with no edge into v offers dist[u] + -1e30 (the absent cell);
  // rounding is monotone, so the largest such offer is at most T = M +
  // -1e30 (M the largest dist), which some u reaches; an edge's offer
  // dist[u] + cell (cell >= -1e30, pack_lb_tables) is never below u's
  // absent-cell offer. So max(dist[v], T, the in-edges' offers) is the
  // dense round's max over every u, bit for bit, whatever the dists.
  const int* cnt = kb + l.col_cnt;
  const int* cin = kb + l.col_in;
  const float* cp = reinterpret_cast<const float*>(kb + l.col_p);
  float* cur = s.cur;
  float* nxt = s.nxt;
#pragma unroll 1
  for (int j = 0; j < n_cols; ++j) cur[j * R] = 0.0f;
  float M = 0.0f;
#pragma unroll 1
  for (int it = 0; it < a.n_iters; ++it) {
    // After `depth` rounds every path has been taken; with M <= 1e30 the
    // absent cells' term T is at most 0 <= dist and never decided a
    // column, so the rows are at their fixed point.
    if (it >= depth && M <= -kNegInf) break;
    const float T = M + kNegInf;
    float next_M = -INFINITY;
    bool changed = false;
    int k = 0;
#pragma unroll 1
    for (int j = 0; j < n_cols; ++j) {
      const float dj = cur[j * R];
      float acc = fmaxf(dj, T);
      const int k_end = k + ld<kShared>(cnt + j);
#pragma unroll 1
      for (; k < k_end; ++k) {
        const int ent = ld<kShared>(cin + k);
        acc = fmaxf(acc, cur[(ent & 0xFFFF) * R] + s.w[((unsigned)ent >> 16) * R]);
      }
      nxt[j * R] = acc;
      changed |= __float_as_uint(acc) != __float_as_uint(dj);
      next_M = fmaxf(next_M, acc);
    }
    float* t = cur;
    cur = nxt;
    nxt = t;
    M = next_M;
    // A round that changes no bit is a fixed point: every later one
    // repeats it.
    if (!changed) break;
  }

  // max_v dist[v] + p[v]: the column of tasks without in-edges carries
  // their largest duration (dist + p is monotone in p).
  float m = -INFINITY;
#pragma unroll 1
  for (int j = 0; j < n_cols; ++j) m = fmaxf(m, cur[j * R] + ld<kShared>(cp + j));
  return fmaxf(m, finite_or_neg(extra));
}

template <int kTopo>
__global__ void __launch_bounds__(kFleetRowsMax) cpm_fleet_kernel(const FleetArgs a) {
  // [the mbarrier, one quad][the staged kernel section][the rows' state]
  extern __shared__ int4 fsmem[];
  const int R = blockDim.x;
  const int r = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * R;
  const int n_rows = a.B - row0 < R ? (int)(a.B - row0) : R;
  const bool live = r < n_rows;
  int* staged = reinterpret_cast<int*>(fsmem + 1);
  int* rk = staged + (a.stage ? a.l.kernel_words : 0);
  float* w = reinterpret_cast<float*>(rk + (size_t)a.n_pad * R);
  float* d0 = w + (size_t)a.m_pad * R;
  float* d1 = d0 + (size_t)(a.n_pad + 1) * R;
  const int i0 = __ldg(a.inst_id + row0);
  const int i = live ? __ldg(a.inst_id + row0 + r) : i0;

  // One thread starts the bulk copies (TMA) on an mbarrier: the block's
  // int16 racks as they lie in global memory, over the state from w on,
  // and its first row's kernel section.
  if (a.stage || a.bulk_racks) {
    const uint32_t bar = sm90::smem_addr(fsmem);
    if (r == 0) {
      sm90::mbar_init(bar, 1);
      sm90::mbar_fence_init();
    }
    __syncthreads();
    if (r == 0) {
      const uint32_t rack_bytes =
          a.bulk_racks ? (uint32_t)n_rows * a.n_pad * (uint32_t)sizeof(int16_t) : 0u;
      const uint32_t blob_bytes = a.stage ? (uint32_t)a.l.kernel_words * 4u : 0u;
      sm90::mbar_expect_tx(bar, rack_bytes + blob_bytes);
      if (a.bulk_racks)
        sm90::bulk_load(sm90::smem_addr(w), a.rack + row0 * a.n_pad, rack_bytes, bar);
      if (a.stage)
        sm90::bulk_load(sm90::smem_addr(staged), a.blob + (size_t)i0 * a.l.words, blob_bytes,
                        bar);
    }
    sm90::mbar_wait(bar, 0);
  }
  // Each thread moves its row's racks into rk, starting at its own word so
  // that lanes fall on different banks.
  if (live) {
    if (a.bulk_racks) {
      const int P = a.n_pad / 2;
      const int* src = reinterpret_cast<const int*>(w) + r * P;
      int j = r % P;
      for (int it = 0; it < P; ++it) {
        const int wd = src[j];
        rk[(2 * j) * R + r] = (int16_t)(wd & 0xFFFF);
        rk[(2 * j + 1) * R + r] = wd >> 16;
        j = j + 1 == P ? 0 : j + 1;
      }
    } else {
      for (int v = 0; v < a.n_pad; ++v) rk[v * R + r] = a.rack[(row0 + r) * a.n_pad + v];
    }
  }
  __syncthreads();
  if (!live) return;
  const int* blob_i = a.blob + (size_t)i * a.l.words;
  const float* pair_ok = reinterpret_cast<const float*>(blob_i + a.l.pair_ok);
  const RowState s{rk + r, w + r, d0 + r, d1 + r, R};
  a.out[row0 + r] = a.stage && i == i0 ? fleet_row<kTopo, true>(staged, pair_ok, a, s)
                                       : fleet_row<kTopo, false>(blob_i, pair_ok, a, s);
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

struct FleetLaunch {
  int rows, blocks, stage;
  size_t smem;
};

// Rows a block: the largest of 128, 64, 32, 16 that gives every SM a block
// (or 16), halved while the state passes kFleetSmemTarget. The block stages
// its instance's kernel section when it is at most kBlobMax and fits
// beside the state.
FleetLaunch fleet_plan(const FleetArgs& a, int sms) {
  const int words = fleet_state_words(a.n_pad, a.m_pad);
  int rows = kFleetRowsMax;
  while (rows > kFleetRowsMin && ((int64_t)a.B + rows - 1) / rows < sms) rows /= 2;
  while (rows > 1 && (size_t)rows * words * sizeof(float) > (size_t)kFleetSmemTarget)
    rows /= 2;
  const size_t state = 16 + (size_t)rows * words * sizeof(float);
  const size_t blob = (size_t)a.l.kernel_words * 4;
  const int stage = blob <= (size_t)kBlobMax && state + blob <= (size_t)kSmemMax;
  return FleetLaunch{rows, (int)(((int64_t)a.B + rows - 1) / rows), stage,
                     state + (stage ? blob : 0)};
}

FleetArgs fleet_args(const int16_t* rack, const int* inst_id, const int* blob, float* out,
                     int B, int n_pad, int m_pad, int M_pad, int topo, int n_iters,
                     int contention) {
  return FleetArgs{rack, inst_id, blob, out, B, n_pad, m_pad, M_pad, topo, n_iters,
                   contention, fleet_layout(n_pad, m_pad, M_pad, topo), 0, n_pad % 8 == 0};
}

bool fleet_valid(const FleetArgs& a) {
  return a.n_pad >= 1 && a.n_pad <= 0xFFFF && a.m_pad >= 0 && a.m_pad <= 0x10000 &&
         a.M_pad >= 1 && a.topo >= kTopoNone && a.topo <= kTopoTable &&
         (a.topo != kTopoMasks || a.M_pad <= kMaskRacks) &&
         16 + (size_t)fleet_state_words(a.n_pad, a.m_pad) * sizeof(float) <=
             (size_t)kSmemMax &&
         reinterpret_cast<uintptr_t>(a.rack) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.blob) % 16 == 0;
}

// Once a device and body: the kernel may take up to kSmemMax bytes of
// dynamic shared memory (a constant, so a call stays legal inside a CUDA
// graph capture).
template <int kTopo>
int allow_fleet_smem() {
  static int set[kMaxDevices] = {0};
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev < kMaxDevices && set[dev]) return 0;
  err = set_smem(cpm_fleet_kernel<kTopo>, kSmemMax);
  if (err == 0 && dev < kMaxDevices) set[dev] = 1;
  return err;
}

template <int kTopo>
int launch_fleet(FleetArgs a, void* stream) {
  const int err = allow_fleet_smem<kTopo>();
  if (err != 0) return err;
  const int sms = sm90::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const FleetLaunch l = fleet_plan(a, sms);
  a.stage = l.stage;
  cpm_fleet_kernel<kTopo><<<l.blocks, l.rows, l.smem, (cudaStream_t)stream>>>(a);
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

// Stage 1 of the fleet engine: lb[B] from int16 racks [B, n_pad], int32
// inst_id [B] and the packed tables (int32 [I, words],
// cpm.py:pack_lb_tables) without a topology (topo 0). contention = 0
// disables the contention bound (extra = -inf). Launches on `stream` of
// the current device.
int cpm_fleet_lb(const int16_t* rack, const int* inst_id, const int* blob, float* out,
                 int B, int n_pad, int m_pad, int M_pad, int topo, int n_iters,
                 int contention, void* stream) {
  const FleetArgs a = fleet_args(rack, inst_id, blob, out, B, n_pad, m_pad, M_pad, topo,
                                 n_iters, contention);
  if (B <= 0) return 0;
  if (!fleet_valid(a) || topo != kTopoNone) return (int)cudaErrorInvalidValue;
  return launch_fleet<kTopoNone>(a, stream);
}

// The same under a topology: topo 1 reads each rack's connectivity mask,
// topo 2 the float pair_ok table of the blob.
int cpm_fleet_lb_masked(const int16_t* rack, const int* inst_id, const int* blob, float* out,
                        int B, int n_pad, int m_pad, int M_pad, int topo, int n_iters,
                        int contention, void* stream) {
  const FleetArgs a = fleet_args(rack, inst_id, blob, out, B, n_pad, m_pad, M_pad, topo,
                                 n_iters, contention);
  if (B <= 0) return 0;
  if (!fleet_valid(a) || topo == kTopoNone) return (int)cudaErrorInvalidValue;
  return topo == kTopoMasks ? launch_fleet<kTopoMasks>(a, stream)
                            : launch_fleet<kTopoTable>(a, stream);
}

// The launch cpm_fleet_lb(_masked) makes on the current device for these
// sizes: out[0..4] = rows a block, blocks, staged kernel section (0 / 1),
// dynamic shared memory bytes, the device's SMs.
int cpm_fleet_plan(int B, int n_pad, int m_pad, int M_pad, int topo, int* out) {
  const FleetArgs a = fleet_args(nullptr, nullptr, nullptr, nullptr, B, n_pad, m_pad, M_pad,
                                 topo, 0, 1);
  if (B <= 0 || !fleet_valid(a)) return (int)cudaErrorInvalidValue;
  const int sms = sm90::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const FleetLaunch l = fleet_plan(a, sms);
  out[0] = l.rows;
  out[1] = l.blocks;
  out[2] = l.stage;
  out[3] = (int)l.smem;
  out[4] = sms;
  return 0;
}

}  // extern "C"
