// Stage 2 of the scheduler's fleet engine, the greedy non-delay evaluator,
// for Hopper (sm_90a). Plain C interface, loaded with ctypes by
// repro_torch/kernels/stage2.py.
//
// Replaces no Pallas kernel: it is the JAX package's other device program on
// the scheduler's path, src/repro/core/vectorized.py:_scan_evaluate (a
// lax.scan over the padded op tables under jit, shard_map over the local
// devices), which XLA compiles to one program a call. The port's plain
// version (repro_torch/kernels/ref.py:ref_fleet_evaluate) walks the same
// tables from the host with about 25 PyTorch ops a table row; this kernel is
// the whole walk in one launch.
//
// Per candidate row b, with i = inst_id[b], the row's state starts as
//     rack_free[M_pad] = 0, chan_free[n_chan] = chan_free0[i],
//     task_fin[n_pad] = 0, edge_fin[m_pad + 1] = 0
// (column m_pad of edge_fin is the sentinel no edge writes), and each of the
// n_ops op-table rows t of instance i is one step that reads the pre-step
// state, exactly as the reference's scan body:
//   OP_TASK  fin = max(max_k edge_fin[op_in[k]], rack_free[rack[v]]) + p;
//            rack_free[rack[v]] = task_fin[v] = fin
//   OP_EDGE  ready = task_fin[u]; co-located (rack[u] == rack[v]):
//            fin = ready + r_local; otherwise every channel c gets
//            f_c = max(ready, chan_free[c]) + (c == 0 ? q_wired : q_wireless),
//            +inf where reach[i, rack[u], c] * reach[i, rack[v], c] > 0 fails,
//            the lowest c of the least f_c wins (argmin's tie rule),
//            chan_free[c] = f_c and fin = f_c; edge_fin[e] = fin
//   OP_PAD   nothing.
// The row's makespan is max_v task_fin[v]. Every operation is a float32 max,
// add, compare or the 0/1 reach product, taken by __fadd_rn / __fmul_rn (no
// contraction) in the reference's order, so the scores equal the plain
// version and the JAX package bit for bit; +inf (a masked channel) stays
// +inf through the adds and is never chosen over channel 0, which is always
// finite. The walk stops after an instance's last task or edge row: the
// OP_PAD rows after it change nothing.
//
// Inputs. The racks come as int16 [B, n_pad] (the wrapper's state limit
// caps M_pad at 32,768, so every rack id fits) and the instance ids as int32.
// The op tables come packed once a fleet (stage2.py:pack_tables) into one
// blob an instance, S4 16-byte quads: n_ops records of Q quads,
//   quad 0  kind | task << 16, src | dst << 16, edge | n_read << 16, p
//   quad 1  local, wired, wireless, 0
//   quad 2+ the in-edge ids, one a word (n_read: the ids up to the last
//           first occurrence of an id, all a max needs),
// then n_live (the rows up to the last task or edge), chan_free0[n_chan],
// reach[M_pad, n_chan] (floats as their bits) and mask[M_pad], each rack's
// channels with reach 1 (bit c). The reach the kernel takes is 0 or 1
// (stage2.py refuses other values on the card), so reach[a, c] * reach[b, c]
// > 0 exactly when bit c is set in mask[a] & mask[b].
//
// Design. One thread a row; a row's state lives in dynamic shared memory
// laid out [slot][row] (a warp's rows read one slot at 32 consecutive words,
// a rack-indexed slot at rack * R + row: no two lanes share a bank whatever
// their racks). A row's walk is a chain: every step reads state that the
// step before may have written, so a step's time is its instruction chain
// (one warp an SM sub-partition at the serving shape issues them one after
// another; chip_smoke.py's stage2_steps line measures a step). So:
//  - The block's rows belong to one instance at the engine's launches (8,192
//    or 512 rows an instance, multiples of any R). One thread starts two 1-D
//    bulk copies (TMA) on an mbarrier: the block's int16 racks, and its first
//    row's instance blob (records, chan_free0, reach, masks) when it fits.
//    A row of another instance reads its own blob through the read-only
//    cache: the walk is one template on either pointer.
//  - A step first reads its state (for either kind: every address is valid
//    whatever the row's kind, and a task reads only its n_read in-edge ids,
//    most 1 to 4 of indeg_pad 16); then, while those reads are in flight,
//    it loads what no state write orders, branch-free: the first quad of
//    record t + 2, the other quads of record t + 1 and that step's two rk
//    words (rk is written only before the walk: a rack and its channel
//    mask, so the step's feasible channels are one AND); then it writes.
//    The channel loops are unrolled for up to 4 channels, whose free times
//    live in registers (no shared-memory round trip from one edge's choice
//    to the next edge's); the one branch on a row's kind is uniform across
//    a warp of one instance.
//  - The walk stops after an instance's last live row (9 to 35 of 64 in the
//    production fleet).
//  - R rows a block: the largest of 128, 64, 32 that still gives a block to
//    every SM (32 at the serving shape, 128 blocks), fewer where a row's
//    state is large (a 128-task DAG's 4,096 edges: 4,372 words, 4 rows).
//
// What bounds it. A launch must read the rows' racks (int16 [B, n_pad]),
// instance ids and the blobs, and write one float a row: 5.3 MB at the
// offline shape (B 131,072, n_pad 16), 1.6 us at 3.35 TB/s, against about
// 10^8 float operations. The walks take far longer than either bound: the
// serving shape is latency-bound (a warp an SM), the offline shape nearly
// issue-bound (20 warps an SM, where a row's 76 words fill the shared
// memory).

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int OP_TASK = 0;  // repro_torch/core/simulator.py
constexpr int OP_EDGE = 1;
// Largest shared memory a block may ask for on sm_90 (227 KB), and the
// target a block's rows stay under.
constexpr int kSmemMax = 232448;
constexpr int kSmemTarget = 96 * 1024;
// Largest instance blob a block stages (bigger blobs are read in place).
constexpr int kBlobMax = 32 * 1024;
constexpr int kMaxDevices = 64;
// Largest row state in 4-byte words: one row a block within kSmemMax
// (stage2.py:MAX_STATE_WORDS).
constexpr int kMaxWords = kSmemMax / (int)sizeof(float);
// Most channels a rack's mask holds, above its 16-bit id in rk
// (stage2.py:MAX_CHANNELS).
constexpr int kMaxChan = 16;
constexpr int kRowsMax = 128;
constexpr int kRowsMin = 32;  // a warp: smaller blocks would idle lanes

struct Args {
  const int16_t* rack;  // [B, n_pad]
  const int* inst_id;   // [B]
  const int4* packed;   // [I, S4]
  float* out;           // [B]
  int B, n_pad, n_ops, m_pad, M_pad, indeg_pad, n_chan;
  int Q;      // quads a record
  int S4;     // quads an instance blob
  int stage;  // 1: a block stages its first row's instance blob
};

// Words of one row's state: racks, rack_free, chan_free (channels 4.. only
// are used: 0-3 live in registers), task_fin, edge_fin.
__host__ __device__ __forceinline__ int state_words(const Args& a) {
  return a.n_pad + a.M_pad + a.n_chan + a.n_pad + a.m_pad + 1;
}

__host__ __device__ __forceinline__ int record_quads(int indeg_pad) {
  return 2 + (indeg_pad + 3) / 4;
}

__host__ __device__ __forceinline__ int blob_quads(int n_ops, int indeg_pad, int M_pad,
                                                   int n_chan) {
  return n_ops * record_quads(indeg_pad) + (1 + n_chan + M_pad * n_chan + M_pad + 3) / 4;
}

__device__ __forceinline__ int lo16(int w) { return w & 0xFFFF; }
__device__ __forceinline__ int hi16(int w) { return (int)((unsigned)w >> 16); }

// A load from the staged blob (shared memory) or in place (read-only cache).
template <bool kShared, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// Quads 0-2 of a record: a (kind | task << 16, src | dst << 16,
// edge | n_read << 16, p), d (local, wired, wireless, 0) and the first four
// in-edge ids. Both kinds load all three: no branch before the loads.
struct Rec {
  int4 a, d, ids;
};

template <bool kShared>
__device__ __forceinline__ Rec load_body(const int4* rec_t, const int4 a) {
  return Rec{a, ld<kShared>(rec_t + 1), ld<kShared>(rec_t + 2)};
}

// What a step needs that no step writes: the rack of its task or of its
// edge's source (ra), of its edge's destination (rb), and the channels both
// may use (bit c). A word of rk holds a rack and, above bit 16, that rack's
// channel mask, so this is two loads and an AND, branch-free (every address
// is valid for any row kind: a task row's src and dst fields are 0).
struct Pre {
  int ra, rb;
  unsigned feas;
};

__device__ __forceinline__ Pre prepare(const int4 a, const int* rk, int R) {
  const int wa = rk[(lo16(a.x) == OP_TASK ? hi16(a.x) : lo16(a.y)) * R];
  const int wb = rk[hi16(a.y) * R];
  return Pre{lo16(wa), lo16(wb), (unsigned)(wa & wb) >> 16};
}

// The state a step reads, loaded for either kind before the step's writes
// are computed (every address is valid for any row kind).
struct Reads {
  float ready_t;  // max over the task's in-edge finishes
  float rack;     // rack_free[ra]
  float ready_e;  // task_fin[src]
};

template <bool kShared>
__device__ __forceinline__ Reads read_state(const Rec& q, const Pre& p, const int4* rec_t,
                                            const float* rack_free, const float* task_fin,
                                            const float* edge_fin, int R) {
  Reads s;
  // The max over the first n_read in-edge ids: every distinct id of the row
  // (an id read twice changes no max).
  const int n_read = hi16(q.a.z);
  s.ready_t = edge_fin[q.ids.x * R];
  if (n_read > 1) s.ready_t = fmaxf(s.ready_t, edge_fin[q.ids.y * R]);
  if (n_read > 2) s.ready_t = fmaxf(s.ready_t, edge_fin[q.ids.z * R]);
  if (n_read > 3) s.ready_t = fmaxf(s.ready_t, edge_fin[q.ids.w * R]);
  s.rack = rack_free[p.ra * R];
  s.ready_e = task_fin[lo16(q.a.y) * R];
  if (n_read > 4) {
    const int* more = reinterpret_cast<const int*>(rec_t + 2);
    for (int k = 4; k < n_read; ++k)
      s.ready_t = fmaxf(s.ready_t, edge_fin[ld<kShared>(more + k) * R]);
  }
  return s;
}

// The channel c candidate of a cross-rack edge, +inf where c is infeasible.
__device__ __forceinline__ float channel_finish(unsigned feas, int c, float ready, float free,
                                                float q_wired, float q_wireless) {
  return (feas >> c) & 1u ? __fadd_rn(fmaxf(ready, free), c == 0 ? q_wired : q_wireless)
                          : INFINITY;
}

// The writes of one op-table row of the scan body, from its reads. Channels
// 0-3 live in registers (chan: no shared-memory round trip between one
// edge's choice and the next edge's), channels 4.. in chan_free.
__device__ __forceinline__ void write_state(const Rec& q, const Pre& p, const Reads& s,
                                            float (&chan)[4], float* rack_free,
                                            float* chan_free, float* task_fin, float* edge_fin,
                                            int n_chan, int R) {
  const int kind = lo16(q.a.x);
  if (kind == OP_TASK) {
    const float fin = __fadd_rn(fmaxf(s.ready_t, s.rack), __int_as_float(q.a.w));
    rack_free[p.ra * R] = fin;
    task_fin[hi16(q.a.x) * R] = fin;
  } else if (kind == OP_EDGE) {
    float fin;
    if (p.ra == p.rb) {
      fin = __fadd_rn(s.ready_e, __int_as_float(q.d.x));
    } else {
      const float q_wired = __int_as_float(q.d.y), q_wireless = __int_as_float(q.d.z);
      fin = channel_finish(p.feas, 0, s.ready_e, chan[0], q_wired, q_wireless);
      int best = 0;
#pragma unroll
      for (int c = 1; c < 4; ++c) {  // a channel past n_chan has no mask bit: +inf
        const float f = channel_finish(p.feas, c, s.ready_e, chan[c], q_wired, q_wireless);
        if (f < fin) {
          fin = f;
          best = c;
        }
      }
      for (int c = 4; c < n_chan; ++c) {
        const float f =
            channel_finish(p.feas, c, s.ready_e, chan_free[c * R], q_wired, q_wireless);
        if (f < fin) {
          fin = f;
          best = c;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) chan[c] = best == c ? fin : chan[c];
      if (best >= 4) chan_free[best * R] = fin;
    }
    edge_fin[lo16(q.a.z) * R] = fin;
  }
}

// The row's walk over its instance blob `rec`; returns its makespan. The
// state pointers are at the row's word of their first slot.
template <bool kShared>
__device__ __forceinline__ float walk(const int4* rec, const Args& a, const int* rk,
                                      float* rack_free, float* chan_free, float* task_fin,
                                      float* edge_fin, int R) {
  const int* tail = reinterpret_cast<const int*>(rec + (size_t)a.n_ops * a.Q);
  const int n_live = ld<kShared>(tail);
  const float* chan_free0 = reinterpret_cast<const float*>(tail + 1);
  for (int k = 0; k < a.M_pad; ++k) rack_free[k * R] = 0.0f;
  float chan[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) chan[c] = c < a.n_chan ? ld<kShared>(chan_free0 + c) : 0.0f;
  for (int c = 4; c < a.n_chan; ++c) chan_free[c * R] = ld<kShared>(chan_free0 + c);
  for (int k = 0; k < a.n_pad; ++k) task_fin[k * R] = 0.0f;
  for (int k = 0; k <= a.m_pad; ++k) edge_fin[k * R] = 0.0f;
  const int4 pad = make_int4(2, 0, 0, 0);  // an OP_PAD row's quad 0
  if (n_live > 0) {
    Rec cur = load_body<kShared>(rec, ld<kShared>(rec));
    int4 a1 = n_live > 1 ? ld<kShared>(rec + a.Q) : pad;
    Pre pc = prepare(cur.a, rk, R);
    for (int t = 0; t < n_live; ++t) {
      // Step t's state reads (they follow step t - 1's writes); then the
      // loads that no state write orders: quad 0 of record t + 2, the rest
      // of record t + 1 and its racks and channels; then step t's writes.
      const Reads s = read_state<kShared>(cur, pc, rec + (size_t)t * a.Q, rack_free, task_fin,
                                          edge_fin, R);
      const int4 a2 = t + 2 < n_live ? ld<kShared>(rec + (size_t)(t + 2) * a.Q) : pad;
      // (Past the last row it loads the last record again, unused: a read
      // past the blob of the last instance would leave its tensor.)
      const int t1 = t + 1 < n_live ? t + 1 : t;
      const Rec nxt = load_body<kShared>(rec + (size_t)t1 * a.Q, a1);
      const Pre pn = prepare(a1, rk, R);
      write_state(cur, pc, s, chan, rack_free, chan_free, task_fin, edge_fin, a.n_chan, R);
      cur = nxt;
      pc = pn;
      a1 = a2;
    }
  }
  float m = task_fin[0];
  for (int k = 1; k < a.n_pad; ++k) m = fmaxf(m, task_fin[k * R]);
  return m;
}

__global__ void __launch_bounds__(kRowsMax, 4) fleet_evaluate_kernel(const Args a) {
  extern __shared__ int4 smem[];  // [the staged blob][the rows' state]
  const int R = blockDim.x;
  const int r = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * R;
  const int n_rows = a.B - row0 < R ? (int)(a.B - row0) : R;

  // The state, each slot R words: rk [n_pad] (int racks), rack_free
  // [M_pad], chan_free [n_chan], task_fin [n_pad], edge_fin [m_pad + 1].
  int* rk = reinterpret_cast<int*>(smem + (a.stage ? a.S4 : 0));
  float* rack_free = reinterpret_cast<float*>(rk + (size_t)a.n_pad * R);
  float* chan_free = rack_free + (size_t)a.M_pad * R;
  float* task_fin = chan_free + (size_t)a.n_chan * R;
  float* edge_fin = task_fin + (size_t)a.n_pad * R;
  // Until the walk: the mbarrier over rk[0..1], and the block's racks as
  // they lie in global memory ([n_rows][n_pad] int16, 16-byte aligned: n_pad
  // is a multiple of 8) over rack_free onwards.
  const uint32_t bar = sm90::smem_addr(rk);
  const int i0 = __ldg(a.inst_id + row0);
  if (r == 0) {
    sm90::mbar_init(bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (r == 0) {
    const uint32_t rack_bytes = (uint32_t)n_rows * a.n_pad * (uint32_t)sizeof(int16_t);
    const uint32_t blob_bytes = a.stage ? (uint32_t)a.S4 * 16u : 0u;
    sm90::mbar_expect_tx(bar, rack_bytes + blob_bytes);
    sm90::bulk_load(sm90::smem_addr(rack_free), a.rack + row0 * a.n_pad, rack_bytes, bar);
    if (a.stage)
      sm90::bulk_load(sm90::smem_addr(smem), a.packed + (size_t)i0 * a.S4, blob_bytes, bar);
  }
  const int i = r < n_rows ? __ldg(a.inst_id + row0 + r) : i0;
  sm90::mbar_wait(bar, 0);
  __syncthreads();
  if (r == 0) sm90::mbar_inval(bar);
  __syncthreads();
  // Each thread moves its row's racks into rk, each with its instance's
  // channel mask of that rack above bit 16, starting at its own word so that
  // lanes fall on different banks.
  if (r < n_rows) {
    const int* mask = reinterpret_cast<const int*>(
        (a.stage && i == i0 ? smem : a.packed + (size_t)i * a.S4) + (size_t)a.n_ops * a.Q) +
        1 + a.n_chan + a.M_pad * a.n_chan;
    const int P = a.n_pad / 2;
    const int* src = reinterpret_cast<const int*>(rack_free) + r * P;
    int j = r % P;
    for (int it = 0; it < P; ++it) {
      const int w = src[j];
      const int lo = w & 0xFFFF, hi = (int)((unsigned)w >> 16);
      rk[(2 * j) * R + r] = lo | mask[lo] << 16;
      rk[(2 * j + 1) * R + r] = hi | mask[hi] << 16;
      j = j + 1 == P ? 0 : j + 1;
    }
  }
  __syncthreads();
  if (r >= n_rows) return;
  const float m =
      a.stage && i == i0
          ? walk<true>(smem, a, rk + r, rack_free + r, chan_free + r, task_fin + r,
                       edge_fin + r, R)
          : walk<false>(a.packed + (size_t)i * a.S4, a, rk + r, rack_free + r, chan_free + r,
                        task_fin + r, edge_fin + r, R);
  a.out[row0 + r] = m;
}

struct Launch {
  int rows, blocks, stage;
  size_t smem;
};

// Rows a block: the largest of 128, 64, 32 that gives every SM a block (or
// 32), halved while the state passes kSmemTarget (a bucket of thousands of
// edges gets a few rows a block, each up to kSmemMax). The block stages its
// instance blob when it is at most kBlobMax and fits beside the state.
Launch plan(const Args& a, int sms) {
  const int words = state_words(a);
  int rows = kRowsMax;
  while (rows > kRowsMin && ((int64_t)a.B + rows - 1) / rows < sms) rows /= 2;
  while (rows > 1 && (size_t)rows * words * sizeof(float) > (size_t)kSmemTarget) rows /= 2;
  const size_t state = (size_t)rows * words * sizeof(float);
  const size_t blob = (size_t)a.S4 * 16;
  const int stage = blob <= (size_t)kBlobMax && state + blob <= (size_t)kSmemMax;
  return Launch{rows, (int)(((int64_t)a.B + rows - 1) / rows), stage,
                state + (stage ? blob : 0)};
}

// Once a device: the kernel may take up to kSmemMax bytes of dynamic shared
// memory (a constant, so a call stays legal inside a CUDA graph capture).
int allow_smem() {
  static int set[kMaxDevices] = {0};
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev < kMaxDevices && set[dev]) return 0;
  err = (int)cudaFuncSetAttribute(fleet_evaluate_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err == 0 && dev < kMaxDevices) set[dev] = 1;
  return err;
}

Args make_args(const int16_t* rack, const int* inst_id, const int* packed, float* out, int B,
               int n_pad, int n_ops, int m_pad, int M_pad, int indeg_pad, int n_chan) {
  return Args{rack, inst_id, reinterpret_cast<const int4*>(packed), out, B, n_pad, n_ops,
              m_pad, M_pad, indeg_pad, n_chan, record_quads(indeg_pad),
              blob_quads(n_ops, indeg_pad, M_pad, n_chan), 0};
}

bool valid(const Args& a) {
  return a.n_pad >= 8 && a.n_pad % 8 == 0 && a.n_ops >= 1 && a.indeg_pad >= 1 &&
         a.n_chan >= 1 && a.n_chan <= kMaxChan && a.M_pad >= 1 && a.m_pad >= 0 &&
         state_words(a) <= kMaxWords && reinterpret_cast<uintptr_t>(a.rack) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.packed) % 16 == 0;
}

}  // namespace

extern "C" {

// makespan[B] of every candidate row: int16 rack [B, n_pad], int32 inst_id
// [B] and the packed tables (int32 [I, 4 * S4], stage2.py:pack_tables).
// Launches on `stream` of the current device.
int fleet_evaluate(const int16_t* rack, const int* inst_id, const int* packed, float* out,
                   int B, int n_pad, int n_ops, int m_pad, int M_pad, int indeg_pad,
                   int n_chan, void* stream) {
  Args a = make_args(rack, inst_id, packed, out, B, n_pad, n_ops, m_pad, M_pad, indeg_pad,
                     n_chan);
  if (B <= 0) return 0;
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  const int err = allow_smem();
  if (err != 0) return err;
  const int sms = sm90::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const Launch l = plan(a, sms);
  a.stage = l.stage;
  fleet_evaluate_kernel<<<l.blocks, l.rows, l.smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The launch fleet_evaluate makes on the current device for these sizes:
// out[0..4] = rows a block, blocks, staged blob (0 / 1), dynamic shared
// memory bytes, the device's SMs.
int fleet_evaluate_plan(int B, int n_pad, int n_ops, int m_pad, int M_pad, int indeg_pad,
                        int n_chan, int* out) {
  const Args a = make_args(nullptr, nullptr, nullptr, nullptr, B, n_pad, n_ops, m_pad,
                           M_pad, indeg_pad, n_chan);
  if (B <= 0 || !valid(a)) return (int)cudaErrorInvalidValue;
  const int sms = sm90::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const Launch l = plan(a, sms);
  out[0] = l.rows;
  out[1] = l.blocks;
  out[2] = l.stage;
  out[3] = (int)l.smem;
  out[4] = sms;
  return 0;
}

}  // extern "C"
