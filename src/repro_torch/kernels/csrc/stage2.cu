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
// finite.
//
// Design. One thread a row. A row's state (and its racks) lives in dynamic
// shared memory laid out [slot][row]: a warp's 32 rows read one slot at 32
// consecutive words, and a rack-indexed slot at rack * R + row, so no two
// lanes of a warp share a bank whatever their racks (R = 128 rows a block
// at the engine's buckets, 76 words a row at the offline one; fewer rows
// where a bucket's edges make a row's state large). A dynamically indexed
// array in registers would spill to local memory. The block's racks are
// copied in once, coalesced, before the walk. The op tables (a few KB an
// instance, int64 indices as the engine stacks them) come through the
// read-only cache; the engine packs the rows of one instance contiguously
// (8,192 or 512 a block of rows), so a warp's table reads are broadcasts.
// Rows of different instances in one warp diverge and stay right.
//
// What bounds it. A launch must read the rows' racks (int32 [B, n_pad]) and
// instance ids and write one float a row: 8.9 MB at the offline shape
// (B 131,072, n_pad 16), 2.6 us at 3.35 TB/s, against about 10^8 float
// operations. The walk itself is a chain of dependent shared-memory
// accesses, 64 steps of a few dozen instructions each, so its time is set
// by latency and occupancy, not by either bound: a simple kernel first, the
// card-specific redesign later.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int OP_TASK = 0;  // repro_torch/core/simulator.py
constexpr int OP_EDGE = 1;
// Largest shared memory a block may ask for on sm_90 (227 KB), and the
// target a block's rows stay under.
constexpr int kSmemMax = 232448;
constexpr int kSmemTarget = 96 * 1024;
constexpr int kMaxDevices = 64;
// Largest row state in 4-byte words: one row a block within kSmemMax
// (stage2.py:MAX_STATE_WORDS).
constexpr int kMaxWords = kSmemMax / (int)sizeof(float);

struct Args {
  const int* rack;        // [B, n_pad]
  const int* inst_id;     // [B]
  const int64_t* kind;    // [I, n_ops]
  const int64_t* op_task;
  const int64_t* op_edge;
  const int64_t* op_src;
  const int64_t* op_dst;
  const float* op_p;      // [I, n_ops]
  const float* op_wired;
  const float* op_wireless;
  const float* op_local;
  const int64_t* op_in;   // [I, n_ops, indeg_pad]
  const float* chan_free0;  // [I, n_chan]
  const float* reach;     // [I, M_pad, n_chan]
  float* out;             // [B]
  int B, n_pad, n_ops, m_pad, M_pad, indeg_pad, n_chan;
};

// Words of one row's state: racks, rack_free, chan_free, task_fin, edge_fin.
__host__ __device__ __forceinline__ int state_words(const Args& a) {
  return a.n_pad + a.M_pad + a.n_chan + a.n_pad + a.m_pad + 1;
}

__device__ __forceinline__ int ldg_index(const int64_t* p) { return (int)__ldg(p); }

__global__ void __launch_bounds__(128) fleet_evaluate_kernel(const Args a) {
  extern __shared__ float smem[];
  const int R = blockDim.x;  // rows a block
  const int r = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * R;

  // Slot bases, each R words apart: s[k * R + r] is slot k of row r.
  int* rk = reinterpret_cast<int*>(smem);             // [n_pad] racks
  float* rack_free = smem + (size_t)a.n_pad * R;      // [M_pad]
  float* chan_free = rack_free + (size_t)a.M_pad * R;  // [n_chan]
  float* task_fin = chan_free + (size_t)a.n_chan * R;  // [n_pad]
  float* edge_fin = task_fin + (size_t)a.n_pad * R;    // [m_pad + 1]

  // The block's racks, coalesced: its rows are contiguous in rack.
  const int64_t n_rows = a.B - row0 < R ? a.B - row0 : R;
  for (int64_t k = r; k < n_rows * a.n_pad; k += R) {
    const int rr = (int)(k / a.n_pad), t = (int)(k % a.n_pad);
    rk[t * R + rr] = __ldg(a.rack + row0 * a.n_pad + k);
  }
  __syncthreads();
  if (r >= n_rows) return;

  const int64_t b = row0 + r;
  const int i = __ldg(a.inst_id + b);
  for (int k = 0; k < a.M_pad; ++k) rack_free[k * R + r] = 0.0f;
  for (int c = 0; c < a.n_chan; ++c) chan_free[c * R + r] = __ldg(a.chan_free0 + i * a.n_chan + c);
  for (int k = 0; k < a.n_pad; ++k) task_fin[k * R + r] = 0.0f;
  for (int k = 0; k <= a.m_pad; ++k) edge_fin[k * R + r] = 0.0f;

  const float* reach = a.reach + (size_t)i * a.M_pad * a.n_chan;
  const int64_t base = (int64_t)i * a.n_ops;
  for (int t = 0; t < a.n_ops; ++t) {
    const int64_t o = base + t;
    const int kind = ldg_index(a.kind + o);
    if (kind == OP_TASK) {
      const int v = ldg_index(a.op_task + o);
      const int64_t* in = a.op_in + o * a.indeg_pad;
      float ready = edge_fin[ldg_index(in) * R + r];
      for (int k = 1; k < a.indeg_pad; ++k) ready = fmaxf(ready, edge_fin[ldg_index(in + k) * R + r]);
      const int rv = rk[v * R + r];
      const float fin = __fadd_rn(fmaxf(ready, rack_free[rv * R + r]), __ldg(a.op_p + o));
      rack_free[rv * R + r] = fin;
      task_fin[v * R + r] = fin;
    } else if (kind == OP_EDGE) {
      const int u = ldg_index(a.op_src + o), v = ldg_index(a.op_dst + o);
      const int e = ldg_index(a.op_edge + o);
      const float ready = task_fin[u * R + r];
      const int ru = rk[u * R + r], rv = rk[v * R + r];
      float fin;
      if (ru == rv) {
        fin = __fadd_rn(ready, __ldg(a.op_local + o));
      } else {
        const float q_wired = __ldg(a.op_wired + o), q_wireless = __ldg(a.op_wireless + o);
        fin = INFINITY;
        int best = 0;
        for (int c = 0; c < a.n_chan; ++c) {
          const float feas = __fmul_rn(__ldg(reach + ru * a.n_chan + c), __ldg(reach + rv * a.n_chan + c));
          const float f = feas > 0.0f
              ? __fadd_rn(fmaxf(ready, chan_free[c * R + r]), c == 0 ? q_wired : q_wireless)
              : INFINITY;
          if (f < fin) {
            fin = f;
            best = c;
          }
        }
        chan_free[best * R + r] = fin;
      }
      edge_fin[e * R + r] = fin;
    }
  }
  float m = task_fin[r];
  for (int k = 1; k < a.n_pad; ++k) m = fmaxf(m, task_fin[k * R + r]);
  a.out[b] = m;
}

// Rows a block: the most of 128, 64, ..., 1 whose state stays under
// kSmemTarget (128 at the engine's buckets; a bucket of thousands of edges
// gets a few rows a block, each up to kSmemMax).
int rows_per_block(int words) {
  int rows = 128;
  while (rows > 1 && (size_t)rows * words * sizeof(float) > (size_t)kSmemTarget) rows /= 2;
  return rows;
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

}  // namespace

extern "C" {

// makespan[B] of every candidate row: int32 rack [B, n_pad] and inst_id [B],
// the tables of repro_torch/core/vectorized.py:_build_eval_stack (int64
// indices, float32 data). Launches on `stream` of the current device.
int fleet_evaluate(const int* rack, const int* inst_id, const int64_t* kind,
                   const int64_t* op_task, const int64_t* op_edge,
                   const int64_t* op_src, const int64_t* op_dst, const float* op_p,
                   const float* op_wired, const float* op_wireless,
                   const float* op_local, const int64_t* op_in,
                   const float* chan_free0, const float* reach, float* out, int B,
                   int n_pad, int n_ops, int m_pad, int M_pad, int indeg_pad,
                   int n_chan, void* stream) {
  const Args a{rack, inst_id, kind, op_task, op_edge, op_src, op_dst, op_p,
               op_wired, op_wireless, op_local, op_in, chan_free0, reach, out,
               B, n_pad, n_ops, m_pad, M_pad, indeg_pad, n_chan};
  if (B <= 0) return 0;
  const int words = state_words(a);
  if (words > kMaxWords) return (int)cudaErrorInvalidValue;
  const int err = allow_smem();
  if (err != 0) return err;
  const int rows = rows_per_block(words);
  const size_t smem = (size_t)rows * words * sizeof(float);
  const int grid = (int)(((int64_t)B + rows - 1) / rows);
  fleet_evaluate_kernel<<<grid, rows, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
