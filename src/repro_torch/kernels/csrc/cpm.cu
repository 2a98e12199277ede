// Batched max-plus critical path and the fused §IV-A combined bound, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// repro_torch/kernels/cpm.py.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/cpm.py:
//   _lb_kernel         -> cpm_combined_lb
//   _lb_kernel_masked  -> cpm_combined_lb_masked
//   _kernel            -> cpm_critical_path
//
// Per row b, from dist = 0, n_iters Jacobi max-plus rounds
//     dist[v] <- max(dist[v], max_u dist[u] + w[u, v])
// where every round reads only the previous round's dist (cpm.py:_relax), so
// the result equals the Pallas kernel for any n_iters, including n_iters
// below the DAG's depth. The LB entry points then take
//     lb = max(max_v dist[v] + p[v], extra)
// and the masked one relaxes over (w + mask) instead of w, the sum taken in
// float32 before the first round exactly as _lb_kernel_masked does. Non-finite
// w and extra map to -1e30 (cpm.py:NEG_INF) as the tile is staged, the same
// mapping cpm.py applies before its pallas_call. Every operation is a float32
// add or max in a fixed association, so results are bit-identical to the
// plain PyTorch version (repro_torch/kernels/ref.py) and to the JAX package.
//
// Layout: one block holds `rows` rows; thread (r, v) owns dist[v] of row r.
// The block stages its rows' n x n tiles (w, plus mask when present, folded
// into one tile) in dynamic shared memory, keeps dist double-buffered there,
// and separates rounds with __syncthreads(). Rows >= B are masked in the
// kernel; nothing is padded.
//
// What bounds it: each launch reads B*n*n*4 bytes of w (the same again for
// mask) plus B*(n+1)*4 of p and extra, and does 2*n_iters*n*n max/add per row.
// At the offline fleet shape (B = 16 * 8192 = 131,072 rows, n = 16) w alone is
// 134 MB, about 40 us at 3.35 TB/s, against about 2*9*256*131072 = 0.6 G
// max/add ops, so the kernel is bound by memory. The next step (ROADMAP
// Queue 2 item 1) fuses the adjacency scatter of _fleet_lb_device into this
// kernel so that w never reaches device memory at all.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // cpm.py:NEG_INF
constexpr float kFltMax = 3.402823466e38f;
constexpr int kMaxThreads = 256;
constexpr int kSmemTarget = 48 * 1024;

__device__ __forceinline__ float finite_or_neg(float x) {
  // fabsf(NaN) <= kFltMax is false, so NaN maps like +-inf.
  return fabsf(x) <= kFltMax ? x : kNegInf;
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
  for (int i = tid; i < rows * nn; i += blockDim.x) {
    const int64_t g = base + i;
    float x = kNegInf;
    if (g < total) {
      x = finite_or_neg(w[g]);
      if (kMasked) x = x + mask[g];
    }
    tile[i] = x;
  }
  cur[tid] = 0.0f;
  __syncthreads();

  const float* col = tile + (size_t)r * nn + v;  // w[r][u][v] at col[u * n]
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

  if (kEpilogue) {
    // nxt is free after the last round's barrier: reuse it for dist + p.
    nxt[tid] = live ? cur[tid] + p[b * n + v] : 0.0f;
    __syncthreads();
    if (live && v == 0) {
      const float* s = nxt + r * n;
      float m = s[0];
      for (int u = 1; u < n; ++u) m = fmaxf(m, s[u]);
      out[b] = fmaxf(m, finite_or_neg(extra[b]));
    }
  } else if (live) {
    out[b * n + v] = cur[tid];
  }
}

int rows_per_block(int n) {
  int rows = kMaxThreads / n;
  const int by_smem = kSmemTarget / ((n * n + 2 * n) * (int)sizeof(float));
  if (by_smem < rows) rows = by_smem;
  return rows < 1 ? 1 : rows;
}

template <bool kMasked, bool kEpilogue>
int launch(const float* w, const float* mask, const float* p,
           const float* extra, float* out, int B, int n, int n_iters,
           void* stream) {
  if (B <= 0) return 0;
  const int rows = rows_per_block(n);
  const size_t smem =
      ((size_t)rows * n * n + 2 * (size_t)rows * n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cpm_rows_kernel<kMasked, kEpilogue>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(((int64_t)B + rows - 1) / rows);
  cpm_rows_kernel<kMasked, kEpilogue>
      <<<grid, rows * n, smem, (cudaStream_t)stream>>>(w, mask, p, extra, out,
                                                       B, n, n_iters, rows);
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

}  // extern "C"
