// Mamba-1's selective scan for Hopper (sm_90a), forward only. Plain C
// interface, loaded with ctypes by repro_torch/kernels/selective_scan.py.
//
// Replaces no TPU kernel: the JAX package has no Mamba-1 mixer (its
// Jamba runs a Mamba-2-style chunked SSD, src/repro/models/ssm.py). The
// port's Mamba-1 mixer (models/ssm.py: mamba1_forward) would otherwise run
// the recurrence as a loop over time of a few launches a step
// (kernels/ref.py: ref_selective_scan, its plain version): thousands of
// launches a layer.
//
// What it computes, for each row b, channel c < d_inner and step t, with
// N = 16 states:
//   delta  = softplus(dt[b, t, c] + dt_bias[c])          (float32)
//   s[n]   = exp(delta * A[c, n]) * s[n] + delta * x[b, t, c] * B[b, t, n]
//   y      = sum_n s[n] * C[b, t, n] + D[c] * x[b, t, c]
//   out[b, t, c] = y * silu(z[b, t, c])                   (rounded once)
// with A = -exp(A_log), s = 0 before step 0, every sum in float32.
//
// What bounds it: bytes, then the exponentials. At the jamba2mini prefill
// cell's layer (8,192 tokens, d_inner 8,192, bf16) it reads x, dt, z and
// writes out once (537 MB, 0.160 ms at 3.35 TB/s); the 6 float32
// operations a (token, channel, state) take 0.096 ms at 67 TFLOP/s; the
// 16 exponentials a (token, channel) go to the SFUs (16 a clock an SM), a
// floor of about 0.3 ms a layer.
//
// The design: one thread a (row, channel), its 16 states and its 16
// decay rates (A * log2 e, so that each decay is one ex2.approx) in
// registers, for the whole sequence. A block is 64 channels of one row.
// The sequence goes in tiles of kL steps: the block's x, dt, z rows of a
// tile (64 channels, 128 bytes a row in bf16) and the row's B and C of
// the tile come into shared memory by 16-byte cp.async copies, two tiles
// in flight (the next tile's copies are issued before the current tile is
// computed), so the loads are coalesced along d_inner and their latency
// hides behind a tile's arithmetic. B and C are converted to float32 once
// a tile and read by every thread at the same address (a broadcast). The
// output goes straight to global memory, 64 contiguous bytes a warp a
// step. The sequence is walked in order by each thread: few rows (B 2)
// give few threads (16,384 at d_inner 8,192, about 4 warps an SM), and a
// split over time is left to later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kN = 16;        // states a channel
constexpr int kC = 64;        // channels a block (one thread each)
constexpr int kL = 16;        // steps a tile
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !pred (the
// source is then not read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(pred ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 2^x in one MUFU instruction (2 ulp; results below 2^-126 flush to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct ScanArgs {
  const void* x;
  const void* dt;
  const void* z;
  const void* B;       // [rows, S, kN], contiguous
  const void* C;       // [rows, S, kN], contiguous
  const float* A_log;  // [d_inner, kN], contiguous
  const float* D;      // [d_inner]
  const float* dt_bias;  // [d_inner]
  void* out;
  // Strides in elements: (row, step) of x, dt, z, out; channels contiguous.
  long long sx[2], sdt[2], sz[2], so[2];
  int S;
  int d_inner;
};

template <typename T>
struct Tile {
  T x[kL][kC];
  T dt[kL][kC];
  T z[kL][kC];
  T bc[kL][2 * kN];  // B then C of each step
};

// Issue the copies of tile `tile` of row `b`, channels [c0, c0 + kC), into
// `dst`; steps past S are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(const ScanArgs& a, Tile<T>& dst, int b, int c0,
                                          int tile) {
  constexpr int kPer = 16 / sizeof(T);     // elements a 16-byte chunk
  constexpr int kRow = kC / kPer;          // chunks a channel row
  constexpr int kBC = kN / kPer;           // chunks of B (or C) a step
  const int t0 = tile * kL;
  for (int i = threadIdx.x; i < 3 * kL * kRow; i += kC) {
    const int which = i / (kL * kRow);
    const int r = (i / kRow) % kL;
    const int q = i % kRow;
    const int t = t0 + r;
    const bool live = t < a.S;
    const int tt = live ? t : 0;
    const T* src;
    T* d;
    if (which == 0) {
      src = static_cast<const T*>(a.x) + b * a.sx[0] + tt * a.sx[1];
      d = &dst.x[r][0];
    } else if (which == 1) {
      src = static_cast<const T*>(a.dt) + b * a.sdt[0] + tt * a.sdt[1];
      d = &dst.dt[r][0];
    } else {
      src = static_cast<const T*>(a.z) + b * a.sz[0] + tt * a.sz[1];
      d = &dst.z[r][0];
    }
    cp_async16(d + q * kPer, src + c0 + q * kPer, live);
  }
  for (int i = threadIdx.x; i < 2 * kL * kBC; i += kC) {
    const int which = i / (kL * kBC);
    const int r = (i / kBC) % kL;
    const int q = i % kBC;
    const int t = t0 + r;
    const bool live = t < a.S;
    const long long off = (static_cast<long long>(b) * a.S + (live ? t : 0)) * kN;
    const T* src = static_cast<const T*>(which == 0 ? a.B : a.C) + off;
    cp_async16(&dst.bc[r][which * kN + q * kPer], src + q * kPer, live);
  }
}

template <typename T>
__global__ void __launch_bounds__(kC) selective_scan_fwd(const ScanArgs a) {
  __shared__ __align__(16) Tile<T> tiles[2];
  __shared__ __align__(16) float bcf[kL][2 * kN];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kC;
  const int c = c0 + threadIdx.x;

  float A2[kN];
  float s[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    A2[n] = -expf(a.A_log[c * kN + n]) * kLog2e;
    s[n] = 0.f;
  }
  const float Dc = a.D[c];
  const float bias = a.dt_bias[c];
  T* out = static_cast<T*>(a.out) + b * a.so[0] + c;

  const int n_tiles = (a.S + kL - 1) / kL;
  load_tile<T>(a, tiles[0], b, c0, 0);
  cp_async_commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < n_tiles) {
      load_tile<T>(a, tiles[st ^ 1], b, c0, tile + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kL * 2 * kN; i += kC)
      bcf[i / (2 * kN)][i % (2 * kN)] = to_f32<T>(tiles[st].bc[i / (2 * kN)][i % (2 * kN)]);
    __syncthreads();

    const Tile<T>& tl = tiles[st];
    const int t0 = tile * kL;
    const int steps = min(kL, a.S - t0);
    for (int r = 0; r < steps; ++r) {
      const float xv = to_f32<T>(tl.x[r][threadIdx.x]);
      const float dv = to_f32<T>(tl.dt[r][threadIdx.x]) + bias;
      const float zv = to_f32<T>(tl.z[r][threadIdx.x]);
      const float delta = dv > 20.f ? dv : log1pf(__expf(dv));
      const float dx = delta * xv;
      float y = Dc * xv;
      const float4* row = reinterpret_cast<const float4*>(&bcf[r][0]);
#pragma unroll
      for (int q = 0; q < kN / 4; ++q) {
        const float4 bq = row[q];
        const float4 cq = row[kN / 4 + q];
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = 4 * q + j;
          s[n] = fmaf(s[n], fast_exp2(delta * A2[n]), dx * bv[j]);
          y = fmaf(s[n], cv[j], y);
        }
      }
      const float gate = zv / (1.f + __expf(-zv));
      out[(t0 + r) * a.so[1]] = from_f32<T>(y * gate);
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }
}

template <typename T>
int launch(const ScanArgs& a, int rows, cudaStream_t st) {
  const dim3 grid(a.d_inner / kC, rows);
  selective_scan_fwd<T><<<grid, kC, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0 float32, 1 bfloat16 (x, dt, z, B, C and out); strides[8] in
// elements: (row, step) of x, dt, z, out. Returns the launch's cudaError_t.
extern "C" int selective_scan(int dtype, const void* x, const void* dt, const void* z,
                              const void* B, const void* C, const float* A_log,
                              const float* D, const float* dt_bias, void* out,
                              const long long* strides, int rows, int S, int d_inner,
                              int n_state, void* stream) {
  if (rows <= 0 || rows > 65535 || S <= 0 || d_inner <= 0 || d_inner % kC != 0 ||
      n_state != kN || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int esz = dtype == 1 ? 2 : 4;
  unsigned long long align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dt) |
                             reinterpret_cast<uintptr_t>(z) | reinterpret_cast<uintptr_t>(B) |
                             reinterpret_cast<uintptr_t>(C);
  for (int i = 0; i < 6; ++i) align |= static_cast<unsigned long long>(strides[i] * esz);
  if (align % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  ScanArgs a;
  a.x = x;
  a.dt = dt;
  a.z = z;
  a.B = B;
  a.C = C;
  a.A_log = A_log;
  a.D = D;
  a.dt_bias = dt_bias;
  a.out = out;
  for (int i = 0; i < 2; ++i) {
    a.sx[i] = strides[i];
    a.sdt[i] = strides[2 + i];
    a.sz[i] = strides[4 + i];
    a.so[i] = strides[6 + i];
  }
  a.S = S;
  a.d_inner = d_inner;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(a, rows, st);
  return launch<float>(a, rows, st);
}
