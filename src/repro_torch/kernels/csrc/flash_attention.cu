// GQA flash attention, forward pass, for Hopper (sm_90a). Plain C interface,
// loaded with ctypes by repro_torch/kernels/attention.py.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py
// (flash_attention_fwd, body _kernel). It computes what that kernel
// computes: for every query s and head h = kv * G + g,
//     out[b, s, h] = softmax_t(q[b, s, h] . k[b, t, kv] / sqrt(D)) @ v[b, :, kv]
// with the score of key t > s set to -1e30 when causal, an online softmax
// with float32 m, l and accumulator, p rounded to v's type before the P.V
// product (as the Pallas body does), and out = acc / max(l, 1e-30) cast to
// q's type. bfloat16 and float32 inputs; D a multiple of 16, at most 128.
//
// Layout: one block per (query tile, kv head, batch row). The query tile is
// kRows consecutive rows of the flattened (query, group head) index
// i = s * G + g, so the G heads that share a kv head share its K and V
// tiles (flash_attention.py folds them the same way) and no G divides
// evenly into anything. Each of the kWarps warps owns 16 of those rows from
// start to end: it computes their score rows, runs their softmax and
// accumulates their output rows, so only the K/V tile loads synchronise the
// block. The block loops over key tiles of kBK keys itself (Hopper has no
// sequential grid dimension to carry m, l and acc); with causal masking the
// loop stops at the tile holding the block's last query, so tiles wholly
// above the diagonal are never read. Keys t >= T and rows i >= S * G are
// masked in the kernel: any S and T work. q, k and v are read in place
// through their [B, S, H, D] / [B, T, KV, D] strides: no transposed or
// head-repeated copy is made.
//
// Products: in bfloat16 the two products run on the tensor cores through
// WMMA 16x16x16 fragments with float32 accumulators; in float32 (the tests'
// type, compared at 2e-5, which TF32 would not meet) they are float32 FMAs
// on the CUDA cores. At D = 128 the tiles (Q, K, V, the float32 score tile,
// P and the float32 output accumulator) take about 113 KB in bfloat16 and
// 151 KB in float32, so shared memory is dynamic and the launch raises the
// block's limit with cudaFuncSetAttribute.
//
// What bounds it: per block, each key tile costs 4 * kRows * kBK * D flops
// on the tensor cores against 2 * kBK * D * 2 bytes of K and V; at the
// serving shape (llama3.2-3b, D = 128, causal) the work is bound by the
// tensor-core rate, not by bytes. This first kernel does not reach it: the
// output accumulator lives in shared memory (WMMA's fragment layout is
// opaque, so it is rescaled row by row there and reloaded into fragments),
// loads are not overlapped with compute, and the softmax walks its 16 rows
// one at a time per warp. wgmma, TMA and a register-resident accumulator
// are the next steps (ROADMAP).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr float kNegInf = -1e30f;  // flash_attention.py:NEG_INF
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // (query, group head) rows per block
constexpr int kBK = 64;             // keys per tile
constexpr int kMaxD = 128;
constexpr int kOPad = 4;            // float row padding of S and O tiles

template <typename T>
struct Tile;

// bfloat16: rows padded by 16 bytes (WMMA needs a multiple of 16 bytes
// and 32-byte aligned fragment origins; 16 rows of D + 8 are).
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kPad = 8;
  static constexpr int kVec = 8;  // elements per 16-byte load
};

// float32: rows padded to an odd length, so the lanes of a warp, reading
// one column of 32 different K rows, hit 32 different banks.
template <>
struct Tile<float> {
  static constexpr int kPad = 1;
  static constexpr int kVec = 1;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_ss, q_sh;  // strides (elements) of q over b, s, h
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int B, S, T, H, KV, D;
  int causal;
  float scale;
};

__host__ __device__ __forceinline__ size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

// Byte offsets of the tiles in dynamic shared memory.
template <typename T>
struct Layout {
  int ldq, ldk, lds, ldp, ldo;
  size_t q, k, v, s, p, o, m, l, bytes;
  __host__ __device__ explicit Layout(int D) {
    constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
    ldq = ldk = D + Tile<T>::kPad;
    lds = kBK + kOPad;
    ldp = kBf16 ? kBK + 8 : lds;  // float32 writes P over S in place
    ldo = D + kOPad;
    q = 0;
    k = align128(q + sizeof(T) * kRows * ldq);
    v = align128(k + sizeof(T) * kBK * ldk);
    s = align128(v + sizeof(T) * kBK * ldk);
    p = align128(s + sizeof(float) * kRows * lds);
    o = kBf16 ? align128(p + sizeof(T) * kRows * ldp) : p;
    m = align128(o + sizeof(float) * kRows * ldo);
    l = m + sizeof(float) * kRows;
    bytes = l + sizeof(float) * kRows;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copy `rows` rows of D elements, row r at src + r * stride, into a shared
// tile with leading dimension ld; rows >= valid are zero.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          int64_t stride, int rows, int valid,
                                          int D) {
  constexpr int kVec = Tile<T>::kVec;
  const int per_row = D / kVec;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * kVec;
    if constexpr (kVec == 8) {
      uint4 x = make_uint4(0, 0, 0, 0);
      if (r < valid)
        x = *reinterpret_cast<const uint4*>(src + r * stride + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = x;
    } else {
      dst[r * ld + c] = r < valid ? src[r * stride + c] : T(0);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D;
  const Layout<T> lay(D);
  T* sQ = reinterpret_cast<T*>(smem + lay.q);
  T* sK = reinterpret_cast<T*>(smem + lay.k);
  T* sV = reinterpret_cast<T*>(smem + lay.v);
  float* sS = reinterpret_cast<float*>(smem + lay.s);
  T* sP = reinterpret_cast<T*>(smem + lay.p);  // bfloat16 only
  float* sO = reinterpret_cast<float*>(smem + lay.o);
  float* sM = reinterpret_cast<float*>(smem + lay.m);
  float* sL = reinterpret_cast<float*>(smem + lay.l);

  const int G = p.H / p.KV;
  const int n_rows = p.S * G;
  const int row0 = blockIdx.x * kRows;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;  // this warp's first row in the tile

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // Q tile: row r is flattened row i = row0 + r = s * G + g. Each row is
  // its own gather (rows of one s are G consecutive heads).
  constexpr int kVec = Tile<T>::kVec;
  const int per_row = D / kVec;
  for (int i = threadIdx.x; i < kRows * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * kVec;
    const int fr = row0 + r;
    const int s = fr / G;
    const int h = kvh * G + (fr - s * G);
    const T* src = q + b * p.q_sb + s * p.q_ss + h * p.q_sh + c;
    if constexpr (kVec == 8) {
      uint4 x = make_uint4(0, 0, 0, 0);
      if (fr < n_rows) x = *reinterpret_cast<const uint4*>(src);
      *reinterpret_cast<uint4*>(sQ + r * lay.ldq + c) = x;
    } else {
      sQ[r * lay.ldq + c] = fr < n_rows ? *src : T(0);
    }
  }
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D;
    sO[r * lay.ldo + (i - r * D)] = 0.f;
  }
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }

  // Key tiles to visit: all of them, or (causal) up to the block's last
  // query; later tiles are wholly above the diagonal.
  int t_end = p.T;
  if (p.causal) {
    const int last = min(row0 + kRows, n_rows) - 1;
    t_end = min(t_end, last / G + 1);
  }
  const int n_tiles = (t_end + kBK - 1) / kBK;

  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = j * kBK;
    __syncthreads();  // every warp is done with the last tile (and Q/O init)
    load_rows(sK, lay.ldk, k + t0 * p.k_st, p.k_st, kBK, p.T - t0, D);
    load_rows(sV, lay.ldk, v + t0 * p.v_st, p.v_st, kBK, p.T - t0, D);
    __syncthreads();

    // S[wrow:wrow+16, :] = Q K^T (unscaled).
    if constexpr (kBf16) {
      for (int c0 = 0; c0 < kBK; c0 += 16) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int d0 = 0; d0 < D; d0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> bk;
          wmma::load_matrix_sync(a, sQ + wrow * lay.ldq + d0, lay.ldq);
          wmma::load_matrix_sync(bk, sK + c0 * lay.ldk + d0, lay.ldk);
          wmma::mma_sync(acc, a, bk, acc);
        }
        wmma::store_matrix_sync(sS + wrow * lay.lds + c0, acc, lay.lds,
                                wmma::mem_row_major);
      }
    } else {
      float acc[16][2];
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float k0 = to_f32(sK[lane * lay.ldk + d]);
        const float k1 = to_f32(sK[(lane + 32) * lay.ldk + d]);
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float qv = to_f32(sQ[(wrow + r) * lay.ldq + d]);
          acc[r][0] = fmaf(qv, k0, acc[r][0]);
          acc[r][1] = fmaf(qv, k1, acc[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        sS[(wrow + r) * lay.lds + lane] = acc[r][0];
        sS[(wrow + r) * lay.lds + lane + 32] = acc[r][1];
      }
    }
    __syncwarp();

    // Online softmax over this tile, one row at a time; each lane holds
    // keys t0 + lane and t0 + lane + 32.
    for (int rr = 0; rr < 16; ++rr) {
      const int r = wrow + rr;
      const int qpos = (row0 + r) / G;
      const int ta = t0 + lane;
      const int tb = ta + 32;
      float s0 = sS[r * lay.lds + lane] * p.scale;
      float s1 = sS[r * lay.lds + lane + 32] * p.scale;
      if (ta >= p.T || (p.causal && ta > qpos)) s0 = kNegInf;
      if (tb >= p.T || (p.causal && tb > qpos)) s1 = kNegInf;
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      const float sum = warp_sum(p0 + p1);
      const float alpha = expf(m_prev - m_new);
      if constexpr (kBf16) {
        sP[r * lay.ldp + lane] = from_f32<T>(p0);
        sP[r * lay.ldp + lane + 32] = from_f32<T>(p1);
      } else {
        sS[r * lay.lds + lane] = p0;
        sS[r * lay.lds + lane + 32] = p1;
      }
      for (int d = lane; d < D; d += 32) sO[r * lay.ldo + d] *= alpha;
      __syncwarp();  // every lane has read sM[r] before lane 0 writes it
      if (lane == 0) {
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncwarp();

    // O[wrow:wrow+16, :] += P V.
    if constexpr (kBf16) {
      for (int d0 = 0; d0 < D; d0 += 16) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, sO + wrow * lay.ldo + d0, lay.ldo,
                               wmma::mem_row_major);
        for (int c0 = 0; c0 < kBK; c0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> bv;
          wmma::load_matrix_sync(a, sP + wrow * lay.ldp + c0, lay.ldp);
          wmma::load_matrix_sync(bv, sV + c0 * lay.ldk + d0, lay.ldk);
          wmma::mma_sync(acc, a, bv, acc);
        }
        wmma::store_matrix_sync(sO + wrow * lay.ldo + d0, acc, lay.ldo,
                                wmma::mem_row_major);
      }
    } else {
      // Lane owns columns lane + 32 * jj of the warp's 16 rows.
      float acc[16][kMaxD / 32];
#pragma unroll
      for (int jj = 0; jj < kMaxD / 32; ++jj) {
        const int d = lane + 32 * jj;
#pragma unroll
        for (int r = 0; r < 16; ++r)
          acc[r][jj] = d < D ? sO[(wrow + r) * lay.ldo + d] : 0.f;
      }
      for (int c = 0; c < kBK; ++c) {
#pragma unroll
        for (int jj = 0; jj < kMaxD / 32; ++jj) {
          const int d = lane + 32 * jj;
          const float vv = d < D ? to_f32(sV[c * lay.ldk + d]) : 0.f;
#pragma unroll
          for (int r = 0; r < 16; ++r)
            acc[r][jj] = fmaf(sS[(wrow + r) * lay.lds + c], vv, acc[r][jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < kMaxD / 32; ++jj) {
        const int d = lane + 32 * jj;
        if (d < D) {
#pragma unroll
          for (int r = 0; r < 16; ++r) sO[(wrow + r) * lay.ldo + d] = acc[r][jj];
        }
      }
    }
    __syncwarp();
  }

  // out = acc / max(l, 1e-30), in q's type.
  T* o = static_cast<T*>(p.o);
  for (int rr = 0; rr < 16; ++rr) {
    const int r = wrow + rr;
    const int fr = row0 + r;
    if (fr >= n_rows) break;
    const int s = fr / G;
    const int h = kvh * G + (fr - s * G);
    const float l = fmaxf(sL[r], 1e-30f);
    T* dst = o + b * p.o_sb + s * p.o_ss + h * p.o_sh;
    for (int d = lane; d < D; d += 32) dst[d] = from_f32<T>(sO[r * lay.ldo + d] / l);
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  // Raise the dynamic shared-memory limit once, to what D = kMaxD needs
  // (function-local static: initialised once, thread-safe).
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Layout<T>(kMaxD).bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int G = p.H / p.KV;
  const dim3 grid((p.S * G + kRows - 1) / kRows, p.KV, p.B);
  flash_fwd_kernel<T><<<grid, kThreads, Layout<T>(p.D).bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (b, s, h)
// of q, (b, t, kv) of k, of v, and (b, s, h) of out; the last dimension of
// every tensor is contiguous. Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* out,
                                   const int64_t* strides, int B, int S, int T,
                                   int H, int KV, int D, int causal,
                                   float scale, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || D % 16 != 0 ||
      D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_st = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_st = strides[7];
  p.v_sh = strides[8];
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.B = B;
  p.S = S;
  p.T = T;
  p.H = H;
  p.KV = KV;
  p.D = D;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(p, st);
  if (dtype == 0) return launch<float>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
