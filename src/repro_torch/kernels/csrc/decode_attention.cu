// Decode attention: one query token per batch row against a KV cache, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// repro_torch/kernels/attention.py.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/decode_attention.py
// (decode_attention_fwd, body _kernel). It computes what that kernel
// computes: for batch row b and head h = kv * G + g,
//     out[b, h] = softmax_t(q[b, h] . k[b, t, kv] / sqrt(D)) @ v[b, :, kv]
// over the cache rows t < kv_len[b], float32 scores, max and sums, and the
// output cast to q's type. A kv_len of T or more takes every row; a kv_len
// of 0 or less masks every row at -1e30 as the Pallas kernel does, which
// leaves the uniform average of all T rows. bfloat16 and float32 inputs; D
// a multiple of 8, at most 128.
//
// What bounds it: bytes. Each valid cache row is read once, K and V, and
// every byte feeds 2 * G flops, far below the card's ~295 flops per byte.
// So the design is about streaming the valid part of the cache at full
// rate:
//   * The cache is read in place through its [B, T, KV, D] strides. (The
//     Pallas wrapper's k.transpose(0, 2, 1, 3) would copy the whole cache
//     once per layer and step.)
//   * Only rows t < kv_len[b] are read: a chunk wholly past kv_len exits at
//     once. (A masked row adds exactly 0 to l and acc, so stopping early
//     gives the same result.)
//   * B * KV blocks alone (64 at B = 8, KV = 8) would leave half of the
//     132 SMs idle and each with one long serial walk. Pass 1 splits the
//     cache into chunks of kChunk rows, one block per (chunk, kv head, batch
//     row), and writes each chunk's max, sum and unnormalised accumulator
//     (float32) to a scratch buffer; pass 2 combines the chunks of each
//     (batch row, head). The scratch is about 1/40 of the cache bytes read.
//   * Within a block, a group of lanes reads one cache row with 16-byte
//     loads (bfloat16: 16 lanes cover D = 128) and all G heads of the kv
//     head use it, so each row is read once for the G heads.
// The wrapper allocates the scratch; the kernels allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // decode_attention.py:NEG_INF
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 128;  // cache rows per pass-1 block
constexpr int kMaxD = 128;

struct Params {
  const void* q;   // [B, H, D], strides q_sb, q_sh
  const void* k;   // [B, T, KV, D] cache, strides k_sb, k_st, k_sh
  const void* v;
  const int* kv_len;  // [B] int32
  void* o;         // [B, H, D] contiguous
  float* part_ml;  // [B, H, n_chunks, 2]: chunk max m and sum l
  float* part_acc; // [B, H, n_chunks, D]: chunk accumulator
  int64_t q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int B, T, H, KV, D, n_chunks;
  float scale;
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

// kVec elements of one 16-byte load, as float32.
template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
  float x[kN];
  __device__ __forceinline__ void load(const T* src) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kN; ++i) x[i] = to_f32(e[i]);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kN; ++i) x[i] = 0.f;
  }
};

// Rows of the cache that row b attends to, and whether all are masked.
__device__ __forceinline__ int valid_rows(const Params& p, int b, bool* none) {
  const int len = p.kv_len[b];
  *none = len <= 0;
  return *none ? p.T : min(len, p.T);
}

// Pass 1: block (chunk, kv head x head group, b). GM is the most group heads
// one block serves (a block covers heads g0 .. g0 + GM - 1 of its kv head).
template <typename T, int GM>
__global__ void __launch_bounds__(kThreads)
    decode_chunk_kernel(const Params p, int lanes_per_row) {
  constexpr int kN = Vec<T>::kN;
  __shared__ float sS[GM][kChunk];            // scores, then p
  __shared__ float sAcc[kWarps][GM][kMaxD];   // per-warp partial acc

  const int G = p.H / p.KV;
  const int n_gb = (G + GM - 1) / GM;
  const int chunk = blockIdx.x;
  const int kvh = blockIdx.y / n_gb;
  const int g0 = (blockIdx.y - kvh * n_gb) * GM;
  const int b = blockIdx.z;
  bool none;
  const int n_valid = valid_rows(p, b, &none);
  const int t0 = chunk * kChunk;
  if (t0 >= n_valid) return;  // wholly past kv_len: pass 2 skips it
  const int t1 = min(t0 + kChunk, n_valid);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int lpr = lanes_per_row;       // power of two, lanes per cache row
  const int rows_per_warp = 32 / lpr;
  const int sub = lane % lpr;          // this lane's slice of the row
  const int d0 = sub * kN;
  const bool dlive = d0 < p.D;
  const int row_in_warp = lane / lpr;

  // This lane's slice of the block's query heads, in registers.
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb;
  float qr[GM][kN];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    Vec<T> x;
    if (dlive && g0 + g < G)
      x.load(q + (kvh * G + g0 + g) * p.q_sh + d0);
    else
      x.zero();
#pragma unroll
    for (int i = 0; i < kN; ++i) qr[g][i] = x.x[i];
  }

  // Scores. Lanes of one row group reduce their partial dot products; the
  // loop bound is warp-uniform so every lane reaches every shuffle.
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh + d0;
  for (int tb = t0 + warp * rows_per_warp; tb < t1;
       tb += kWarps * rows_per_warp) {
    const int t = tb + row_in_warp;
    const bool live = t < t1;
    Vec<T> kx;
    if (live && dlive)
      kx.load(k + t * p.k_st);
    else
      kx.zero();
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kN; ++i) dot = fmaf(qr[g][i], kx.x[i], dot);
      for (int off = lpr / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (live && sub == 0) sS[g][t - t0] = none ? kNegInf : dot * p.scale;
    }
  }
  __syncthreads();

  // Chunk max and p = exp(s - m); warp w takes heads w, w + kWarps, ...
  const int n = t1 - t0;
  for (int g = warp; g < GM; g += kWarps) {
    float m = kNegInf;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, sS[g][i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(sS[g][i] - m);
      sS[g][i] = e;
      l += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0 && g0 + g < G) {
      float* ml = p.part_ml +
                  (((int64_t)b * p.H + kvh * G + g0 + g) * p.n_chunks + chunk) * 2;
      ml[0] = m;
      ml[1] = l;
    }
  }
  __syncthreads();

  // acc[g][d] = sum_t p[g][t] v[t][d].
  float acc[GM][kN];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[g][i] = 0.f;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh + d0;
  for (int tb = t0 + warp * rows_per_warp; tb < t1;
       tb += kWarps * rows_per_warp) {
    const int t = tb + row_in_warp;
    if (t < t1 && dlive) {
      Vec<T> vx;
      vx.load(v + t * p.v_st);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float pg = sS[g][t - t0];
#pragma unroll
        for (int i = 0; i < kN; ++i) acc[g][i] = fmaf(pg, vx.x[i], acc[g][i]);
      }
    }
  }
  // Sum over the row groups of the warp, then over the warps.
  for (int off = lpr; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int i = 0; i < kN; ++i)
        acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], off);
  }
  if (row_in_warp == 0 && dlive) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int i = 0; i < kN; ++i) sAcc[warp][g][d0 + i] = acc[g][i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < GM * p.D; i += kThreads) {
    const int g = i / p.D;
    const int d = i - g * p.D;
    if (g0 + g >= G) break;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sAcc[w][g][d];
    p.part_acc[(((int64_t)b * p.H + kvh * G + g0 + g) * p.n_chunks + chunk) *
                   p.D + d] = s;
  }
}

// Pass 2: block (h, b), thread d: out = sum_c e^(m_c - M) acc_c / sum_c
// e^(m_c - M) l_c over the chunks that pass 1 wrote.
template <typename T>
__global__ void __launch_bounds__(kMaxD) decode_combine_kernel(const Params p) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  bool none;
  const int n_valid = valid_rows(p, b, &none);
  const int nc = (n_valid + kChunk - 1) / kChunk;
  const int64_t row = (int64_t)b * p.H + h;
  const float* ml = p.part_ml + row * p.n_chunks * 2;
  const float* acc = p.part_acc + row * p.n_chunks * p.D;
  float m = kNegInf;
  for (int c = 0; c < nc; ++c) m = fmaxf(m, ml[2 * c]);
  float num = 0.f, den = 0.f;
  for (int c = 0; c < nc; ++c) {
    const float w = expf(ml[2 * c] - m);
    den = fmaf(w, ml[2 * c + 1], den);
    if (d < p.D) num = fmaf(w, acc[(int64_t)c * p.D + d], num);
  }
  if (d < p.D) {
    T* o = static_cast<T*>(p.o) + row * p.D;
    o[d] = from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int GM>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int kN = Vec<T>::kN;
  int lpr = 1;
  while (lpr * kN < p.D) lpr <<= 1;  // D <= 128 keeps lpr <= 32
  const int G = p.H / p.KV;
  const dim3 grid1(p.n_chunks, p.KV * ((G + GM - 1) / GM), p.B);
  decode_chunk_kernel<T, GM><<<grid1, kThreads, 0, stream>>>(p, lpr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2(p.H, p.B);
  decode_combine_kernel<T><<<grid2, kMaxD, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  const int G = p.H / p.KV;
  if (G == 1) return launch<T, 1>(p, stream);
  if (G <= 4) return launch<T, 4>(p, stream);
  return launch<T, 8>(p, stream);
}

}  // namespace

// Chunks of kChunk cache rows that pass 1 may write per (batch row, head):
// the wrapper sizes the scratch buffers with it.
extern "C" int decode_attention_chunks(int T) {
  return (T + kChunk - 1) / kChunk;
}

// dtype: 0 = float32, 1 = bfloat16. strides: 8 element strides, (b, h) of
// q, (b, t, kv) of k and of v; the last dimension of every tensor is
// contiguous and out is a contiguous [B, H, D]. part_ml holds
// B * H * decode_attention_chunks(T) * 2 floats, part_acc
// B * H * decode_attention_chunks(T) * D. Returns the cudaError_t of the
// launches.
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, const int* kv_len,
                                    void* out, float* part_ml,
                                    float* part_acc, const int64_t* strides,
                                    int B, int T, int H, int KV, int D,
                                    float scale, void* stream) {
  if (B <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || D % 8 != 0 || D <= 0 ||
      D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_len = kv_len;
  p.o = out;
  p.part_ml = part_ml;
  p.part_acc = part_acc;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.k_sb = strides[2];
  p.k_st = strides[3];
  p.k_sh = strides[4];
  p.v_sb = strides[5];
  p.v_st = strides[6];
  p.v_sh = strides[7];
  p.B = B;
  p.T = T;
  p.H = H;
  p.KV = KV;
  p.D = D;
  p.n_chunks = decode_attention_chunks(T);
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, st);
  if (dtype == 0) return dispatch<float>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
