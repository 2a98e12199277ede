// Decode attention: one query token per batch row against a KV cache, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// repro_torch/kernels/attention.py.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/decode_attention.py
// (decode_attention_fwd, body _kernel). It computes what that kernel
// computes: for batch row b and head h = kv * G + g,
//     out[b, h] = softmax_t(q[b, h] . k[b, t, kv] / sqrt(D)) @ v[b, :, kv]
// over the cache rows t < n_b = min(kv_len[b], T), float32 scores, max and
// sums, and the output cast to q's type. A kv_len of 0 or less masks every
// row at -1e30 as the Pallas kernel does, which leaves the uniform average
// of all T rows. bfloat16 and float32 inputs; D a multiple of 8, at most 128;
// K and V read in place through their [B, T, KV, D] strides, 16-byte rows.
//
// What bounds it: bytes. Each valid cache row of K and V is read once and
// feeds about 2 * G flops a byte pair, against the card's ~295 flops a byte
// in bf16, so CUDA cores have arithmetic to spare; what a decode kernel
// lacks is bytes in flight. The design:
//   1. Grid (split, kv head, batch row): one block serves all G heads of its
//      kv head, so each cache row is read once for the G heads. The wrapper
//      picks the split count S for at most two full waves of blocks on the
//      card (a few blocks past a full wave would run alone at one block's
//      rate, after the rest are done).
//   2. Split s of row b covers rows [s * n_b / S, (s + 1) * n_b / S), with
//      n_b read on the device, so every block of a ragged batch does about
//      the same share of its own row and no block exists only to exit. A
//      split with no rows (n_b < S) writes m = -1e30, l = 0, acc = 0, which
//      the combine weighs 0.
//   3. K and V tiles stream through a ring of kStages = 3 shared-memory
//      stages (48 KB) by 16-byte cp.async.cg copies (commit_group /
//      wait_group): each thread keeps two tiles of its own copies in flight
//      (16 copies, 256 bytes; 32 KB a block, 128 KB an SM at four blocks)
//      while it computes on the oldest. Every thread copies exactly the
//      16-byte chunks it later reads, so the ring needs no block barrier.
//      The per-tile arithmetic, not the copies, is what the warps wait on,
//      so the ring is sized for four blocks (16 warps) an SM rather than
//      for a deeper ring.
//   4. One pass with an online softmax: per tile, the G x R scores from
//      shared memory with q in registers (base-2 exponent, log2(e) folded
//      into q), the running max m and sum l per head, the accumulator
//      rescaled once per tile, then p . V on the same tile. acc[G][D] is
//      spread over the lanes in registers and reduced over the warps once,
//      at the end of the block, into one float32 partial (acc, m, l) of
//      [B, H, S, D + 2].
//   5. A second small launch combines the S partials of each (b, h).
// The group heads are a template, GM = 1, 3, 4, 8 (the configs' G; G = 2
// runs on GM = 4, G = 5 to 7 on GM = 8, a larger G on head groups of 8),
// so G = 3 does three heads' work. The wrapper allocates the scratch; the kernels allocate
// nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // decode_attention.py:NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 128;
// A warp reads kSteps row groups of a tile; a tile of K (or of V) is then
// kSteps * kWarps * 32 lanes * 16 bytes = 8 KB at any D (fewer rows for a
// wider row): 32 rows of bf16 or 16 of float32 at D = 128.
constexpr int kSteps = 4;
constexpr int kTileBytes = kSteps * kWarps * 32 * 16;
constexpr int kStages = 3;  // ring depth: 3 x (K + V) = 48 KB a block
constexpr int kRingBytes = kStages * 2 * kTileBytes;
static_assert(kRingBytes <= 48 * 1024, "more needs cudaFuncSetAttribute");
// Blocks an SM for up to four group heads (attention.DECODE_BLOCKS_PER_SM):
// four rings fit its shared memory, and at most 128 registers a thread.
constexpr int kBlocksPerSm = 4;

struct Params {
  const void* q;      // [B, H, D], strides q_sb, q_sh
  const void* k;      // [B, T, KV, D] cache, strides k_sb, k_st, k_sh
  const void* v;
  const int* kv_len;  // [B] int32, or null: every row has kv_len_all
  int kv_len_all;
  void* o;            // [B, H, D] contiguous
  float* part;        // [B, H, S, D + 2]: split accumulator, then m and l
  int64_t q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int B, T, H, KV, D, S;
  float scale_log2;   // log2(e) / sqrt(D)
};

// Rows of the cache that row b attends to, and whether all are masked.
__device__ __forceinline__ int valid_rows(const Params& p, int b, bool* none) {
  const int len = p.kv_len != nullptr ? p.kv_len[b] : p.kv_len_all;
  *none = len <= 0;
  return *none ? p.T : min(len, p.T);
}

// kN elements of one 16-byte chunk, as float32.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const void* src, float* x) {
    const float4 r = *reinterpret_cast<const float4*>(src);
    x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const void* src, float* x) {
    const uint4 r = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

// 2^x in one MUFU instruction (2 ulp; results below 2^-126 flush to 0, and
// -inf gives 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Sum of x over the lpr lanes (a power of two) of this lane's row group.
// The rounds are unrolled with a warp-uniform predicate rather than a loop
// bounded by lpr, so the reductions of all heads and row steps of a tile
// interleave instead of waiting on one another's shuffles.
__device__ __forceinline__ float sum_row_group(float x, int lpr) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    if (off < lpr) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Pass 1: block (split, kv head x head group, b); GM is the most group
// heads one block serves (heads g0 .. g0 + GM - 1 of its kv head). lpr
// lanes (a power of two) read one cache row, chunk `sub` each.
template <typename T, int GM>
__global__ void __launch_bounds__(kThreads, GM <= 4 ? kBlocksPerSm : 1)
    decode_split_kernel(const Params p, int lpr) {
  using C = Chunk<T>;
  constexpr int kN = C::kN;
  extern __shared__ __align__(16) unsigned char ring[];

  const int G = p.H / p.KV;
  const int n_gb = (G + GM - 1) / GM;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / n_gb;
  const int g0 = (blockIdx.y - kvh * n_gb) * GM;
  const int b = blockIdx.z;
  bool none;
  const int n = valid_rows(p, b, &none);
  const int r0 = static_cast<int>(static_cast<int64_t>(split) * n / p.S);
  const int r1 = static_cast<int>(static_cast<int64_t>(split + 1) * n / p.S);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rps = 32 / lpr;               // rows a warp reads at once
  const int R = kSteps * kWarps * rps;    // rows a tile
  const int sub = lane % lpr;             // this lane's chunk of a row
  const int grp = lane / lpr;             // this lane's row of the warp's rps
  const bool dlive = sub * kN < p.D;
  const int row_bytes = p.D * static_cast<int>(sizeof(T));
  const int n_tiles = (r1 - r0 + R - 1) / R;

  // This lane's chunk of the block's query heads, scaled, in registers.
  float qr[GM][kN];
  {
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + sub * kN;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (dlive && g0 + g < G) {
        C::load(q + (kvh * G + g0 + g) * p.q_sh, qr[g]);
#pragma unroll
        for (int i = 0; i < kN; ++i) qr[g][i] *= p.scale_log2;
      } else {
#pragma unroll
        for (int i = 0; i < kN; ++i) qr[g][i] = 0.f;
      }
    }
  }

  const unsigned char* kg = static_cast<const unsigned char*>(p.k) +
                            (b * p.k_sb + kvh * p.k_sh) * sizeof(T) + sub * 16;
  const unsigned char* vg = static_cast<const unsigned char*>(p.v) +
                            (b * p.v_sb + kvh * p.v_sh) * sizeof(T) + sub * 16;
  const int64_t k_row = p.k_st * sizeof(T), v_row = p.v_st * sizeof(T);

  // Row of the tile that this lane reads (and copies) at step i.
  auto tile_row = [&](int i) { return (i * kWarps + warp) * rps + grp; };

  auto load_tile = [&](int j) {
    unsigned char* sk = ring + (j % kStages) * 2 * kTileBytes + sub * 16;
    unsigned char* sv = sk + kTileBytes;
    const int t0 = r0 + j * R;
    if (!dlive) return;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int rr = tile_row(i);
      const bool live = t0 + rr < r1;
      const int64_t t = live ? t0 + rr : r0;  // a row that exists
      cp_async16(sk + rr * row_bytes, kg + t * k_row, live);
      cp_async16(sv + rr * row_bytes, vg + t * v_row, live);
    }
  };

  float m[GM], l[GM], acc[GM][kN];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[g][i] = 0.f;
  }

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) load_tile(j);
    cp_async_commit();
  }
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();  // this lane's copies of tile j landed
    // Refill the stage of tile j - 1, which this lane alone has read.
    if (j + kStages - 1 < n_tiles) load_tile(j + kStages - 1);
    cp_async_commit();

    const unsigned char* sk = ring + (j % kStages) * 2 * kTileBytes + sub * 16;
    const unsigned char* sv = sk + kTileBytes;
    const int t0 = r0 + j * R;

    // Scores of this lane's rows (log2 domain); -inf past the split.
    float s[GM][kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int rr = tile_row(i);
      float kx[kN];
      if (dlive) {
        C::load(sk + rr * row_bytes, kx);
      } else {
#pragma unroll
        for (int e = 0; e < kN; ++e) kx[e] = 0.f;
      }
      const bool live = t0 + rr < r1;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kN; ++e) dot = fmaf(qr[g][e], kx[e], dot);
        dot = sum_row_group(dot, lpr);
        s[g][i] = !live ? -INFINITY : (none ? kNegInf : dot);
      }
    }

    // Tile max over the warp's rows, one rescale, then p = 2^(s - m).
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = s[g][0];
#pragma unroll
      for (int i = 1; i < kSteps; ++i) mx = fmaxf(mx, s[g][i]);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        if (off >= lpr) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = m_new == m[g] ? 1.f : fast_exp2(m[g] - m_new);
      m[g] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
        s[g][i] = s[g][i] == -INFINITY ? 0.f : fast_exp2(s[g][i] - m_new);
        sum += s[g][i];
      }
      l[g] = fmaf(l[g], alpha, sum);
#pragma unroll
      for (int e = 0; e < kN; ++e) acc[g][e] *= alpha;
    }

    // acc += p . V over the same rows (zero-filled past the split).
    if (dlive) {
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
        float vx[kN];
        C::load(sv + tile_row(i) * row_bytes, vx);
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int e = 0; e < kN; ++e) acc[g][e] = fmaf(s[g][i], vx[e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();

  // Sum l and acc over the warp's row groups (m is already warp-uniform).
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      if (off < lpr) continue;
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int e = 0; e < kN; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
    }
  }

  // Then over the warps, through the ring's memory: red[warp][g] holds
  // acc[0 .. D), m, l.
  constexpr int kRed = kMaxD + 2;
  static_assert(kWarps * GM * kRed * sizeof(float) <= kRingBytes, "red fits the ring");
  float* red = reinterpret_cast<float*>(ring);
  __syncthreads();  // every lane is past its last read of the ring
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float* r = red + (warp * GM + g) * kRed;
      if (dlive)
#pragma unroll
        for (int e = 0; e < kN; ++e) r[sub * kN + e] = acc[g][e];
      if (lane == 0) {
        r[kMaxD] = m[g];
        r[kMaxD + 1] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < GM * p.D; i += kThreads) {
    const int g = i / p.D;
    const int d = i - g * p.D;
    if (g0 + g >= G) break;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red[(w * GM + g) * kRed + kMaxD]);
    float num = 0.f, den = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* r = red + (w * GM + g) * kRed;
        const float wt = exp2f(r[kMaxD] - M);  // 0 for a warp with no rows
        num = fmaf(wt, r[d], num);
        den = fmaf(wt, r[kMaxD + 1], den);
      }
    }
    float* out = p.part +
                 (((int64_t)b * p.H + kvh * G + g0 + g) * p.S + split) * (p.D + 2);
    out[d] = num;
    if (d == 0) {
      out[p.D] = M == -INFINITY ? kNegInf : M;  // an empty split
      out[p.D + 1] = den;
    }
  }
}

// Pass 2: block (h, b), thread d: out = sum_s 2^(m_s - M) acc_s / sum_s
// 2^(m_s - M) l_s over the S splits.
template <typename T>
__global__ void __launch_bounds__(kMaxD) decode_combine_kernel(const Params p) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int64_t row = (int64_t)b * p.H + h;
  const int w = p.D + 2;
  const float* part = p.part + row * p.S * w;
  float M = kNegInf;
  for (int s = 0; s < p.S; ++s) M = fmaxf(M, part[s * w + p.D]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < p.S; ++s) {
    const float wt = exp2f(part[s * w + p.D] - M);
    den = fmaf(wt, part[s * w + p.D + 1], den);
    if (d < p.D) num = fmaf(wt, part[s * w + d], num);
  }
  if (d < p.D) {
    T* o = static_cast<T*>(p.o) + row * p.D;
    o[d] = from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int GM>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int kN = Chunk<T>::kN;
  int lpr = 1;
  while (lpr * kN < p.D) lpr <<= 1;  // D <= 128 keeps lpr <= 32
  const int G = p.H / p.KV;
  const dim3 grid1(p.S, p.KV * ((G + GM - 1) / GM), p.B);
  decode_split_kernel<T, GM><<<grid1, kThreads, kRingBytes, stream>>>(p, lpr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2(p.H, p.B);
  decode_combine_kernel<T><<<grid2, kMaxD, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  switch (p.H / p.KV) {
    case 1: return launch<T, 1>(p, stream);
    case 3: return launch<T, 3>(p, stream);
    case 2:
    case 4: return launch<T, 4>(p, stream);
    default: return launch<T, 8>(p, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kv_len: [B] int32 on the card, or null
// and then every row has kv_len_all. strides: 8 element strides, (b, h) of
// q, (b, t, kv) of k and of v; the last dimension of every tensor is
// contiguous and out is a contiguous [B, H, D]. part holds B * H *
// n_splits * (D + 2) floats. Returns the cudaError_t of the launches.
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, const int* kv_len,
                                    int kv_len_all, void* out, float* part,
                                    const int64_t* strides, int B, int T,
                                    int H, int KV, int D, int n_splits,
                                    float scale, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || KV <= 0 || H % KV != 0 || H > 65535 ||
      D % 8 != 0 || D <= 0 || D > kMaxD || n_splits <= 0 || n_splits > T)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_len = kv_len;
  p.kv_len_all = kv_len_all;
  p.o = out;
  p.part = part;
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
  p.S = n_splits;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, st);
  if (dtype == 0) return dispatch<float>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
