// GQA flash attention, backward pass, for Hopper (sm_90a). Plain C interface,
// loaded with ctypes by repro_torch/kernels/attention.py.
//
// The JAX package has no Pallas backward kernel: its flash attention's
// gradient is the pure-jnp custom VJP src/repro/models/flash.py::_flash_bwd
// (flash.py:108), whose residuals (q, k, v, o, lse) come from the forward
// (flash_attention.cu writes lse). These kernels compute what _flash_bwd
// computes, with folded rows i = s * G + g of one kv head (G = H / KV):
//
//   delta[i]  = sum_d do[i, d] * o[i, d]                      (float32)
//   s[i, t]   = q[i] . k[t] * scale,  masked (causal: t > s) and t >= T
//   p[i, t]   = exp(s[i, t] - lse[i])                         (float32)
//   dp[i, t]  = do[i] . v[t]                                  (float32)
//   ds[i, t]  = p[i, t] * (dp[i, t] - delta[i]) * scale       (float32)
//   dv[t]     = sum_i round_v(p[i, t]) * do[i]
//   dk[t]     = sum_i round_q(ds[i, t]) * q[i]
//   dq[i]     = sum_t round_q(ds[i, t]) * k[t]
//
// The rounding points are the reference's (flash.py:137-146, pv and dsv):
// p rounded to v's type for dv, ds to q's type for dq and dk; s, dp and every
// accumulator are float32; dq, dk, dv are written once in the inputs' type.
// The G query heads of a kv head are summed inside the kernel (the port
// passes K and V unrepeated). Three kernels, no atomics, so every result is
// the same from run to run:
//   (a) flash_bwd_delta: one warp per (b, s, h) row.
//   (b) flash_bwd_dkdv: one block per (batch, kv head, key tile); it walks
//       the folded query rows that can see the tile (causal: s >= the tile's
//       first key) and writes dk and dv once.
//   (c) flash_bwd_dq: one block per (batch, kv head, folded row tile); it
//       walks the key tiles up to the tile's last query and writes dq once.
// Any S and T: rows i >= S * G and keys t >= T are masked by index.
//
// What bounds it. (b) and (c) recompute s and dp, so the pass runs 7
// products of the forward's size where the forward runs 2; the bound
// counts the backward's operations as 2.5x the forward's (5 products) and
// the bytes of q, k, v, o, do, lse read once and dq, dk, dv written once.
// At llama3.2-3b's training shape (B 4, S = T 1,024, H 24, KV 8, D 128,
// causal) that is operations. This first version is simple: the bf16 body
// runs mma.sync m16n8k16 (bf16 in, float32 accumulate) from padded shared
// tiles read by ldmatrix, with plain synchronous tile loads; a wgmma / TMA
// redesign is later work. The float32 body (the tests' type, held at 2e-5)
// runs float32 FMAs on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxD = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;    // [B, S, H]
  const float* delta;  // [B, S, H]
  float* delta_out;    // (a) writes delta here
  void* dq;            // [B, S, H, D] contiguous
  void* dk;            // [B, T, KV, D] contiguous
  void* dv;            // [B, T, KV, D] contiguous
  int64_t q_sb, q_ss, q_sh;  // element strides over b, s, h
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int64_t d_sb, d_ss, d_sh;  // do
  int B, S, T, H, KV, D;
  int causal;
  float scale;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Offset of folded row i (= s * G + g of kv head kvh) in a [B, S, H, ...]
// tensor with element strides (sb, ss, sh).
__device__ __forceinline__ int64_t row_off(int b, int i, int kvh, int G, int64_t sb,
                                           int64_t ss, int64_t sh) {
  const int s = i / G;
  return b * sb + s * ss + (kvh * G + (i - s * G)) * sh;
}

// Index of folded row i of kv head kvh in a contiguous [B, S, H] tensor.
__device__ __forceinline__ int64_t lse_index(const Params& p, int b, int i, int kvh,
                                             int G) {
  const int s = i / G;
  return (static_cast<int64_t>(b) * p.S + s) * p.H + kvh * G + (i - s * G);
}

// Whether folded row i sees key t.
__device__ __forceinline__ bool visible(const Params& p, int i, int t, int n_rows,
                                        int G) {
  return i < n_rows && t < p.T && (!p.causal || t <= i / G);
}

// ---------------------------------------------------------------------------
// (a) delta: one warp per (b, s, h) row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(128) flash_bwd_delta_kernel(const Params p) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= p.B * p.S * p.H) return;
  const int h = row % p.H;
  const int s = row / p.H % p.S;
  const int b = row / p.H / p.S;
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + s * p.o_ss + h * p.o_sh;
  const T* d = static_cast<const T*>(p.dout) + b * p.d_sb + s * p.d_ss + h * p.d_sh;
  float acc = 0.f;
  for (int c = lane; c < p.D; c += 32) acc = fmaf(to_f(d[c]), to_f(o[c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) p.delta_out[row] = acc;
}

// ---------------------------------------------------------------------------
// float32 bodies: CUDA-core FMAs
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // keys and folded rows per tile

// Shared tiles: four [32, D + 1] (odd pitch: a column read by 8 rows hits 8
// banks), two [32, 33] score tiles, lse and delta.
struct Layout {
  int ld;
  size_t a, b, c, d, s1, s2, lse, delta, bytes;
  __host__ __device__ explicit Layout(int D) {
    ld = D + 1;
    const size_t tile = sizeof(float) * kTile * ld;
    a = 0;
    b = a + tile;
    c = b + tile;
    d = c + tile;
    s1 = d + tile;
    s2 = s1 + sizeof(float) * kTile * (kTile + 1);
    lse = s2 + sizeof(float) * kTile * (kTile + 1);
    delta = lse + sizeof(float) * kTile;
    bytes = delta + sizeof(float) * kTile;
  }
};

// Rows [r0, r0 + 32) of a [B, T, KV, D] tensor (kv head kvh), zero past T.
__device__ __forceinline__ void load_keys(float* dst, int ld, const float* src,
                                          int64_t st, int r0, int T, int D) {
  for (int x = threadIdx.x; x < kTile * D; x += kThreads) {
    const int r = x / D;
    const int c = x - r * D;
    dst[r * ld + c] = r0 + r < T ? src[(r0 + r) * st + c] : 0.f;
  }
}

// Folded rows [i0, i0 + 32) of q-shaped tensors (and their lse, delta).
__device__ __forceinline__ void load_rows(const Params& p, float* sq, float* sdo,
                                          float* slse, float* sdelta, int ld, int b,
                                          int kvh, int i0, int n_rows, int G) {
  const float* q = static_cast<const float*>(p.q);
  const float* d = static_cast<const float*>(p.dout);
  for (int x = threadIdx.x; x < kTile * p.D; x += kThreads) {
    const int r = x / p.D;
    const int c = x - r * p.D;
    const int i = i0 + r;
    const bool ok = i < n_rows;
    sq[r * ld + c] = ok ? q[row_off(b, i, kvh, G, p.q_sb, p.q_ss, p.q_sh) + c] : 0.f;
    sdo[r * ld + c] = ok ? d[row_off(b, i, kvh, G, p.d_sb, p.d_ss, p.d_sh) + c] : 0.f;
  }
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int i = i0 + r;
    const bool ok = i < n_rows;
    slse[r] = ok ? p.lse[lse_index(p, b, i, kvh, G)] : 0.f;
    sdelta[r] = ok ? p.delta[lse_index(p, b, i, kvh, G)] : 0.f;
  }
}

// (b) dk, dv of 32 keys. Thread x owns key x / 4 and columns x % 4 + 4 j.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_f32(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(D);
  const int ld = lay.ld;
  float* sK = reinterpret_cast<float*>(smem + lay.a);
  float* sV = reinterpret_cast<float*>(smem + lay.b);
  float* sQ = reinterpret_cast<float*>(smem + lay.c);
  float* sD = reinterpret_cast<float*>(smem + lay.d);
  float* sP = reinterpret_cast<float*>(smem + lay.s1);   // [key][row]
  float* sS = reinterpret_cast<float*>(smem + lay.s2);   // [key][row]
  float* sLse = reinterpret_cast<float*>(smem + lay.lse);
  float* sDelta = reinterpret_cast<float*>(smem + lay.delta);

  const int G = p.H / p.KV;
  const int n_rows = p.S * G;
  const int t0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int kr = threadIdx.x / 4;
  const int cq = threadIdx.x % 4;
  const int t = t0 + kr;

  load_keys(sK, ld, static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh, p.k_st,
            t0, p.T, D);
  load_keys(sV, ld, static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh, p.v_st,
            t0, p.T, D);
  float dk[D / 4], dv[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) dk[j] = dv[j] = 0.f;

  for (int i0 = p.causal ? t0 * G : 0; i0 < n_rows; i0 += kTile) {
    __syncthreads();  // the last step is done with the row tiles
    load_rows(p, sQ, sD, sLse, sDelta, ld, b, kvh, i0, n_rows, G);
    __syncthreads();
    float s[8], dp[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) s[jj] = dp[jj] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float kc = sK[kr * ld + c];
      const float vc = sV[kr * ld + c];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        s[jj] = fmaf(kc, sQ[(cq + 4 * jj) * ld + c], s[jj]);
        dp[jj] = fmaf(vc, sD[(cq + 4 * jj) * ld + c], dp[jj]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int r = cq + 4 * jj;
      const bool ok = visible(p, i0 + r, t, n_rows, G);
      const float pv = ok ? expf(s[jj] * p.scale - sLse[r]) : 0.f;
      sP[kr * (kTile + 1) + r] = pv;
      sS[kr * (kTile + 1) + r] = ok ? pv * (dp[jj] - sDelta[r]) * p.scale : 0.f;
    }
    __syncwarp();  // a key's row of sP / sS is written by its 4 threads
    for (int r = 0; r < kTile; ++r) {
      const float pr = sP[kr * (kTile + 1) + r];
      const float dr = sS[kr * (kTile + 1) + r];
#pragma unroll
      for (int j = 0; j < D / 4; ++j) {
        dv[j] = fmaf(pr, sD[r * ld + cq + 4 * j], dv[j]);
        dk[j] = fmaf(dr, sQ[r * ld + cq + 4 * j], dk[j]);
      }
    }
  }
  if (t < p.T) {
    float* gk = static_cast<float*>(p.dk) + ((static_cast<int64_t>(b) * p.T + t) * p.KV + kvh) * D;
    float* gv = static_cast<float*>(p.dv) + ((static_cast<int64_t>(b) * p.T + t) * p.KV + kvh) * D;
#pragma unroll
    for (int j = 0; j < D / 4; ++j) {
      gk[cq + 4 * j] = dk[j];
      gv[cq + 4 * j] = dv[j];
    }
  }
}

// (c) dq of 32 folded rows. Thread x owns row x / 4 and columns x % 4 + 4 j.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(D);
  const int ld = lay.ld;
  float* sQ = reinterpret_cast<float*>(smem + lay.a);
  float* sD = reinterpret_cast<float*>(smem + lay.b);
  float* sK = reinterpret_cast<float*>(smem + lay.c);
  float* sV = reinterpret_cast<float*>(smem + lay.d);
  float* sS = reinterpret_cast<float*>(smem + lay.s1);  // [row][key]
  float* sLse = reinterpret_cast<float*>(smem + lay.lse);
  float* sDelta = reinterpret_cast<float*>(smem + lay.delta);

  const int G = p.H / p.KV;
  const int n_rows = p.S * G;
  const int i0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int qr = threadIdx.x / 4;
  const int ck = threadIdx.x % 4;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  load_rows(p, sQ, sD, sLse, sDelta, lay.ld, b, kvh, i0, n_rows, G);
  float dq[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) dq[j] = 0.f;
  int t_end = p.T;  // causal: keys up to the tile's last query
  if (p.causal) t_end = min(t_end, (min(i0 + kTile, n_rows) - 1) / G + 1);

  for (int t0 = 0; t0 < t_end; t0 += kTile) {
    __syncthreads();  // the row tiles are in place; the last step is done
    load_keys(sK, ld, kb, p.k_st, t0, p.T, D);
    load_keys(sV, ld, vb, p.v_st, t0, p.T, D);
    __syncthreads();
    float s[8], dp[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) s[jj] = dp[jj] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float qc = sQ[qr * ld + c];
      const float dc = sD[qr * ld + c];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        s[jj] = fmaf(qc, sK[(ck + 4 * jj) * ld + c], s[jj]);
        dp[jj] = fmaf(dc, sV[(ck + 4 * jj) * ld + c], dp[jj]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int tc = ck + 4 * jj;
      const bool ok = visible(p, i0 + qr, t0 + tc, n_rows, G);
      const float pv = ok ? expf(s[jj] * p.scale - sLse[qr]) : 0.f;
      sS[qr * (kTile + 1) + tc] = ok ? pv * (dp[jj] - sDelta[qr]) * p.scale : 0.f;
    }
    __syncwarp();
    for (int tc = 0; tc < kTile; ++tc) {
      const float dr = sS[qr * (kTile + 1) + tc];
#pragma unroll
      for (int j = 0; j < D / 4; ++j) dq[j] = fmaf(dr, sK[tc * ld + ck + 4 * j], dq[j]);
    }
  }
  const int i = i0 + qr;
  if (i < n_rows) {
    float* g = static_cast<float*>(p.dq) + row_off(b, i, kvh, G, static_cast<int64_t>(p.S) * p.H * D,
                                                  static_cast<int64_t>(p.H) * D, D);
#pragma unroll
    for (int j = 0; j < D / 4; ++j) g[ck + 4 * j] = dq[j];
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16 bodies: mma.sync m16n8k16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // 4 warps, 16 accumulator rows each
constexpr int kRows = 64;      // accumulator rows of a block (keys in (b), rows in (c))
constexpr int kStep = 32;      // (b): folded rows per step; (c) takes 64 keys a step

// Shared tiles of bf16 rows padded by 16 bytes: 8 rows read by one ldmatrix
// fall in 8 different 16-byte bank groups.
template <int D>
struct Cfg {
  static_assert(D % 16 == 0 && D <= kMaxD, "D must be a multiple of 16, <= 128");
  static constexpr int kP = D + 8;  // row pitch in elements
  // (b): K, V [64, P] for the block's life; Q, dO [32, P] a step.
  static constexpr size_t kDkdvBytes =
      sizeof(bf16) * (2 * kRows + 2 * kStep) * kP + 2 * sizeof(float) * kStep;
  // (c): Q, dO [64, P] for the block's life; K, V [64, P] a step.
  static constexpr size_t kDqBytes = sizeof(bf16) * 4 * kRows * kP;
};

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register j receives matrix j's fragment.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Addresses for ldmatrix in a row-major tile of pitch P elements.
// A operand (16 rows x 16 columns at (r0, c0)): matrices (r0, c0),
// (r0 + 8, c0), (r0, c0 + 8), (r0 + 8, c0 + 8) -> a[0..3].
__device__ __forceinline__ uint32_t a_addr(const bf16* tile, int P, int r0, int c0,
                                           int lane) {
  const int m = lane / 8;
  return smem_addr(tile + (r0 + lane % 8 + 8 * (m & 1)) * P + c0 + 8 * (m >> 1));
}
// B operand of two n-tiles from a tile stored [n][k] (B[k][n] = tile[n][k]):
// matrices (n0, k0), (n0, k0 + 8), (n0 + 8, k0), (n0 + 8, k0 + 8) ->
// (b0, b1) of n-tile n0 and of n-tile n0 + 8.
__device__ __forceinline__ uint32_t bn_addr(const bf16* tile, int P, int n0, int k0,
                                            int lane) {
  const int m = lane / 8;
  return smem_addr(tile + (n0 + lane % 8 + 8 * (m >> 1)) * P + k0 + 8 * (m & 1));
}
// B operand of two n-tiles from a tile stored [k][n] (read transposed):
// matrices (k0, n0), (k0 + 8, n0), (k0, n0 + 8), (k0 + 8, n0 + 8).
__device__ __forceinline__ uint32_t bk_addr(const bf16* tile, int P, int k0, int n0,
                                            int lane) {
  const int m = lane / 8;
  return smem_addr(tile + (k0 + lane % 8 + 8 * (m & 1)) * P + n0 + 8 * (m >> 1));
}

// 16-byte copies of `rows` rows into a padded tile; row r comes from
// src(r), or is zero where src(r) is null.
template <int D, typename F>
__device__ __forceinline__ void load_tile(bf16* dst, int rows, F src) {
  constexpr int kChunks = D / 8;
  for (int x = threadIdx.x; x < rows * kChunks; x += kThreads) {
    const int r = x / kChunks;
    const int c = (x - r * kChunks) * 8;
    const bf16* s = src(r);
    *reinterpret_cast<uint4*>(dst + r * Cfg<D>::kP + c) =
        s != nullptr ? *reinterpret_cast<const uint4*>(s + c) : make_uint4(0, 0, 0, 0);
  }
}

// The two accumulator fragments (n-tiles 2j, 2j + 1) of a 16 x 16 block of
// a score tile as the A operand (16 x k16) of the next product.
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&lo)[4],
                                     const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// (b) dk, dv of 64 keys; warp w owns keys t0 + 16 w .. + 15. A step takes 32
// folded rows: S^T = K Q^T and dP^T = V dO^T (16 x 32 a warp), then
// dV += P^T dO and dK += dS^T Q with P^T and dS^T as register A operands.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_bf16(const Params p) {
  using C = Cfg<D>;
  constexpr int P = C::kP;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kRows * P;
  bf16* sQ = sV + kRows * P;
  bf16* sD = sQ + kStep * P;
  float* sLse = reinterpret_cast<float*>(sD + kStep * P);
  float* sDelta = sLse + kStep;

  const int G = p.H / p.KV;
  const int n_rows = p.S * G;
  const int t0 = blockIdx.x * kRows;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tg = lane % 4;
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* dout = static_cast<const bf16*>(p.dout);
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  load_tile<D>(sK, kRows, [&](int r) { return t0 + r < p.T ? kb + (t0 + r) * p.k_st : nullptr; });
  load_tile<D>(sV, kRows, [&](int r) { return t0 + r < p.T ? vb + (t0 + r) * p.v_st : nullptr; });

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int key[2] = {t0 + 16 * warp + g, t0 + 16 * warp + g + 8};
  const float c2 = p.scale * kLog2e;

  for (int i0 = p.causal ? t0 * G : 0; i0 < n_rows; i0 += kStep) {
    __syncthreads();  // the last step is done with sQ, sD
    load_tile<D>(sQ, kStep, [&](int r) {
      return i0 + r < n_rows ? q + row_off(b, i0 + r, kvh, G, p.q_sb, p.q_ss, p.q_sh) : nullptr;
    });
    load_tile<D>(sD, kStep, [&](int r) {
      return i0 + r < n_rows ? dout + row_off(b, i0 + r, kvh, G, p.d_sb, p.d_ss, p.d_sh)
                             : nullptr;
    });
    for (int r = threadIdx.x; r < kStep; r += kThreads) {
      const bool ok = i0 + r < n_rows;
      sLse[r] = ok ? p.lse[lse_index(p, b, i0 + r, kvh, G)] * kLog2e : 0.f;
      sDelta[r] = ok ? p.delta[lse_index(p, b, i0 + r, kvh, G)] : 0.f;
    }
    __syncthreads();

    float st[kStep / 8][4], dpt[kStep / 8][4];
#pragma unroll
    for (int n = 0; n < kStep / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, a_addr(sK, P, 16 * warp, 16 * kk, lane));
      ldsm_x4(va, a_addr(sV, P, 16 * warp, 16 * kk, lane));
#pragma unroll
      for (int np = 0; np < kStep / 16; ++np) {
        uint32_t bq[4], bd[4];
        ldsm_x4(bq, bn_addr(sQ, P, 16 * np, 16 * kk, lane));
        ldsm_x4(bd, bn_addr(sD, P, 16 * np, 16 * kk, lane));
        mma(st[2 * np], ka, bq[0], bq[1]);
        mma(st[2 * np + 1], ka, bq[2], bq[3]);
        mma(dpt[2 * np], va, bd[0], bd[1]);
        mma(dpt[2 * np + 1], va, bd[2], bd[3]);
      }
    }
    // p and ds in place: element e of n-tile n is key key[e >> 1], row
    // 8 n + 2 tg + (e & 1) of the step.
#pragma unroll
    for (int n = 0; n < kStep / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * n + 2 * tg + (e & 1);
        const bool ok = visible(p, i0 + r, key[e >> 1], n_rows, G);
        const float pv = ok ? exp2f(fmaf(st[n][e], c2, -sLse[r])) : 0.f;
        st[n][e] = pv;
        dpt[n][e] = ok ? pv * (dpt[n][e] - sDelta[r]) * p.scale : 0.f;
      }
#pragma unroll
    for (int j = 0; j < kStep / 16; ++j) {
      uint32_t pa[4], da[4];
      to_a(pa, st[2 * j], st[2 * j + 1]);
      to_a(da, dpt[2 * j], dpt[2 * j + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bd[4], bq[4];
        ldsm_x4_t(bd, bk_addr(sD, P, 16 * j, 16 * dn, lane));
        ldsm_x4_t(bq, bk_addr(sQ, P, 16 * j, 16 * dn, lane));
        mma(dv[2 * dn], pa, bd[0], bd[1]);
        mma(dv[2 * dn + 1], pa, bd[2], bd[3]);
        mma(dk[2 * dn], da, bq[0], bq[1]);
        mma(dk[2 * dn + 1], da, bq[2], bq[3]);
      }
    }
  }
  // dk, dv rows key[0], key[1]; columns 8 n + 2 tg, + 1.
  bf16* gk = static_cast<bf16*>(p.dk);
  bf16* gv = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= p.T) continue;
    const int64_t off = ((static_cast<int64_t>(b) * p.T + key[h]) * p.KV + kvh) * D + 2 * tg;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(gk + off + 8 * n) = pack_bf16(dk[n][2 * h], dk[n][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(gv + off + 8 * n) = pack_bf16(dv[n][2 * h], dv[n][2 * h + 1]);
    }
  }
}

// (c) dq of 64 folded rows; warp w owns rows i0 + 16 w .. + 15. A step
// takes 64 keys: S = Q K^T and dP = dO V^T (16 x 64 a warp), then
// dQ += dS K with dS as the register A operand.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16(const Params p) {
  using C = Cfg<D>;
  constexpr int P = C::kP;
  constexpr int kKeys = 64;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sD = sQ + kRows * P;
  bf16* sK = sD + kRows * P;
  bf16* sV = sK + kKeys * P;

  const int G = p.H / p.KV;
  const int n_rows = p.S * G;
  const int i0 = blockIdx.x * kRows;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tg = lane % 4;
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* dout = static_cast<const bf16*>(p.dout);
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  load_tile<D>(sQ, kRows, [&](int r) {
    return i0 + r < n_rows ? q + row_off(b, i0 + r, kvh, G, p.q_sb, p.q_ss, p.q_sh) : nullptr;
  });
  load_tile<D>(sD, kRows, [&](int r) {
    return i0 + r < n_rows ? dout + row_off(b, i0 + r, kvh, G, p.d_sb, p.d_ss, p.d_sh)
                           : nullptr;
  });
  const int row[2] = {i0 + 16 * warp + g, i0 + 16 * warp + g + 8};
  float lse2[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row[h] < n_rows;
    lse2[h] = ok ? p.lse[lse_index(p, b, row[h], kvh, G)] * kLog2e : 0.f;
    delta[h] = ok ? p.delta[lse_index(p, b, row[h], kvh, G)] : 0.f;
  }
  const float c2 = p.scale * kLog2e;
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  int t_end = p.T;  // causal: keys up to the tile's last query
  if (p.causal) t_end = min(t_end, (min(i0 + kRows, n_rows) - 1) / G + 1);

  for (int t0 = 0; t0 < t_end; t0 += kKeys) {
    __syncthreads();  // the last step is done with sK, sV
    load_tile<D>(sK, kKeys, [&](int r) { return t0 + r < p.T ? kb + (t0 + r) * p.k_st : nullptr; });
    load_tile<D>(sV, kKeys, [&](int r) { return t0 + r < p.T ? vb + (t0 + r) * p.v_st : nullptr; });
    __syncthreads();

    float s[kKeys / 8][4], dp[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      ldsm_x4(qa, a_addr(sQ, P, 16 * warp, 16 * kk, lane));
      ldsm_x4(da, a_addr(sD, P, 16 * warp, 16 * kk, lane));
#pragma unroll
      for (int np = 0; np < kKeys / 16; ++np) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, bn_addr(sK, P, 16 * np, 16 * kk, lane));
        ldsm_x4(bv, bn_addr(sV, P, 16 * np, 16 * kk, lane));
        mma(s[2 * np], qa, bk[0], bk[1]);
        mma(s[2 * np + 1], qa, bk[2], bk[3]);
        mma(dp[2 * np], da, bv[0], bv[1]);
        mma(dp[2 * np + 1], da, bv[2], bv[3]);
      }
    }
    // ds in place of dp: element e of n-tile n is row row[e >> 1], key
    // t0 + 8 n + 2 tg + (e & 1).
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const bool ok = visible(p, row[h], t0 + 8 * n + 2 * tg + (e & 1), n_rows, G);
        const float pv = ok ? exp2f(fmaf(s[n][e], c2, -lse2[h])) : 0.f;
        dp[n][e] = ok ? pv * (dp[n][e] - delta[h]) * p.scale : 0.f;
      }
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j) {
      uint32_t a[4];
      to_a(a, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bk[4];
        ldsm_x4_t(bk, bk_addr(sK, P, 16 * j, 16 * dn, lane));
        mma(dq[2 * dn], a, bk[0], bk[1]);
        mma(dq[2 * dn + 1], a, bk[2], bk[3]);
      }
    }
  }
  bf16* gq = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= n_rows) continue;
    const int64_t off = row_off(b, row[h], kvh, G, static_cast<int64_t>(p.S) * p.H * D,
                                static_cast<int64_t>(p.H) * D, D) + 2 * tg;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(gq + off + 8 * n) = pack_bf16(dq[n][2 * h], dq[n][2 * h + 1]);
  }
}

}  // namespace tc

// f(std::integral_constant<int, D>{}) for the head sizes the kernels take.
template <typename F>
int with_d(int D, F f) {
  switch (D) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 112: return f(std::integral_constant<int, 112>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launch `kernel` (128 threads a block) with `smem` bytes of dynamic shared
// memory; `attr` is the result of raising its limit, made once per kernel by
// the caller (a function-local static of each instantiation).
template <typename K>
int launch(K kernel, int attr, dim3 grid, size_t smem, const Params& p, cudaStream_t st) {
  if (attr != 0) return attr;
  kernel<<<grid, 128, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int raise_smem(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

static_assert(f32::kThreads == 128 && tc::kThreads == 128, "launch() uses 128 threads");

Params make_params(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const int64_t* strides, int B, int S, int T,
                   int H, int KV, int D, int causal, float scale) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
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
  p.d_sb = strides[12];
  p.d_ss = strides[13];
  p.d_sh = strides[14];
  p.B = B;
  p.S = S;
  p.T = T;
  p.H = H;
  p.KV = KV;
  p.D = D;
  p.causal = causal;
  p.scale = scale;
  return p;
}

bool bad_shape(int B, int S, int T, int H, int KV, int D) {
  return B <= 0 || S <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || D % 16 != 0 || D > kMaxD;
}

}  // namespace

// Every entry: dtype 0 = float32, 1 = bfloat16; strides: 15 element strides,
// (b, s, h) of q, (b, t, kv) of k and of v, (b, s, h) of o and of do; the
// last dimension of every tensor is contiguous, and lse, delta, dq, dk, dv
// are contiguous. Each returns the cudaError_t of its launch.

// (a) delta[B, S, H] (float32) = sum_d do * o.
extern "C" int flash_bwd_delta(int dtype, const void* o, const void* dout, float* delta,
                               const int64_t* strides, int B, int S, int H, int D,
                               void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(nullptr, nullptr, nullptr, o, dout, strides, B, S, 1, H, H, D, 0, 0.f);
  p.delta_out = delta;
  const int rows = B * S * H;
  const dim3 grid((rows + 3) / 4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) flash_bwd_delta_kernel<__nv_bfloat16><<<grid, 128, 0, st>>>(p);
  else if (dtype == 0) flash_bwd_delta_kernel<float><<<grid, 128, 0, st>>>(p);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// (b) dk, dv [B, T, KV, D] in the inputs' type.
extern "C" int flash_bwd_dkdv(int dtype, const void* q, const void* k, const void* v,
                              const void* dout, const float* lse, const float* delta,
                              void* dk, void* dv, const int64_t* strides, int B, int S,
                              int T, int H, int KV, int D, int causal, float scale,
                              void* stream) {
  if (bad_shape(B, S, T, H, KV, D)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, nullptr, dout, strides, B, S, T, H, KV, D, causal, scale);
  p.lse = lse;
  p.delta = delta;
  p.dk = dk;
  p.dv = dv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_d(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (dtype == 1) {
      constexpr size_t bytes = tc::Cfg<kD>::kDkdvBytes;
      static const int attr = raise_smem(tc::flash_bwd_dkdv_bf16<kD>, bytes);
      return launch(tc::flash_bwd_dkdv_bf16<kD>, attr,
                    dim3((T + tc::kRows - 1) / tc::kRows, KV, B), bytes, p, st);
    }
    if (dtype == 0) {
      const size_t bytes = f32::Layout(kD).bytes;
      static const int attr = raise_smem(f32::flash_bwd_dkdv_f32<kD>, bytes);
      return launch(f32::flash_bwd_dkdv_f32<kD>, attr,
                    dim3((T + f32::kTile - 1) / f32::kTile, KV, B), bytes, p, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

// (c) dq [B, S, H, D] in the inputs' type.
extern "C" int flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, const float* lse, const float* delta,
                            void* dq, const int64_t* strides, int B, int S, int T, int H,
                            int KV, int D, int causal, float scale, void* stream) {
  if (bad_shape(B, S, T, H, KV, D)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, nullptr, dout, strides, B, S, T, H, KV, D, causal, scale);
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_rows = S * (H / KV);
  return with_d(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (dtype == 1) {
      constexpr size_t bytes = tc::Cfg<kD>::kDqBytes;
      static const int attr = raise_smem(tc::flash_bwd_dq_bf16<kD>, bytes);
      return launch(tc::flash_bwd_dq_bf16<kD>, attr,
                    dim3((n_rows + tc::kRows - 1) / tc::kRows, KV, B), bytes, p, st);
    }
    if (dtype == 0) {
      const size_t bytes = f32::Layout(kD).bytes;
      static const int attr = raise_smem(f32::flash_bwd_dq_f32<kD>, bytes);
      return launch(f32::flash_bwd_dq_f32<kD>, attr,
                    dim3((n_rows + f32::kTile - 1) / f32::kTile, KV, B), bytes, p, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  });
}
