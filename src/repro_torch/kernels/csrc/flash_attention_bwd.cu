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
//   (b) flash_bwd_dkdv: per (batch, kv head, key tile), it walks the folded
//       query rows that can see the tile (causal: s >= the tile's first key)
//       and writes dk and dv once.
//   (c) flash_bwd_dq: per (batch, kv head, folded row tile), it walks the
//       key tiles up to the tile's last query and writes dq once.
// A tile is a block of its own in the float32 bodies and a unit of a
// persistent block in the bfloat16 ones. Any S and T: rows past S * G and
// keys past T add nothing (masked by index, or zero-filled and not written).
//
// What bounds it. (b) and (c) recompute s and dp, so the pass runs 7
// products of the forward's size where the forward runs 2; the bound
// counts the backward's operations as 2.5x the forward's (5 products) and
// the bytes of q, k, v, o, do, lse read once and dq, dk, dv written once.
// At llama3.2-3b's training shape (B 4, S = T 1,024, H 24, KV 8, D 128,
// causal) that is operations: the products have to run on the tensor cores
// at their full rate while the tiles stream in behind them.
//
// bfloat16 bodies, laid out as the forward (flash_attention.cu):
//   * Block: two consumer warpgroups and one producer warp, in a warpgroup
//     of its own whose other warps only give up their registers (setmaxnreg:
//     56 a producer thread, 224 a consumer thread). Persistent blocks, one
//     an SM, take units numbered longest first, walking that order forward
//     and back in turns (sm90::unit_index), so no long unit forms the tail.
//   * Row tiles. A tile is kRows = 64 folded rows: pos positions x gb heads
//     of one kv head (gb = G for every G <= 64, pos = 64 / gb). Over
//     [B, S, H, D] a rank-4 TMA box (w, gb, pos, 1) at (0, kv * G, s0, b)
//     lands exactly those folded rows, in order, for any G; a tile fills
//     gb * pos rows (63 for G = 3) and positions >= S are zero-filled.
//   * (b) dk, dv: a unit is 128 keys of one (batch row, kv head), 64 a
//     consumer; its K and V are loaded once by TMA. Row tiles of Q and dO
//     stream through a ring of three stages by TMA, their rows' lse and delta
//     beside them (cp.async by the producer warp, arriving on the same full
//     barrier); each stage has a full and an empty mbarrier. A step:
//     S^T = K Q^T and dP^T = V dO^T as wgmma m64n64k16 with both operands in
//     shared memory; p and ds in registers in log2 units; dV += P^T dO and
//     dK += dS^T Q as wgmma with P^T and dS^T the register A operand and dO,
//     Q the shared B operand read through the transpose flag. dK and dV (64
//     x D each a consumer) stay in registers over the whole walk and are
//     written once, staged through shared memory for 16-byte stores. A
//     consumer skips the steps whose rows all come before its keys, and masks
//     only steps that cross the diagonal. Rows past a tile's fill are zeroed
//     once; keys >= T are zero-filled and never written.
//   * (c) dq: a unit is one row tile a consumer (2 pos positions); its Q and
//     dO are loaded once by TMA, and K and V tiles of 64 keys stream through
//     a ring as in the forward (three or four stages by D; a full and an
//     empty barrier for each of K and V, V handed back as soon as dP is
//     computed). S = Q K^T and dP = dO V^T
//     (both operands in shared memory), ds in registers, dQ += dS K with dS
//     the register A operand and K read transposed; dq is written once.
//     Masks only on tiles that cross T or the diagonal.
// No atomics, and each block sums its rows and keys in one fixed order, so
// every result is the same from run to run. A wait on a barrier that never
// completes traps after about two seconds instead of hanging the card. The
// float32 bodies (the tests' type, held at 2e-5, which TF32 would miss) run
// float32 FMAs on the CUDA cores.

#include "sm90.cuh"

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
  int gb, pos;  // bf16 bodies: a row tile's heads and positions (tc::set_row_tile)
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
// bfloat16 bodies: wgmma, TMA rings, persistent blocks
// ---------------------------------------------------------------------------

namespace tc {

using namespace sm90;
using bf16 = __nv_bfloat16;

// Two consumer warpgroups a block and a producer warpgroup of which one warp
// issues the loads: ptxas sizes a kernel that uses setmaxnreg in whole
// warpgroups, and the three idle warps hand their registers over.
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * kConsumers + 128;
// setmaxnreg targets: a block of 384 threads gets 168 registers a thread at
// launch; 56 go to the producer warpgroup (the dkdv producer spilled at 24,
// 32 and 40) and 224 to the consumers, which hold dK and dV.
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
static_assert(65536 / kThreads / 8 * 8 * kThreads >=
                  128 * kProducerRegs + 128 * kConsumers * kConsumerRegs,
              "setmaxnreg targets exceed the registers of one block an SM");
constexpr int kRows = 64;                   // folded rows of a row tile (2 a producer lane)
constexpr int kUnitKeys = 64 * kConsumers;  // (b): keys of a unit, 64 a consumer
constexpr int kTileKeys = 64;               // (c): keys of a streamed tile
constexpr uint32_t kSmemMax = 232448;       // dynamic shared memory of a block

// Shared memory of (b): the unit's K and V tiles, a ring of row tiles (Q,
// dO and their rows' lse and delta), and a staging buffer a consumer for
// the output. Tiles are Swizzle<D> boxes; a row tile's box holds kRows rows.
template <int D>
struct DkdvLayout : Swizzle<D> {
  static constexpr int kW = Swizzle<D>::kW;
  static constexpr uint32_t kRowBox = kRows * 2 * kW;
  static constexpr uint32_t kRowTile = kRows * D * 2;
  static constexpr uint32_t kUnitBox = kUnitKeys * 2 * kW;
  static constexpr uint32_t kUnitTile = kUnitKeys * D * 2;
  static constexpr uint32_t kOBytes = align_up(64 * (D + 8) * 2, 1024);
  static constexpr uint32_t bytes(int st) {
    return 2 * kUnitTile + st * (2 * kRowTile + 8 * kRows) + kConsumers * kOBytes +
           (2 * st + 2) * 8 + 1024;
  }
  static constexpr int kStages = bytes(3) <= kSmemMax ? 3 : 2;
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kUnitTile;
  static constexpr uint32_t kQ = 2 * kUnitTile;
  static constexpr uint32_t kDO = kQ + kStages * kRowTile;
  static constexpr uint32_t kO = kDO + kStages * kRowTile;
  static constexpr uint32_t kLse = kO + kConsumers * kOBytes;  // float [kStages][kRows]
  static constexpr uint32_t kDelta = kLse + kStages * kRows * 4;
  static constexpr uint32_t kBar = kDelta + kStages * kRows * 4;
  static constexpr uint32_t kBytes = bytes(kStages);
  static_assert(kBytes <= kSmemMax, "dkdv tiles exceed shared memory");
};

// Shared memory of (c): each consumer's Q and dO row tiles, a ring of K and
// V tiles of kTileKeys keys, and a staging buffer a consumer.
template <int D>
struct DqLayout : Swizzle<D> {
  static constexpr int kW = Swizzle<D>::kW;
  static constexpr uint32_t kRowBox = kRows * 2 * kW;
  static constexpr uint32_t kRowTile = kRows * D * 2;
  static constexpr uint32_t kKeyBox = kTileKeys * 2 * kW;
  static constexpr uint32_t kKeyTile = kTileKeys * D * 2;
  static constexpr uint32_t kOBytes = align_up(64 * (D + 8) * 2, 1024);
  static constexpr uint32_t bytes(int st) {
    return 2 * kConsumers * kRowTile + 2 * st * kKeyTile + kConsumers * kOBytes +
           (4 * st + 2) * 8 + 1024;
  }
  static constexpr int kStages = bytes(4) <= kSmemMax ? 4 : (bytes(3) <= kSmemMax ? 3 : 2);
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDO = kConsumers * kRowTile;
  static constexpr uint32_t kK = 2 * kConsumers * kRowTile;
  static constexpr uint32_t kV = kK + kStages * kKeyTile;
  static constexpr uint32_t kO = kV + kStages * kKeyTile;
  static constexpr uint32_t kBar = kO + kConsumers * kOBytes;
  static constexpr uint32_t kBytes = bytes(kStages);
  static_assert(kBytes <= kSmemMax, "dq tiles exceed shared memory");
};

// 4-byte asynchronous copy to shared memory; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed;
// the arrival is one of those the barrier was initialised to expect.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// Write a warpgroup's 64 x D float32 accumulator (the m64 nD fragment
// layout: acc[4 n + e] is row 16 (warp % 4) + lane / 4 + 8 (e >> 1),
// column 8 n + 2 (lane % 4) + (e & 1)) as bfloat16 rows: staged row-major
// in `stage`, then 16-byte stores to dst(r) for each row r it gives.
template <int D, typename F>
__device__ __forceinline__ void store_tile(const float (&acc)[D / 2], unsigned char* stage,
                                           int wg, F dst) {
  constexpr uint32_t kPitch = (D + 8) * 2;  // 8 rows of a quad fall in 8 bank groups
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  named_sync(1 + wg, 128);  // the last unit's stores have read the stage
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    *reinterpret_cast<uint32_t*>(stage + r * kPitch + col * 2) =
        pack_bf16(acc[i], acc[i + 1]);
  }
  named_sync(1 + wg, 128);
  for (int idx = threadIdx.x % 128; idx < 64 * D / 8; idx += 128) {
    const int r = idx / (D / 8);
    const int col = (idx % (D / 8)) * 8;
    bf16* out = dst(r);
    if (out != nullptr)
      *reinterpret_cast<uint4*>(out + col) =
          *reinterpret_cast<const uint4*>(stage + r * kPitch + col * 2);
  }
}

// A unit of (b): kUnitKeys keys from t0 of kv head kvh in batch row b. Its
// steps are the row tiles that can see those keys: positions s0 from
// s_start (t0 when causal, else 0) to S - 1 in blocks of p.pos, and for
// each the head blocks gi < G / p.gb in turn. Units are numbered longest
// first: with causal masking the first keys see the most rows.
struct KeyUnit {
  int t0, kvh, b, s_start;
};

__device__ __forceinline__ KeyUnit key_unit(int w, const Params& p) {
  const int per = p.KV * p.B;
  KeyUnit u;
  u.t0 = w / per * kUnitKeys;
  u.kvh = w % per % p.KV;
  u.b = w % per / p.KV;
  u.s_start = p.causal ? u.t0 : 0;
  return u;
}

// (b) dk, dv: persistent blocks; consumer wg owns keys t0 + 64 wg .. + 63 of
// each unit and keeps their dK and dV in registers across the steps.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = DkdvLayout<D>;
  constexpr int kSt = L::kStages;
  constexpr int kW = L::kW;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms need 1024 B
  unsigned char* smem = smem_raw + (base - raw);
  float* s_lse = reinterpret_cast<float*>(smem + L::kLse);
  float* s_delta = reinterpret_cast<float*>(smem + L::kDelta);
  // Ring barriers: full (the TMA bytes and the producer warp's lse / delta
  // copies landed) and empty (every consumer warp is done with the stage);
  // the unit's K and V have a pair of their own.
  const uint32_t bar = base + L::kBar;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (kSt + s); };
  const uint32_t kv_full = bar + 16 * kSt;
  const uint32_t kv_empty = kv_full + 8;

  const int G = p.H / p.KV;
  const int n_gb = G / p.gb;
  const int rows = p.gb * p.pos;  // folded rows a step loads; the rest stay zero
  const int n_units = (p.T + kUnitKeys - 1) / kUnitKeys * p.KV * p.B;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSt; ++s) {
      mbar_init(full(s), 1 + 32);  // lane 0's expect_tx and 32 cp.async arrivals
      mbar_init(empty(s), 4 * kConsumers);
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 4 * kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Rows rows..kRows-1 of every stage are never loaded: zero them (q, do,
  // lse, delta) once, so that they add nothing to dk and dv.
  if (rows < kRows) {
    const int tail = (kRows - rows) * 2 * kW / 16;  // 16-byte chunks a box
    const int n = 2 * kSt * L::kBoxes * tail;
    for (int x = threadIdx.x; x < n; x += kThreads) {
      const int box = x / tail;  // (tensor, stage, box) in order, as laid out
      *reinterpret_cast<uint4*>(smem + L::kQ + box * L::kRowBox + rows * 2 * kW +
                                (x % tail) * 16) = make_uint4(0, 0, 0, 0);
    }
    for (int x = threadIdx.x; x < kSt * kRows; x += kThreads)
      if (x % kRows >= rows) s_lse[x] = s_delta[x] = 0.f;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= 4 * kConsumers) {
    // ---- producer warp: the unit's K and V, then its steps through the ring -
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 4 * kConsumers) {
      // The lane's rows of a step, r = lane + 32 k: position and head
      // offsets within the tile (no division inside the loops).
      int r_pos[2], r_head[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        r_pos[k] = (lane + 32 * k) / p.gb;
        r_head[k] = (lane + 32 * k) % p.gb;
      }
      int g = 0;  // the block's step count so far: ring stage and phase
      for (int i = 0, w; (w = unit_index(i, n_units)) >= 0; ++i) {
        const KeyUnit u = key_unit(w, p);
        if (lane == 0) {
          mbar_wait(kv_empty, (i & 1) ^ 1);
          mbar_expect_tx(kv_full, 2 * L::kUnitTile);
#pragma unroll
          for (int x = 0; x < L::kBoxes; ++x) {
            tma_load(base + L::kK + x * L::kUnitBox, &tm_k, kv_full, x * kW, u.kvh, u.t0, u.b);
            tma_load(base + L::kV + x * L::kUnitBox, &tm_v, kv_full, x * kW, u.kvh, u.t0, u.b);
          }
        }
        for (int s0 = u.s_start; s0 < p.S; s0 += p.pos)  // the unit's steps
        for (int gi = 0; gi < n_gb; ++gi, ++g) {
          const int st = g % kSt;
          const int h0 = u.kvh * G + gi * p.gb;
          mbar_wait(empty(st), ((g / kSt) & 1) ^ 1);
          if (lane == 0) {
            // A box (w, gb, pos) at (x w, h0, s0, b) lands the step's folded
            // rows in order; positions >= S are zero-filled.
            mbar_expect_tx(full(st), 2 * rows * D * 2);
#pragma unroll
            for (int x = 0; x < L::kBoxes; ++x) {
              const uint32_t off = st * L::kRowTile + x * L::kRowBox;
              tma_load(base + L::kQ + off, &tm_q, full(st), x * kW, h0, s0, u.b);
              tma_load(base + L::kDO + off, &tm_do, full(st), x * kW, h0, s0, u.b);
            }
          }
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int r = lane + 32 * k;
            const int s = s0 + r_pos[k];
            const bool ok = r < rows && s < p.S;
            const int64_t at = ok ? (static_cast<int64_t>(u.b) * p.S + s) * p.H + h0 + r_head[k] : 0;
            if (r < rows) {
              const uint32_t dst = (st * kRows + r) * 4;
              cp_async4(base + L::kLse + dst, p.lse + at, ok ? 4 : 0);
              cp_async4(base + L::kDelta + dst, p.delta + at, ok ? 4 : 0);
            }
          }
          cp_async_arrive(full(st));
        }
      }
    }
  } else {
    // ---- consumer warpgroup: 64 keys of every unit ------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp / 4;
    const int c = lane % 4;
    const float c2 = p.scale * kLog2e;  // scores in log2 units
    unsigned char* stage = smem + L::kO + wg * L::kOBytes;
    const uint32_t sk = base + L::kK + wg * 64 * 2 * kW;  // this warpgroup's keys
    const uint32_t sv = base + L::kV + wg * 64 * 2 * kW;
    bf16* gk = static_cast<bf16*>(p.dk);
    bf16* gv = static_cast<bf16*>(p.dv);

    int g = 0;
    for (int i = 0, w; (w = unit_index(i, n_units)) >= 0; ++i) {
      const KeyUnit u = key_unit(w, p);
      const int tw = u.t0 + 64 * wg;  // this warpgroup's first key
      int key[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) key[h] = tw + 16 * (warp % 4) + lane / 4 + 8 * h;
      float dk[D / 2], dv[D / 2];
#pragma unroll
      for (int x = 0; x < D / 2; ++x) dk[x] = dv[x] = 0.f;
      mbar_wait(kv_full, i & 1);

      // Per step: S^T = K Q^T and dP^T = V dO^T, then p and ds in registers,
      // then dV += P^T dO and dK += dS^T Q with P^T and dS^T as the register
      // A operand. The two warpgroups interleave on the tensor cores.
      for (int s0 = u.s_start; s0 < p.S; s0 += p.pos)  // as the producer walks them
      for (int gi = 0; gi < n_gb; ++gi, ++g) {
        const int st = g % kSt;
        mbar_wait(full(st), (g / kSt) & 1);
        if (p.causal && s0 + p.pos - 1 < tw) {  // no row of the step sees these keys
          __syncwarp();
          if (lane == 0) mbar_arrive(empty(st));
          continue;
        }
        const uint32_t sq = base + L::kQ + st * L::kRowTile;
        const uint32_t sdo = base + L::kDO + st * L::kRowTile;
        float sc[kRows / 2], dp[kRows / 2];
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < D / 16; ++kb) {
          // Box kb * 16 / kW, then 32 bytes per k-step inside its rows.
          const int box = kb * 16 / kW;
          const uint32_t off = (kb * 16 % kW) * 2;
          wgmma_ss(sc, make_desc(sk + box * L::kUnitBox + off, 1, kW, L::kLayout),
                   make_desc(sq + box * L::kRowBox + off, 1, kW, L::kLayout), kb > 0);
        }
#pragma unroll
        for (int kb = 0; kb < D / 16; ++kb) {
          const int box = kb * 16 / kW;
          const uint32_t off = (kb * 16 % kW) * 2;
          wgmma_ss(dp, make_desc(sv + box * L::kUnitBox + off, 1, kW, L::kLayout),
                   make_desc(sdo + box * L::kRowBox + off, 1, kW, L::kLayout), kb > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        // p and ds in place: element 4 n + e is key key[e >> 1] and row
        // 8 n + 2 c + (e & 1) of the step, position s0 + row / gb. On a step
        // that crosses the diagonal, rows below thr[h] come before key[h].
        const float* lse = s_lse + st * kRows;
        const float* dl = s_delta + st * kRows;
        int thr[2] = {0, 0};
        if (p.causal && s0 < tw + 63) {
#pragma unroll
          for (int h = 0; h < 2; ++h) thr[h] = max(0, key[h] - s0) * p.gb;
        }
#pragma unroll
        for (int n = 0; n < kRows / 8; ++n) {
          const float2 l2 = *reinterpret_cast<const float2*>(lse + 8 * n + 2 * c);
          const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * n + 2 * c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 8 * n + 2 * c + (e & 1);
            const float lr = (e & 1) ? l2.y : l2.x;
            const float dr = (e & 1) ? d2.y : d2.x;
            float pv = ex2(fmaf(sc[4 * n + e], c2, -lr * kLog2e));
            if (r < thr[e >> 1]) pv = 0.f;
            sc[4 * n + e] = pv;
            dp[4 * n + e] = pv * (dp[4 * n + e] - dr) * p.scale;
          }
        }
        uint32_t pa[kRows / 16][4], da[kRows / 16][4];
        pack_a<kRows>(sc, pa);  // p rounded to v's type for dV
        pack_a<kRows>(dp, da);  // ds rounded to q's type for dK
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk)
          wgmma_rs(dv, pa[kk],
                   make_desc(sdo + kk * 16 * 2 * kW, L::kRowBox / 16, kW, L::kLayout));
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk)
          wgmma_rs(dk, da[kk],
                   make_desc(sq + kk * 16 * 2 * kW, L::kRowBox / 16, kW, L::kLayout));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty);  // the producer may load the next unit's K, V

      auto row = [&](bf16* g0) {
        return [&, g0](int r) -> bf16* {
          const int t = tw + r;
          return t < p.T ? g0 + ((static_cast<int64_t>(u.b) * p.T + t) * p.KV + u.kvh) * D
                         : nullptr;
        };
      };
      store_tile<D>(dk, stage, wg, row(gk));
      store_tile<D>(dv, stage, wg, row(gv));
    }
  }
}

// A unit of (c): positions s0 .. s0 + kConsumers pos - 1 (pos a consumer) x
// gb heads from h0 of kv head kvh in batch row b, and the key tiles up to
// its last position (causal) or T. Units are numbered longest first: with
// causal masking the last positions see the most keys.
struct RowUnit {
  int s0, h0, kvh, b, n_tiles;
};

__device__ __forceinline__ RowUnit row_unit(int w, const Params& p, int n_gb,
                                            int n_row_tiles) {
  const int per = n_gb * p.KV * p.B;
  const int x = w % per;
  RowUnit u;
  u.s0 = (n_row_tiles - 1 - w / per) * kConsumers * p.pos;
  u.kvh = x / n_gb % p.KV;
  u.b = x / n_gb / p.KV;
  u.h0 = u.kvh * (p.H / p.KV) + x % n_gb * p.gb;
  int t_end = p.T;
  if (p.causal) t_end = min(t_end, min(u.s0 + kConsumers * p.pos, p.S));
  u.n_tiles = (t_end + kTileKeys - 1) / kTileKeys;
  return u;
}

// (c) dq: persistent blocks; consumer wg owns the rows of positions s0 +
// pos wg .. + pos - 1 of each unit and keeps their dQ in registers across
// the key tiles.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = DqLayout<D>;
  constexpr int kSt = L::kStages;
  constexpr int kW = L::kW;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  // K/V ring barriers as in the forward, and a full / empty pair for the
  // unit's Q and dO.
  const uint32_t bar = base + L::kBar;
  auto full_k = [&](int s) { return bar + 8 * s; };
  auto full_v = [&](int s) { return bar + 8 * (kSt + s); };
  auto empty_k = [&](int s) { return bar + 8 * (2 * kSt + s); };
  auto empty_v = [&](int s) { return bar + 8 * (3 * kSt + s); };
  const uint32_t q_full = bar + 32 * kSt;
  const uint32_t q_empty = q_full + 8;

  const int G = p.H / p.KV;
  const int n_gb = G / p.gb;
  const int rows = p.gb * p.pos;
  const int n_row_tiles = (p.S + kConsumers * p.pos - 1) / (kConsumers * p.pos);
  const int n_units = n_row_tiles * n_gb * p.KV * p.B;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSt; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 4 * kConsumers);
      mbar_init(empty_v(s), 4 * kConsumers);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= 4 * kConsumers) {
    // ---- producer: one thread loads each unit's Q, dO and its K/V tiles ---
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      int g = 0;
      for (int i = 0, w; (w = unit_index(i, n_units)) >= 0; ++i) {
        const RowUnit u = row_unit(w, p, n_gb, n_row_tiles);
        const int n_wg = min(kConsumers, (p.S - u.s0 + p.pos - 1) / p.pos);  // with rows
        mbar_wait(q_empty, (i & 1) ^ 1);
        mbar_expect_tx(q_full, n_wg * 2 * rows * D * 2);
        for (int x = 0; x < n_wg * L::kBoxes; ++x) {
          const int c = x / L::kBoxes;
          const uint32_t off = c * L::kRowTile + x % L::kBoxes * L::kRowBox;
          const int s = u.s0 + c * p.pos;
          tma_load(base + L::kQ + off, &tm_q, q_full, x % L::kBoxes * kW, u.h0, s, u.b);
          tma_load(base + L::kDO + off, &tm_do, q_full, x % L::kBoxes * kW, u.h0, s, u.b);
        }
        for (int j = 0; j < u.n_tiles; ++j, ++g) {
          const int s = g % kSt;
          const uint32_t free_parity = ((g / kSt) & 1) ^ 1;
          mbar_wait(empty_k(s), free_parity);
          mbar_expect_tx(full_k(s), L::kKeyTile);
#pragma unroll
          for (int x = 0; x < L::kBoxes; ++x)
            tma_load(base + L::kK + s * L::kKeyTile + x * L::kKeyBox, &tm_k, full_k(s),
                     x * kW, u.kvh, j * kTileKeys, u.b);
          mbar_wait(empty_v(s), free_parity);
          mbar_expect_tx(full_v(s), L::kKeyTile);
#pragma unroll
          for (int x = 0; x < L::kBoxes; ++x)
            tma_load(base + L::kV + s * L::kKeyTile + x * L::kKeyBox, &tm_v, full_v(s),
                     x * kW, u.kvh, j * kTileKeys, u.b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup: 64 folded rows of every unit ------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp / 4;
    const int c = lane % 4;
    const float c2 = p.scale * kLog2e;
    unsigned char* stage = smem + L::kO + wg * L::kOBytes;
    const uint32_t sq = base + L::kQ + wg * L::kRowTile;
    const uint32_t sdo = base + L::kDO + wg * L::kRowTile;
    bf16* gq = static_cast<bf16*>(p.dq);

    int g = 0;
    for (int i = 0, w; (w = unit_index(i, n_units)) >= 0; ++i) {
      const RowUnit u = row_unit(w, p, n_gb, n_row_tiles);
      const int sp = u.s0 + wg * p.pos;  // this warpgroup's first position
      // The thread's accumulator rows r = 16 (warp % 4) + lane / 4 + 8 h:
      // position, lse (log2 units) and delta; rows past the data are 0.
      int pos[2];
      float lse2[2], dlt[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * (warp % 4) + lane / 4 + 8 * h;
        pos[h] = sp + r / p.gb;
        const bool ok = r < rows && pos[h] < p.S;
        const int64_t at = (static_cast<int64_t>(u.b) * p.S + pos[h]) * p.H + u.h0 + r % p.gb;
        lse2[h] = ok ? p.lse[at] * kLog2e : 0.f;
        dlt[h] = ok ? p.delta[at] : 0.f;
      }
      int n_mine = 0;  // key tiles this warpgroup needs (0 if it has no rows)
      if (sp < p.S) {
        int te = p.T;
        if (p.causal) te = min(te, min(sp + p.pos, p.S));
        n_mine = (te + kTileKeys - 1) / kTileKeys;
      }
      float dq[D / 2];
#pragma unroll
      for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;
      mbar_wait(q_full, i & 1);

      // Per key tile: S = Q K^T and dP = dO V^T, release V, ds in registers,
      // dQ += dS K with dS as the register A operand, release K.
      for (int j = 0; j < u.n_tiles; ++j, ++g) {
        const int st = g % kSt;
        const uint32_t ph = (g / kSt) & 1;
        if (j < n_mine) {
          const uint32_t sk = base + L::kK + st * L::kKeyTile;
          const uint32_t sv = base + L::kV + st * L::kKeyTile;
          float sc[kTileKeys / 2], dp[kTileKeys / 2];
          mbar_wait(full_k(st), ph);
          wgmma_fence();
#pragma unroll
          for (int kb = 0; kb < D / 16; ++kb) {
            const int box = kb * 16 / kW;
            const uint32_t off = (kb * 16 % kW) * 2;
            wgmma_ss(sc, make_desc(sq + box * L::kRowBox + off, 1, kW, L::kLayout),
                     make_desc(sk + box * L::kKeyBox + off, 1, kW, L::kLayout), kb > 0);
          }
          wgmma_commit();
          mbar_wait(full_v(st), ph);
          wgmma_fence();
#pragma unroll
          for (int kb = 0; kb < D / 16; ++kb) {
            const int box = kb * 16 / kW;
            const uint32_t off = (kb * 16 % kW) * 2;
            wgmma_ss(dp, make_desc(sdo + box * L::kRowBox + off, 1, kW, L::kLayout),
                     make_desc(sv + box * L::kKeyBox + off, 1, kW, L::kLayout), kb > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
          fence_regs(dp);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty_v(st));

          // ds in place of dp: element 4 n + e is row h = e >> 1, key t0 +
          // 8 n + 2 c + (e & 1). Masks only on tiles that cross T or the
          // diagonal (TMA zero-fills keys >= T; they are masked as well).
          const int t0 = j * kTileKeys;
          const bool edge = t0 + kTileKeys > p.T || (p.causal && t0 + kTileKeys - 1 > sp);
#pragma unroll
          for (int x = 0; x < kTileKeys / 2; ++x) {
            const int h = (x >> 1) & 1;
            float pv = ex2(fmaf(sc[x], c2, -lse2[h]));
            if (edge) {
              const int t = t0 + 8 * (x / 4) + 2 * c + (x & 1);
              if (t >= p.T || (p.causal && t > pos[h])) pv = 0.f;
            }
            dp[x] = pv * (dp[x] - dlt[h]) * p.scale;
          }
          uint32_t da[kTileKeys / 16][4];
          pack_a<kTileKeys>(dp, da);  // ds rounded to q's type
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kTileKeys / 16; ++kk)
            wgmma_rs(dq, da[kk],
                     make_desc(sk + kk * 16 * 2 * kW, L::kKeyBox / 16, kW, L::kLayout));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dq);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty_k(st));
        } else {
          // Wholly masked for these rows: only keep the ring's phases.
          mbar_wait(full_k(st), ph);
          mbar_wait(full_v(st), ph);
          __syncwarp();
          if (lane == 0) {
            mbar_arrive(empty_k(st));
            mbar_arrive(empty_v(st));
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty);  // the producer may load the next Q, dO

      store_tile<D>(dq, stage, wg, [&](int r) -> bf16* {
        const int s = sp + r / p.gb;
        return r < rows && s < p.S
                   ? gq + ((static_cast<int64_t>(u.b) * p.S + s) * p.H + u.h0 + r % p.gb) * D
                   : nullptr;
      });
    }
  }
}

// A row tile is pos positions x gb heads of one kv head: a TMA box (w, gb,
// pos) over [B, S, H, D] lands its folded rows in order. gb = G where G <=
// kRows (every config), else the largest divisor of G that is; pos =
// kRows / gb, so a tile fills gb * pos of its kRows rows (63 for G = 3).
void set_row_tile(Params& p) {
  const int G = p.H / p.KV;
  int gb = G <= kRows ? G : kRows;
  while (G % gb != 0) --gb;
  p.gb = gb;
  p.pos = kRows / gb;
}

// Once per instantiation: raise the shared-memory limit, and refuse to
// launch if setmaxnreg's targets exceed the registers the block is given
// (the consumers' setmaxnreg.inc would wait for them forever).
template <typename K>
int prepare(K kernel, uint32_t bytes) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (attr.numRegs * kThreads < 128 * kConsumers * kConsumerRegs + 128 * kProducerRegs)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  return 0;
}

// Launch (b) or (c) on persistent blocks, one an SM: maps over q and do
// ([B, S, H, D], box (w, gb, pos)) and over k and v ([B, T, KV, D], box (w,
// 1, keys)) with the tensors' own strides.
template <int D, typename K>
int launch_tc(K kernel, int ready, uint32_t bytes, int keys, int n_units, const Params& p,
              cudaStream_t stream) {
  using Z = Swizzle<D>;
  if (ready != 0) return ready;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  if (!encode_4d(&tm_q, p.q, D, p.H, p.S, p.B, p.q_sh, p.q_ss, p.q_sb, Z::kW, p.gb, p.pos,
                 Z::kMode) ||
      !encode_4d(&tm_do, p.dout, D, p.H, p.S, p.B, p.d_sh, p.d_ss, p.d_sb, Z::kW, p.gb,
                 p.pos, Z::kMode) ||
      !encode_4d(&tm_k, p.k, D, p.KV, p.T, p.B, p.k_sh, p.k_st, p.k_sb, Z::kW, 1, keys,
                 Z::kMode) ||
      !encode_4d(&tm_v, p.v, D, p.KV, p.T, p.B, p.v_sh, p.v_st, p.v_sb, Z::kW, 1, keys,
                 Z::kMode))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = n_units < sm_count() ? n_units : sm_count();
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  kernel<<<blocks, kThreads, bytes, stream>>>(tm_q, tm_do, tm_k, tm_v, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkdv(const Params& p, cudaStream_t stream) {
  using L = DkdvLayout<D>;
  static const int ready = prepare(flash_bwd_dkdv_bf16<D>, L::kBytes);
  const int n_units = (p.T + kUnitKeys - 1) / kUnitKeys * p.KV * p.B;
  return launch_tc<D>(flash_bwd_dkdv_bf16<D>, ready, L::kBytes, kUnitKeys, n_units, p,
                      stream);
}

template <int D>
int launch_dq(const Params& p, cudaStream_t stream) {
  using L = DqLayout<D>;
  static const int ready = prepare(flash_bwd_dq_bf16<D>, L::kBytes);
  const int n_gb = p.H / p.KV / p.gb;
  const int n_units =
      (p.S + kConsumers * p.pos - 1) / (kConsumers * p.pos) * n_gb * p.KV * p.B;
  return launch_tc<D>(flash_bwd_dq_bf16<D>, ready, L::kBytes, kTileKeys, n_units, p, stream);
}

}  // namespace tc

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

static_assert(f32::kThreads == 128, "launch() uses 128 threads");

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
  tc::set_row_tile(p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return sm90::with_d(D, static_cast<int>(cudaErrorInvalidValue), [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (dtype == 1) return tc::launch_dkdv<kD>(p, st);
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
  tc::set_row_tile(p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_rows = S * (H / KV);
  return sm90::with_d(D, static_cast<int>(cudaErrorInvalidValue), [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (dtype == 1) return tc::launch_dq<kD>(p, st);
    if (dtype == 0) {
      const size_t bytes = f32::Layout(kD).bytes;
      static const int attr = raise_smem(f32::flash_bwd_dq_f32<kD>, bytes);
      return launch(f32::flash_bwd_dq_f32<kD>, attr,
                    dim3((n_rows + f32::kTile - 1) / f32::kTile, KV, B), bytes, p, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

// Dynamic shared memory of one block of kernel (1 = dkdv, 2 = dq) for dtype
// (0 = float32, 1 = bfloat16) and head size D, in bytes; -1 for a kernel or
// D the library does not have.
extern "C" int flash_bwd_smem_bytes(int kernel, int dtype, int D) {
  if (D <= 0 || D % 16 != 0 || D > kMaxD || (kernel != 1 && kernel != 2)) return -1;
  if (dtype == 0) return static_cast<int>(f32::Layout(D).bytes);
  return sm90::with_d(D, -1, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return static_cast<int>(kernel == 1 ? tc::DkdvLayout<kD>::kBytes
                                        : tc::DqLayout<kD>::kBytes);
  });
}
