// GQA flash attention, forward pass, for Hopper (sm_90a). Plain C interface,
// loaded with ctypes by repro_torch/kernels/attention.py.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py
// (flash_attention_fwd, body _kernel). It computes what that kernel
// computes: for every query s and head h = kv * G + g,
//     out[b, s, h] = softmax_t(q[b, s, h] . k[b, t, kv] / sqrt(D)) @ v[b, :, kv]
// with the score of key t > s set to -1e30 when causal, an online softmax
// with float32 m, l and accumulator, p rounded to v's type before the P.V
// product while l sums the unrounded p (as the Pallas body does), and
// out = acc / max(l, 1e-30) cast to q's type. bfloat16 and float32 inputs;
// D a multiple of 16, at most 128.
//
// For the training step the kernel can also write each folded row's
// log-sum-exp, lse[b, s, h] = m + log(max(l, 1e-30)) in float32 with the
// score scale applied (natural log, as models/flash.py:85-87 of the JAX
// package), which the backward kernels (flash_attention_bwd.cu) read. The
// pointer is null on the serving path, which then writes nothing more.
//
// Rows are folded as i = s * G + g within one kv head, so the G heads that
// share a kv head share its K and V tiles (flash_attention.py folds them the
// same way) and no G has to divide a tile. Keys t >= T and rows i >= S * G
// are masked in the kernel: any S and T work. q, k, v and out are read and
// written in place through their [B, S, H, D] / [B, T, KV, D] strides: no
// transposed or head-repeated copy is made. With causal masking the key loop
// stops at the tile that holds the block's last query.
//
// What bounds it. At the serving prefill shape (llama3.2-3b: B 4, S = T 512,
// H 24, KV 8, D 128, causal) the call moves 33.5 MB (q, k, v read once, out
// written once: 0.0100 ms at 3.35 TB/s) for 6.46 GFLOP (0.0065 ms at 989
// TFLOP/s): bytes. At S = 2048 the 25.8 GFLOP of the causal triangle take
// 0.026 ms on the tensor cores: operations. Either way the products have to
// run at the tensor cores' full rate while the K/V tiles stream in behind
// them, and nothing may round-trip through shared memory per key tile.
//
// bfloat16 body (flash_fwd_bf16), built from what only Hopper has:
//   * Block: two consumer warpgroups of 64 folded rows each (128 rows per
//     unit of work) and one producer warp, in a warpgroup of its own whose
//     other three warps only give up their registers: setmaxnreg leaves the
//     producer warpgroup 24 a thread and gives the consumers 240.
//   * Persistent blocks, one an SM. A unit is a tile of 128 folded rows of
//     one kv head and batch row: ceil(S*G / 128) * KV * B units, numbered
//     longest first (with causal masking, the last row tiles). A block
//     takes one unit a round, walking that order forward and back in
//     turns, so long units pair with short ones and none forms the tail.
//     Persistent, so that a unit's first loads, its Q copy and its
//     epilogue overlap other work: the producer runs on into the next
//     unit's K/V while the consumers write the last one's output, and the
//     next unit's Q is copied (cp.async) under that epilogue.
//   * K and V tiles of kBK = 128 keys are loaded by TMA (cp.async.bulk.tensor,
//     rank-4 maps over [B, T, KV, D] with the tensors' own strides, a box of
//     (w, 1, kBK, 1)) into a ring of two stages that runs on from unit to
//     unit. K and V each have a full mbarrier (the TMA bytes landed) and an
//     empty one (every consumer warp is done), so K's stage is handed back
//     as soon as S is computed. w is the largest of 64, 32, 16 that divides
//     D, with the 128B, 64B or 32B swizzle. TMA zero-fills keys t >= T;
//     their scores are masked by index as well. The maps are encoded on the
//     host at each call (cuTensorMapEncodeTiled through
//     cudaGetDriverEntryPoint, so the library needs no -lcuda).
//   * Q is copied once a unit by the consumer threads with 16-byte
//     cp.async, into the same swizzled layout by hand (the folded rows of
//     one kv head form a TMA box only when G divides the tile), then fenced
//     to the async proxy.
//   * S = Q K^T runs as wgmma m64 n(kBK) k16 with both operands in shared
//     memory and the float32 accumulator in registers. The softmax runs on
//     that accumulator in log2 units (one FMA and one ex2 per score): each
//     thread holds parts of two rows, so a row's max takes two shuffles in
//     its quad, and l is summed per thread and reduced once at the end.
//     Masks are applied only on tiles that cross the diagonal or T.
//   * O += P V: P is converted to bfloat16 in registers and fed as the
//     register A operand of wgmma (the RS form); V is the shared-memory B
//     operand, read through the transpose flag since it is [keys, D]. O is a
//     64 x D float32 accumulator in registers, rescaled per row there.
//   * A warpgroup runs its tiles in order (S, softmax, P V); the two
//     warpgroups of a block interleave on the tensor cores, one's softmax
//     beside the other's products.
//   * Epilogue: O / l as bfloat16, staged through shared memory (a buffer
//     apart from Q) and written with 16-byte stores through the output
//     strides.
// A consumer warp releases a stage (arrives on its empty barrier) only after
// wgmma.wait_group has retired its reads. A wait on a barrier that never
// completes traps after about two seconds instead of hanging the card.
//
// float32 body (flash_fwd_f32): the tests' type, held at 2e-5, which TF32
// would miss, so its products are float32 FMAs on the CUDA cores. One block
// of 4 warps per 64 folded rows; each warp owns 16 rows from scores to
// output, with the output accumulator in shared memory (151 KB at D = 128).

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // flash_attention.py:NEG_INF
constexpr int kMaxD = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, S, H] float32, or null
  int64_t q_sb, q_ss, q_sh;  // strides (elements) of q over b, s, h
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int B, S, T, H, KV, D;
  int causal;
  float scale;
};

__host__ __device__ constexpr size_t align_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

// ---------------------------------------------------------------------------
// float32 body: CUDA-core FMAs
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // (query, group head) rows per block
constexpr int kBK = 64;             // keys per tile
constexpr int kPad = 1;   // odd row length: a warp reading one column of 32
                          // K rows hits 32 different banks
constexpr int kOPad = 4;  // float row padding of the S and O tiles

// Byte offsets of the tiles in dynamic shared memory.
struct Layout {
  int ldq, lds, ldo;
  size_t q, k, v, s, o, m, l, bytes;
  __host__ __device__ explicit Layout(int D) {
    ldq = D + kPad;
    lds = kBK + kOPad;
    ldo = D + kOPad;
    q = 0;
    k = align_up(q + sizeof(float) * kRows * ldq, 128);
    v = align_up(k + sizeof(float) * kBK * ldq, 128);
    s = align_up(v + sizeof(float) * kBK * ldq, 128);
    o = align_up(s + sizeof(float) * kRows * lds, 128);
    m = align_up(o + sizeof(float) * kRows * ldo, 128);
    l = m + sizeof(float) * kRows;
    bytes = l + sizeof(float) * kRows;
  }
};

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

// Copy `rows` rows of D floats, row r at src + r * stride, into a shared
// tile with leading dimension ld; rows >= valid are zero.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int64_t stride, int rows, int valid,
                                          int D) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * ld + c] = r < valid ? src[r * stride + c] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads) flash_fwd_f32(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D;
  const Layout lay(D);
  float* sQ = reinterpret_cast<float*>(smem + lay.q);
  float* sK = reinterpret_cast<float*>(smem + lay.k);
  float* sV = reinterpret_cast<float*>(smem + lay.v);
  float* sS = reinterpret_cast<float*>(smem + lay.s);
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

  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // Q tile: row r is flattened row i = row0 + r = s * G + g. Each row is
  // its own gather (rows of one s are G consecutive heads).
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int fr = row0 + r;
    const int s = fr / G;
    const int h = kvh * G + (fr - s * G);
    sQ[r * lay.ldq + c] =
        fr < n_rows ? q[b * p.q_sb + s * p.q_ss + h * p.q_sh + c] : 0.f;
    sO[r * lay.ldo + c] = 0.f;
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
    load_rows(sK, lay.ldq, k + t0 * p.k_st, p.k_st, kBK, p.T - t0, D);
    load_rows(sV, lay.ldq, v + t0 * p.v_st, p.v_st, kBK, p.T - t0, D);
    __syncthreads();

    // S[wrow:wrow+16, :] = Q K^T (unscaled); lane holds keys lane, lane + 32.
    {
      float acc[16][2];
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float k0 = sK[lane * lay.ldq + d];
        const float k1 = sK[(lane + 32) * lay.ldq + d];
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float qv = sQ[(wrow + r) * lay.ldq + d];
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

    // Online softmax over this tile, one row at a time; P overwrites S.
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
      sS[r * lay.lds + lane] = p0;
      sS[r * lay.lds + lane + 32] = p1;
      for (int d = lane; d < D; d += 32) sO[r * lay.ldo + d] *= alpha;
      __syncwarp();  // every lane has read sM[r] before lane 0 writes it
      if (lane == 0) {
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncwarp();

    // O[wrow:wrow+16, :] += P V; lane owns columns lane + 32 * jj.
    {
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
          const float vv = d < D ? sV[c * lay.ldq + d] : 0.f;
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

  // out = acc / max(l, 1e-30).
  float* o = static_cast<float*>(p.o);
  for (int rr = 0; rr < 16; ++rr) {
    const int r = wrow + rr;
    const int fr = row0 + r;
    if (fr >= n_rows) break;
    const int s = fr / G;
    const int h = kvh * G + (fr - s * G);
    const float l = fmaxf(sL[r], 1e-30f);
    float* dst = o + b * p.o_sb + s * p.o_ss + h * p.o_sh;
    for (int d = lane; d < D; d += 32) dst[d] = sO[r * lay.ldo + d] / l;
    if (p.lse != nullptr && lane == 0)
      p.lse[(static_cast<int64_t>(b) * p.S + s) * p.H + h] = sM[r] + logf(l);
  }
}

int launch(const Params& p, cudaStream_t stream) {
  // Raise the dynamic shared-memory limit once, to what D = kMaxD needs
  // (function-local static: initialised once, thread-safe).
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Layout(kMaxD).bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int G = p.H / p.KV;
  const dim3 grid((p.S * G + kRows - 1) / kRows, p.KV, p.B);
  flash_fwd_f32<<<grid, kThreads, Layout(p.D).bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16 body: wgmma, register accumulators, TMA-fed K/V ring
// ---------------------------------------------------------------------------

namespace tc {

using namespace sm90;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Two consumer warpgroups per block (each owns 64 folded rows), and a
// producer warpgroup of which one warp issues the loads: ptxas sizes a
// kernel that uses setmaxnreg in whole warpgroups, and the three idle warps
// hand their registers over.
constexpr int kConsumers = 2;
constexpr int kRows = 64 * kConsumers;  // folded rows per block
constexpr int kThreads = 128 * kConsumers + 128;
constexpr int kStages = 2;  // K/V ring depth
constexpr int kBK = 128;    // keys per tile: 64 float32 score registers a thread
// setmaxnreg targets: a block of 384 threads gets 168 registers a thread at
// launch (65,536 an SM, in steps of 8); 24 go to the producer warpgroup and
// 240 to the consumers (168 * 384 = 128 * 24 + 256 * 240).
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert(65536 / kThreads / 8 * 8 * kThreads >=
                  128 * kProducerRegs + 128 * kConsumers * kConsumerRegs,
              "setmaxnreg targets exceed the registers of one block an SM");

// Tile geometry for head size D. A K or V tile is kBoxes boxes of
// [kBK rows x kW columns], one TMA box each, every row 2 * kW bytes wide
// with the matching swizzle (Swizzle<D>); Q is the same with 64 rows.
template <int D>
struct Cfg : Swizzle<D> {
  static constexpr int kW = Swizzle<D>::kW;
  static constexpr uint32_t kQBox = 64 * 2 * kW;   // bytes of one Q box
  static constexpr uint32_t kKVBox = kBK * 2 * kW; // bytes of one K or V box
  static constexpr uint32_t kTile = kBK * D * 2;   // bytes of one K or V tile
  static constexpr uint32_t kQBytes = 64 * D * 2;  // one consumer's Q tile
  static constexpr uint32_t kOPitch = (D + 8) * 2; // output staging row bytes
  static constexpr uint32_t kOBytes = align_up(64 * kOPitch, 1024);
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kO = kQ + kConsumers * kQBytes;  // kQBytes % 1024 == 0
  static constexpr uint32_t kK = kO + kConsumers * kOBytes;
  static constexpr uint32_t kV = kK + kStages * kTile;
  static constexpr uint32_t kBar = kV + kStages * kTile;  // 4 barriers a stage
  static constexpr uint32_t kBytes = kBar + 4 * kStages * 8 + 1024;  // + alignment
};

// 16-byte asynchronous copy to shared memory; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Online softmax of one score tile in registers. sc holds the raw dot
// products of the thread's fragment: sc[4 n + e] is row g + 8 (e >> 1) of
// the warp's 16, key t0 + 8 n + 2 c + (e & 1). Scores are kept in log2
// units (c2 = scale * log2(e)), so p = 2^(s * c2 - m) is one FMA and one
// ex2. A masked score is -1e30 as in the Pallas body: it never raises a
// row's maximum, and its p is exactly 0 once the row has seen a key (every
// row sees key 0 in its first tile). On return sc holds p (float32,
// unrounded), m the new row maxima, l the rescaled partial row sums plus
// this tile's p, and alpha the factor the accumulator must take.
__device__ __forceinline__ void online_softmax(float (&sc)[kBK / 2], float (&m)[2],
                                               float (&l)[2], float (&alpha)[2],
                                               bool edge, int t0, int T, bool causal,
                                               const int (&srow)[2], int c, float c2) {
  if (edge) {
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int t = t0 + 8 * (i / 4) + 2 * c + (i & 1);
      if (t >= T || (causal && t > srow[(i >> 1) & 1])) sc[i] = kNegInf;
    }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float neg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // a row lives in the 4 threads of a quad
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h] * c2);
    alpha[h] = ex2(m[h] - m_new);
    m[h] = m_new;
    l[h] *= alpha[h];
    neg[h] = -m_new;
  }
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    sc[i] = ex2(fmaf(sc[i], c2, neg[(i >> 1) & 1]));
    l[(i >> 1) & 1] += sc[i];  // the unrounded p, as the Pallas body sums it
  }
}

struct Unit {
  int row0, kvh, b, n_tiles;
};

__device__ __forceinline__ Unit unit_of(int w, const Params& p, int n_row_tiles) {
  const int G = p.H / p.KV;
  const int n_rows = p.S * G;
  const int per_tile = p.KV * p.B;
  Unit u;
  u.row0 = (n_row_tiles - 1 - w / per_tile) * kRows;
  u.kvh = w % per_tile % p.KV;
  u.b = w % per_tile / p.KV;
  int t_end = p.T;  // causal: keys up to the unit's last query
  if (p.causal) t_end = min(t_end, (min(u.row0 + kRows, n_rows) - 1) / G + 1);
  u.n_tiles = (t_end + kBK - 1) / kBK;
  return u;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms need 1024 B
  unsigned char* smem = smem_raw + (base - raw);
  // Ring barriers: full (the producer's TMA landed) and empty (every
  // consumer warp is done with the stage), for K and for V. The ring runs
  // on across units: the g-th tile a block loads sits in stage g % kStages.
  const uint32_t bar = base + C::kBar;
  auto full_k = [&](int s) { return bar + 8 * s; };
  auto full_v = [&](int s) { return bar + 8 * (kStages + s); };
  auto empty_k = [&](int s) { return bar + 8 * (2 * kStages + s); };
  auto empty_v = [&](int s) { return bar + 8 * (3 * kStages + s); };

  const int G = p.H / p.KV;
  const int n_rows = p.S * G;
  const int n_row_tiles = (n_rows + kRows - 1) / kRows;
  const int n_units = n_row_tiles * p.KV * p.B;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 4 * kConsumers);  // one arrival per consumer warp
      mbar_init(empty_v(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= 4 * kConsumers) {
    // ---- producer: one thread keeps the K/V ring full, unit after unit -----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      int g = 0;
      for (int i = 0, w; (w = unit_index(i, n_units)) >= 0; ++i) {
        const Unit u = unit_of(w, p, n_row_tiles);
        for (int j = 0; j < u.n_tiles; ++j, ++g) {
          const int s = g % kStages;
          const uint32_t free_parity = ((g / kStages) & 1) ^ 1;
          mbar_wait(empty_k(s), free_parity);
          mbar_expect_tx(full_k(s), C::kTile);
#pragma unroll
          for (int x = 0; x < C::kBoxes; ++x)
            tma_load(base + C::kK + s * C::kTile + x * C::kKVBox, &tm_k, full_k(s),
                     x * C::kW, u.kvh, j * kBK, u.b);
          mbar_wait(empty_v(s), free_parity);
          mbar_expect_tx(full_v(s), C::kTile);
#pragma unroll
          for (int x = 0; x < C::kBoxes; ++x)
            tma_load(base + C::kV + s * C::kTile + x * C::kKVBox, &tm_v, full_v(s),
                     x * C::kW, u.kvh, j * kBK, u.b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup: 64 folded rows of every unit -------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp / 4;
    const int tid = threadIdx.x % 128;
    const int g4 = lane / 4;  // this thread's accumulator rows are
    const int c = lane % 4;   // 16 * (warp % 4) + g4 and + 8
    const uint32_t sq = base + C::kQ + wg * C::kQBytes;
    unsigned char* stage = smem + C::kO + wg * C::kOBytes;
    const float c2 = p.scale * 1.4426950408889634f;  // scores in log2 units
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o);

    // Q rows of a unit: 16-byte asynchronous copies written in the swizzled
    // layout of a TMA box; rows >= S * G are zero.
    auto load_q = [&](const Unit& u) {
      const int i0 = u.row0 + 64 * wg;
      for (int idx = tid; idx < 64 * D / 8; idx += 128) {
        const int r = idx / (D / 8);
        const int col = (idx % (D / 8)) * 8;
        const int fr = i0 + r;
        const __nv_bfloat16* src = q;
        if (fr < n_rows) {
          const int s = fr / G;
          const int h = u.kvh * G + (fr - s * G);
          src = q + u.b * p.q_sb + s * p.q_ss + h * p.q_sh + col;
        }
        uint32_t off = (col / C::kW) * C::kQBox + r * 2 * C::kW + (col % C::kW) * 2;
        off ^= (off >> 3) & C::kMask;
        cp_async16(sq + off, src, fr < n_rows ? 16 : 0);
      }
    };

    int g = 0;  // the block's tile count so far: ring stage and phase
    int w = unit_index(0, n_units);
    if (w >= 0) load_q(unit_of(w, p, n_row_tiles));
    for (int i = 0; w >= 0; ++i) {
      const Unit u = unit_of(w, p, n_row_tiles);
      const int i0 = u.row0 + 64 * wg;  // this warpgroup's first folded row
      cp_async_wait_all();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + wg, 128);  // Q is in place for every warp's wgmma

      int srow[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) srow[h] = (i0 + 16 * (warp % 4) + g4 + 8 * h) / G;
      int n_mine = 0;  // key tiles this warpgroup needs (0 if it has no rows)
      if (i0 < n_rows) {
        int te = p.T;
        if (p.causal) te = min(te, (min(i0 + 64, n_rows) - 1) / G + 1);
        n_mine = (te + kBK - 1) / kBK;
      }
      const int s_first = i0 / G;

      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m[2] = {kNegInf, kNegInf};
      float l[2] = {0.f, 0.f};

      // Per key tile: S = Q K^T, release K, softmax, O = alpha O + P V,
      // release V. The two consumer warpgroups interleave on the tensor
      // cores: one runs its softmax while the other's products run.
      for (int j = 0; j < u.n_tiles; ++j, ++g) {
        const int st = g % kStages;
        const uint32_t ph = (g / kStages) & 1;
        if (j < n_mine) {
          const uint32_t sk = base + C::kK + st * C::kTile;
          const uint32_t sv = base + C::kV + st * C::kTile;
          float sc[kBK / 2];
          mbar_wait(full_k(st), ph);
          wgmma_fence();
#pragma unroll
          for (int kb = 0; kb < D / 16; ++kb) {
            // Box kb * 16 / kW, then 32 bytes per k-step inside its rows.
            const int box = kb * 16 / C::kW;
            const uint32_t off = (kb * 16 % C::kW) * 2;
            wgmma_ss(sc, make_desc(sq + box * C::kQBox + off, 1, C::kW, C::kLayout),
                     make_desc(sk + box * C::kKVBox + off, 1, C::kW, C::kLayout),
                     kb > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty_k(st));
          const int t0 = j * kBK;
          const bool edge = t0 + kBK > p.T || (p.causal && t0 + kBK - 1 > s_first);
          float alpha[2];
          online_softmax(sc, m, l, alpha, edge, t0, p.T, p.causal, srow, c, c2);
          uint32_t pa[kBK / 16][4];
          pack_a<kBK>(sc, pa);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
          mbar_wait(full_v(st), ph);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            wgmma_rs(o, pa[kk],
                     make_desc(sv + kk * 16 * 2 * C::kW, C::kKVBox / 16, C::kW,
                               C::kLayout));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(o);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty_v(st));
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

      // Every warp's last wgmma has read Q: start the next unit's Q copy,
      // then write this unit's output while it lands.
      named_sync(1 + wg, 128);
      const int next = unit_index(i + 1, n_units);
      if (next >= 0) load_q(unit_of(next, p, n_row_tiles));

      // out = O / max(l, 1e-30) in bfloat16, staged row-major, then 16-byte
      // stores through the output strides.
      float inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        inv[h] = 1.f / fmaxf(l[h], 1e-30f);
      }
      if (p.lse != nullptr && c == 0) {
        // m is in log2 units: lse = m * ln 2 + log(l), natural log.
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int fr = i0 + 16 * (warp % 4) + g4 + 8 * h;
          if (fr < n_rows) {
            const int s = fr / G;
            p.lse[(static_cast<int64_t>(u.b) * p.S + s) * p.H + u.kvh * G + (fr - s * G)] =
                m[h] * 0.6931471805599453f + logf(fmaxf(l[h], 1e-30f));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < D / 2; i += 2) {
        const int h = (i >> 1) & 1;
        const int r = 16 * (warp % 4) + g4 + 8 * h;
        const int col = 8 * (i / 4) + 2 * c;
        *reinterpret_cast<uint32_t*>(stage + r * C::kOPitch + col * 2) =
            pack_bf16(o[i] * inv[h], o[i + 1] * inv[h]);
      }
      named_sync(1 + wg, 128);
      for (int idx = tid; idx < 64 * D / 8; idx += 128) {
        const int r = idx / (D / 8);
        const int col = (idx % (D / 8)) * 8;
        const int fr = i0 + r;
        if (fr >= n_rows) continue;
        const int s = fr / G;
        const int h = u.kvh * G + (fr - s * G);
        *reinterpret_cast<uint4*>(out + u.b * p.o_sb + s * p.o_ss + h * p.o_sh +
                                  col) =
            *reinterpret_cast<const uint4*>(stage + r * C::kOPitch + col * 2);
      }
      w = next;
    }
  }
}

template <int D>
int launch_d(const Params& p, cudaStream_t stream) {
  using C = Cfg<D>;
  auto* kernel = flash_fwd_bf16<D>;
  // Once per instantiation: raise the shared-memory limit, and refuse to
  // launch if setmaxnreg's targets exceed the registers the block is given
  // (the consumers' setmaxnreg.inc would wait for them forever).
  static const int ready = [kernel] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (attr.numRegs * kThreads <
        128 * kConsumers * kConsumerRegs + 128 * kProducerRegs)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    return 0;
  }();
  if (ready != 0) return ready;
  CUtensorMap tm_k, tm_v;
  // Rank-4 maps over [B, T, KV, D] with the tensors' strides, box (w, 1, kBK).
  if (!encode_4d(&tm_k, p.k, D, p.KV, p.T, p.B, p.k_sh, p.k_st, p.k_sb, C::kW, 1, kBK,
                 C::kMode) ||
      !encode_4d(&tm_v, p.v, D, p.KV, p.T, p.B, p.v_sh, p.v_st, p.v_sb, C::kW, 1, kBK,
                 C::kMode))
    return static_cast<int>(cudaErrorInvalidValue);
  // Persistent blocks, one an SM, each taking a unit a round.
  const int G = p.H / p.KV;
  const int n_units = (p.S * G + kRows - 1) / kRows * p.KV * p.B;
  const int blocks = cmin(n_units, sm_count());
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  kernel<<<blocks, kThreads, C::kBytes, stream>>>(tm_k, tm_v, p);
  return static_cast<int>(cudaGetLastError());
}

int launch(const Params& p, cudaStream_t stream) {
  return with_d(p.D, static_cast<int>(cudaErrorInvalidValue), [&](auto d) {
    return launch_d<decltype(d)::value>(p, stream);
  });
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (b, s, h)
// of q, (b, t, kv) of k, of v, and (b, s, h) of out; the last dimension of
// every tensor is contiguous. lse: a contiguous float32 [B, S, H] tensor
// that receives each row's log-sum-exp, or null. Returns the cudaError_t of
// the launch.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* out, float* lse,
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
  p.lse = lse;
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
  if (dtype == 1) return tc::launch(p, st);
  if (dtype == 0) return f32::launch(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block for dtype (0 = float32, 1 = bfloat16)
// and head size D, in bytes; -1 for a D the kernel does not take.
extern "C" int flash_attention_smem_bytes(int dtype, int D) {
  if (D <= 0 || D % 16 != 0 || D > kMaxD) return -1;
  if (dtype == 0) return static_cast<int>(f32::Layout(D).bytes);
  return sm90::with_d(D, -1, [](auto d) {
    constexpr int kD = decltype(d)::value;
    return static_cast<int>(tc::Cfg<kD>::kBytes);
  });
}
