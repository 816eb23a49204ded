// Causal flash attention over [B*H, S, 64] tensors: forward, dQ, dK/dV.
//
// Replaces the three Pallas kernels of the JAX package's
// llm_sharding_demo_tpu/ops/flash_attention.py:
//
//   flash_fwd      <- _fwd_kernel (:117, pallas_call :183)
//     out[i] = sum_{j <= i} softmax_j(scale * q_i . k_j) v_j,
//     lse[i] = log sum_{j <= i} exp(scale * q_i . k_j)
//   flash_bwd_dq   <- _bwd_dq_kernel (:216, pallas_call :313)
//     dq_i = scale * sum_{j <= i} ds_ij k_j
//   flash_bwd_dkv  <- _bwd_dkv_kernel (:252, pallas_call :332)
//     dv_j = sum_{i >= j} p_ij do_i,   dk_j = scale * sum_{i >= j} ds_ij q_i
//
// with p_ij = exp(scale * q_i . k_j - lse_i) recomputed from the saved
// logsumexp and ds_ij = p_ij * (do_i . v_j - D_i), D = rowsum(dO * O)
// computed outside the kernels (as XLA does it in the JAX package).
// Scores, softmax and every accumulator are f32; outputs are rounded once
// to the input dtype. The forward keeps the JAX kernel's two safeguards:
// a running max still at NEG_INF shifts to 0 before exp (m_safe), and the
// normaliser is clamped at 1e-20 before the divide.
//
// What bounds them on this card: operations. At B=4, H=12, S=2048, hd=64
// (llama-124m training) the causal forward does ~25.8 GFLOP (two products
// over the lower triangle), dQ ~38.7 (three), dK/dV ~51.5 (four), against
// ~25 MB of inputs and outputs: 0.026 / 0.039 / 0.052 ms at 989 TFLOP/s
// bf16, far above the 0.008 ms the bytes take at 3.35 TB/s. In f32 the
// bound is the 67 TFLOP/s of the non-tensor f32 units.
//
// Design:
//
// - bf16 forward (fwd_bf16, below): warp-specialised for Hopper, one
//   persistent CTA per SM. A producer warpgroup feeds K/V tiles by TMA
//   into a three-stage ring with mbarriers; two consumer warpgroups run
//   wgmma (S = Q.K^T from shared memory, O += P.V with P from registers),
//   the softmax in exp2 with the scale folded into one FMA, the mask on
//   the diagonal tile only.
// - bf16 dK/dV (dkv_bf16, below): the forward's shape turned around. One
//   persistent CTA per SM walks (128-key block, b*h) tiles; the producer
//   warpgroup loads each tile's K and V once and streams 64-row Q and dO
//   tiles with their row statistics through a TMA ring; each consumer
//   warpgroup owns 64 keys and runs the four products on wgmma m64n64k16
//   (S^T and dP^T from shared memory, P^T.dO and dS^T.Q with P^T and dS^T
//   from registers).
// - bf16 dQ: one block of 4 warps per (b*h, 64-row tile); each warp owns
//   16 rows and runs mma.sync m16n8k16 bf16 tiles with f32 accumulators.
//   Q and dO fragments stay in registers for the whole loop; K/V tiles of
//   64 rows are staged in shared memory with a 144-byte row stride, so
//   every fragment load is free of bank conflicts.
// - As in FlashAttention-2, P is rounded to bf16 before the P.V product
//   and dS to bf16 before the dS.K and dS^T.Q products; l and every sum
//   stay f32. The tests and chip_smoke.py hold the bf16 kernels to a
//   tolerance that covers these roundings.
// - f32: the same tiles with scalar f32 arithmetic (no TF32: the JAX
//   kernel casts everything to f32), two threads per row, each owning the
//   even or the odd head dims; dot products are completed with one
//   shuffle.
// - Causality: the forward and dQ walk the k tiles up to the diagonal
//   (tile index <= q tile), dK/dV the q tiles from the diagonal to the
//   end; tiles above the diagonal are never read. The mask j <= i, j < S
//   inside a tile also covers a ragged last tile (rows past S load as
//   zeros and are never written), so any S works. The bf16 forward's
//   tiles are 128 rows, bf16 dK/dV's 128 keys by 64 queries, the other
//   kernels' 64.
// - Each output element is written by exactly one thread and summed in a
//   fixed order: no atomics, so two launches are bit-identical.
// - Blocks with the most tiles start first (the forward and dQ grids run
//   the q tiles in reverse, dK/dV the k tiles in order).

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHd = 64;        // head dim (every GPT-2 size, llama-124m)
constexpr int kTile = 64;      // rows of a q tile and of a k tile
constexpr int kThreads = 128;  // 4 warps
constexpr int kPad = 72;       // bf16 shared-memory row stride (144 bytes)
constexpr float kNegInf = -1e9f;  // the JAX kernel's NEG_INF

typedef __nv_bfloat16 bf16;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* out;
  float* lse_out;
  void* dq;
  void* dk;
  void* dv;
  int S;
  float scale;
};

// -- bf16 tensor-core helpers --------------------------------------------------

// d += a . b for one m16n8k16 tile (bf16 inputs, f32 accumulators). Lane
// (g = lane / 4, t = lane % 4) holds A rows g, g + 8 and columns 2t, 2t + 1,
// 2t + 8, 2t + 9; B columns g and rows 2t, 2t + 1, 2t + 8, 2t + 9; C rows
// g, g + 8 and columns 2t, 2t + 1.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 in one register, the first in the low half
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return pack(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

typedef bf16 Tile[kTile][kPad];

// rows [row0, row0 + 64) of a [S, 64] matrix into shared memory, 16 bytes
// a thread at a time; rows at or past S load as zeros
__device__ __forceinline__ void load_tile(Tile& dst, const bf16* src,
                                          int row0, int S) {
  for (int i = threadIdx.x; i < kTile * (kHd / 8); i += kThreads) {
    const int r = i / (kHd / 8), c = (i % (kHd / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * kHd +
                                            c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
  }
}

// A fragment: rows [r0, r0 + 16), columns [c0, c0 + 16) of a tile
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const Tile& t,
                                       int r0, int c0, int g, int tg) {
  a[0] = ld32(&t[r0 + g][c0 + 2 * tg]);
  a[1] = ld32(&t[r0 + g + 8][c0 + 2 * tg]);
  a[2] = ld32(&t[r0 + g][c0 + 2 * tg + 8]);
  a[3] = ld32(&t[r0 + g + 8][c0 + 2 * tg + 8]);
}

// B fragment with B[k][n] = t[n0 + n][k0 + k] (a tile row is a B column:
// K for Q.K^T, V for dO.V^T, Q or dO for the transposed products)
__device__ __forceinline__ void frag_b_rows(uint32_t& b0, uint32_t& b1,
                                            const Tile& t, int n0, int k0,
                                            int g, int tg) {
  b0 = ld32(&t[n0 + g][k0 + 2 * tg]);
  b1 = ld32(&t[n0 + g][k0 + 2 * tg + 8]);
}

// B fragment with B[k][n] = t[k0 + k][n0 + n] (the contraction runs down
// the tile's rows: V for P.V, K for dS.K, dO for P^T.dO, Q for dS^T.Q)
__device__ __forceinline__ void frag_b_cols(uint32_t& b0, uint32_t& b1,
                                            const Tile& t, int k0, int n0,
                                            int g, int tg) {
  b0 = pack(t[k0 + 2 * tg][n0 + g], t[k0 + 2 * tg + 1][n0 + g]);
  b1 = pack(t[k0 + 2 * tg + 8][n0 + g], t[k0 + 2 * tg + 9][n0 + g]);
}

// c[8][4] (a warp's 16 x 64 f32 result) as the A operand of the next
// product, rounded to bf16: k step kk takes columns [16 kk, 16 kk + 16)
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[8][4],
                                       int kk) {
  a[0] = pack(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// acc[8][4] = A (a warp's 16 x 64 in registers) . t^T over the 64 head dims
__device__ __forceinline__ void rows_dot_tile(float (&acc)[8][4],
                                              const uint32_t (&a)[4][4],
                                              const Tile& t, int g, int tg) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t b0, b1;
      frag_b_rows(b0, b1, t, nt * 8, kk * 16, g, tg);
      mma(acc[nt], a[kk], b0, b1);
    }
  }
}

// acc[8][4] += c (16 x 64, rounded to bf16) . t (64 x 64)
__device__ __forceinline__ void c_times_tile(float (&acc)[8][4],
                                             const float (&c)[8][4],
                                             const Tile& t, int g, int tg) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    c_to_a(a, c, kk);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t b0, b1;
      frag_b_cols(b0, b1, t, kk * 16, nt * 8, g, tg);
      mma(acc[nt], a, b0, b1);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// a warp's 16 x 64 result (rows row0 + g and row0 + g + 8 of this lane),
// times mul, as bf16 rows of dst
__device__ __forceinline__ void store_rows(bf16* dst, const float (&c)[8][4],
                                           int row0, float mul, int S, int g,
                                           int tg) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      __nv_bfloat162 v = __floats2bfloat162_rn(c[nt][2 * r] * mul,
                                               c[nt][2 * r + 1] * mul);
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * kHd + nt * 8 +
                                         2 * tg) = v;
    }
  }
}

// -- bf16 kernels ---------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) dq_bf16(Args p) {
  __shared__ __align__(16) Tile T0, T1;
  const int S = p.S, bh = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x, q0 = qt * kTile;
  const size_t base = (size_t)bh * S * kHd;
  const bf16* Q = static_cast<const bf16*>(p.q) + base;
  const bf16* K = static_cast<const bf16*>(p.k) + base;
  const bf16* V = static_cast<const bf16*>(p.v) + base;
  const bf16* dO = static_cast<const bf16*>(p.dout) + base;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3, wr = warp * 16;

  load_tile(T0, Q, q0, S);
  load_tile(T1, dO, q0, S);
  __syncthreads();
  uint32_t qa[4][4], da[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    frag_a(qa[kk], T0, wr, kk * 16, g, tg);
    frag_a(da[kk], T1, wr, kk * 16, g, tg);
  }
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  float lse[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse[r] = row[r] < S ? p.lse[(size_t)bh * S + row[r]] : 0.f;
    dd[r] = row[r] < S ? p.delta[(size_t)bh * S + row[r]] : 0.f;
  }
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile(T0, K, k0, S);
    load_tile(T1, V, k0, S);
    __syncthreads();
    float s[8][4], dp[8][4];
    rows_dot_tile(s, qa, T0, g, tg);   // Q . K^T
    rows_dot_tile(dp, da, T1, g, tg);  // dO . V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1, col = k0 + nt * 8 + 2 * tg + (c & 1);
        const bool ok = col <= row[r] && col < S;
        const float pr = ok ? expf(s[nt][c] * p.scale - lse[r]) : 0.f;
        s[nt][c] = pr * (dp[nt][c] - dd[r]);  // dS
      }
    c_times_tile(acc, s, T0, g, tg);  // dS (rounded to bf16) . K
  }
  store_rows(static_cast<bf16*>(p.dq) + base, acc, q0 + wr, p.scale, S, g,
             tg);
}

// -- bf16 forward: wgmma fed by a TMA ring ---------------------------------------
//
// One persistent CTA of three warpgroups per SM, walking (b*h, 128-row q
// tile) pairs heaviest first. Warpgroup 0 is the producer: one thread
// loads each tile's Q and its K/V tiles of 128 rows into a ring of
// kStages stages by TMA (3-D tensor maps over [BH, S, 64], 128-byte
// swizzle: a 64-wide bf16 row is one swizzle row; rows past S of a head
// load as zeros), with a full mbarrier per K and per V tile (expect-tx
// bytes), an empty mbarrier per stage, and a full and an empty one for
// Q, so the next tile's loads overlap this tile's last products and
// epilogue. Warpgroups 1 and 2 are the consumers, each owning 64 q rows:
// S = Q.K^T by wgmma m64n128k16 with both operands in shared memory
// (K-major), the online softmax on the accumulator fragments (exp2 with
// scale * log2(e) folded into one FMA; the causal and ragged-S mask only
// on the diagonal tile, the last one), then O += P.V by wgmma m64n64k16
// with P, rounded to bf16, as the A operand from registers (the m64nN
// accumulator layout is the register-A fragment layout) and V from
// shared memory, MN-major (the transpose bit). Tile i's Q.K^T and
// softmax run while tile i - 1's P.V is in flight; after a P.V group has
// completed, each consumer warp releases its stage. setmaxnreg moves
// registers from the producer to the consumers.

constexpr int kFwdBM = 128;       // q rows of a CTA: two consumer warpgroups
constexpr int kFwdBN = 128;       // k rows of a ring stage
constexpr int kStages = 3;
constexpr int kFwdThreads = 384;  // producer + two consumer warpgroups
constexpr uint32_t kTileBytes = kFwdBN * kHd * sizeof(bf16);  // 16 KB
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct FwdSmem {  // every tile starts on a 1024-byte swizzle period
  bf16 q[kFwdBM * kHd];
  bf16 k[kStages][kFwdBN * kHd];
  bf16 v[kStages][kFwdBN * kHd];
  uint64_t q_full;
  uint64_t q_empty;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t empty[kStages];
};
constexpr int kFwdSmemBytes = sizeof(FwdSmem) + 1024;  // + alignment slack

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// the map's box of rows from row on of head bh into shared memory,
// completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(row), "r"(bh)
      : "memory");
}

// the box of a 1-D map from element x on into shared memory, completing
// on bar
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x)
      : "memory");
}

// a wgmma shared-memory descriptor for a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  return d | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// all but the newest committed group complete
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keep the compiler from moving accesses of registers that an
// asynchronous wgmma reads or writes across the fence / wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (the 64 x 128 m64n128 accumulator) = (accumulate ? d : 0) + A . B^T
// over 16 columns: A (64 rows) and B (128 rows) K-major in shared memory
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (the 64 x 64 m64n64 accumulator) = (accumulate ? d : 0) + A . B^T
// over 16 columns: A and B (64 rows each) K-major in shared memory
__device__ __forceinline__ void wgmma_qk64(float (&d)[32], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (the 64 x 64 m64n64 accumulator) += A . B over 16 positions: A (P,
// P^T or dS^T, bf16) from registers, B (V, dO or Q) MN-major in shared
// memory (transposed)
__device__ __forceinline__ void wgmma_pv(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// grid: one persistent CTA per SM (at most the tile count); CTA c takes
// tiles c, c + gridDim.x, ... of the (q tile, b*h) list ordered heaviest
// first (q tile nq - 1 - t / BH, head t % BH), so each round of the grid
// runs tiles of nearly equal cost; block kFwdThreads; dynamic shared
// memory kFwdSmemBytes
__global__ void __launch_bounds__(kFwdThreads, 1)
fwd_bf16(const __grid_constant__ CUtensorMap tq,
         const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
         float* __restrict__ lse_out, int S, int BH, float scale) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int nq = (S + kFwdBM - 1) / kFwdBM;
  const int n_tiles = nq * BH;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    mbar_init(&sm.q_empty, 8);  // one arrival per consumer warp
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.k_full[st], 1);
      mbar_init(&sm.v_full[st], 1);
      mbar_init(&sm.empty[st], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every copy. The ring's k
    // tiles are counted across the CTA's q tiles (it), and so are the
    // stages and their phases.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0, round = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++round) {
        const int qt = nq - 1 - t / BH, bh = t % BH;
        // the previous q tile's last Q.K^T has read Q
        mbar_wait(&sm.q_empty, (round & 1) ^ 1);
        mbar_expect_tx(&sm.q_full, kTileBytes);
        tma_load(sm.q, &tq, &sm.q_full, qt * kFwdBM, bh);
        for (int i = 0; i <= qt; ++i, ++it) {
          const int st = it % kStages;
          // the stage's previous round released (the first round passes)
          mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&sm.k_full[st], kTileBytes);
          tma_load(sm.k[st], &tk, &sm.k_full[st], i * kFwdBN, bh);
          mbar_expect_tx(&sm.v_full[st], kTileBytes);
          tma_load(sm.v[st], &tv, &sm.v_full[st], i * kFwdBN, bh);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t0 = threadIdx.x - 128;
    const int cw = t0 >> 7;  // consumer warpgroup: q rows [64 cw, 64 cw + 64)
    const int warp = (t0 >> 5) & 3, lane = t0 & 31;
    const int g = lane >> 2, tg = lane & 3;
    const float sl2 = scale * kLog2e;
    const uint64_t dq = sw128_desc(sm.q + 64 * cw * kHd, 16, 1024);
    int it = 0, round = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++round) {
      const int qt = nq - 1 - t / BH, bh = t % BH, q0 = qt * kFwdBM;
      const int n_k = qt + 1;  // k tiles up to the diagonal (kFwdBN == kFwdBM)
      const int row[2] = {q0 + 64 * cw + 16 * warp + g,
                          q0 + 64 * cw + 16 * warp + g + 8};
      // running max of the raw scores, and this thread's part of the
      // normaliser (its quad's parts are summed at the end)
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
      float o[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      // S = Q . K^T of tile i into s (issued, committed, not waited for)
      auto issue_qk = [&](float (&s)[64], int i) {
        const int st = (it + i) % kStages;
        mbar_wait(&sm.k_full[st], ((it + i) / kStages) & 1);
        const uint64_t dk = sw128_desc(sm.k[st], 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // +32 bytes per 16 head dims
          wgmma_qk(s, dq + 2 * kk, dk + 2 * kk, kk);
        wgmma_commit();
      };
      // O += P . V of tile i (issued and committed)
      auto issue_pv = [&](const uint32_t (&pa)[8][4], int i) {
        const int st = (it + i) % kStages;
        mbar_wait(&sm.v_full[st], ((it + i) / kStages) & 1);
        const uint64_t dv = sw128_desc(sm.v[st], 1024, 1024);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)  // +2048 bytes per 16 positions
          wgmma_pv(o, pa[kk], dv + 128 * kk);
        wgmma_commit();
      };
      // the online softmax of tile i's scores: s becomes P (f32), m moves
      // to the new max, alpha is the factor for l and the output
      auto softmax = [&](float (&s)[64], float (&alpha)[2], int i) {
        if (i == n_k - 1) {
          // the diagonal tile, the only one that can also cross S
          const int k0 = i * kFwdBN;
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int r = c >> 1, col = k0 + 8 * j + 2 * tg + (c & 1);
              const bool ok = col <= row[r] && col < S;
              if (!ok) s[4 * j + c] = -INFINITY;
            }
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            mx[c >> 1] = fmaxf(mx[c >> 1], s[4 * j + c]);
        float ms[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = quad_max(mx[r]);
          // a row with nothing visible yet keeps its max at NEG_INF:
          // shift to 0 so that exp underflows to exactly 0 (the JAX
          // kernel's m_safe)
          const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
          alpha[r] = ex2((m[r] - m_safe) * sl2);
          m[r] = m_safe;
          ms[r] = m_safe * sl2;
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            // exp(scale * (s - m)) = 2^(s * scale * log2(e) - m * ...)
            const float p = ex2(fmaf(s[4 * j + c], sl2, -ms[c >> 1]));
            s[4 * j + c] = p;
            sum[c >> 1] += p;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
      };
      // the output rescaled, and P rounded to bf16 as the next A
      // operand: 16 positions per k step
      auto rescale_and_pack = [&](const float (&s)[64],
                                  const float (&alpha)[2],
                                  uint32_t (&pa)[8][4]) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) o[4 * j + c] *= alpha[c >> 1];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          pa[kk][0] = pack(s[8 * kk + 0], s[8 * kk + 1]);
          pa[kk][1] = pack(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack(s[8 * kk + 6], s[8 * kk + 7]);
        }
      };
      // hand a barrier's slot back to the producer, once per warp
      auto arrive = [&](uint64_t* bar) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar);
      };

      mbar_wait(&sm.q_full, round & 1);
      float s[64], alpha[2];
      uint32_t pa[8][4];
      issue_qk(s, 0);
      wgmma_wait_all();
      fence_regs(s);
      if (n_k == 1) arrive(&sm.q_empty);  // the tile's last read of Q
      softmax(s, alpha, 0);
      rescale_and_pack(s, alpha, pa);
      // tile i's scores and softmax overlap tile i - 1's P.V: the two
      // groups complete in order, so waiting for all but one is waiting
      // for S
      for (int i = 1; i < n_k; ++i) {
        issue_qk(s, i);
        issue_pv(pa, i - 1);
        wgmma_wait_one();
        fence_regs(s);
        if (i == n_k - 1) arrive(&sm.q_empty);
        softmax(s, alpha, i);
        wgmma_wait_all();
        fence_regs(o);
        fence_regs(pa);  // the P.V group read pa until here
        arrive(&sm.empty[(it + i - 1) % kStages]);
        rescale_and_pack(s, alpha, pa);
      }
      issue_pv(pa, n_k - 1);
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(pa);
      arrive(&sm.empty[(it + n_k - 1) % kStages]);
      it += n_k;

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = fmaxf(quad_sum(l[r]), 1e-20f);  // causal rows see themselves
        // lse = scale * m + ln(l) = ln(2) * (m * scale * log2(e) + log2(l))
        if (tg == 0 && row[r] < S)
          lse_out[(size_t)bh * S + row[r]] =
              kLn2 * (m[r] * sl2 + log2f(l[r]));
      }
      // out = acc / l, as the JAX kernel divides (not a multiply by 1 / l)
      bf16* dst = out + (size_t)bh * S * kHd;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] >= S) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat162 val = __floats2bfloat162_rn(
              o[4 * j + 2 * r] / l[r], o[4 * j + 2 * r + 1] / l[r]);
          *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row[r] * kHd +
                                             8 * j + 2 * tg) = val;
        }
      }
    }
  }
}

// -- bf16 dK/dV: wgmma fed by a TMA ring ------------------------------------------
//
// The forward's shape turned around: one persistent CTA of three
// warpgroups per SM walks (128-key block, b*h) work tiles, the list
// heaviest first (key block kt visits the q tiles from its diagonal to S,
// so the lowest kt costs most) and taken by the grid back and forth (CTA
// c takes positions c, 2G - 1 - c, 2G + c, ... of G CTAs), so the CTAs'
// sums of work come out nearly equal. Warpgroup 0 is the producer: one
// thread loads each work tile's K and V (128 rows each) once by TMA into
// one of two buffers (the next tile's K/V load while this one's last q
// tiles run), and streams 64-row Q and dO tiles, each with its 64 rows of
// lse and D, through a ring of kDkvStages stages (a full mbarrier with
// expect-tx bytes, an empty one with one arrival per consumer warp; the
// ring is counted across work tiles). lse and D come through a 1-D map
// over the flat [BH * S] array: a map over [BH, S] would need a row
// stride of a multiple of 16 bytes, which S = 333 does not give. A box
// must also start on a 16-byte boundary, so each stage's box starts at
// the multiple of 4 elements at or before the tile's first row and holds
// 4 more; the consumers skip (bh * S + q0) % 4 of them. A box past a
// head's S reads the next head's first rows, which the mask drops.
// Warpgroups 1 and 2 are the consumers, each owning 64 of the 128 keys;
// per q tile (64 queries i), all products wgmma m64n64k16:
//
//   S^T  = K . Q^T   and   dP^T = V . dO^T   (both operands in shared
//          memory, K-major), issued together, dP^T running under the exp
//   P^T  = exp2(S^T * scale * log2(e) - lse_i * log2(e)), the mask
//          key <= i < S only on the q tile that crosses this warpgroup's
//          diagonal and on one that crosses S (a q tile wholly above the
//          diagonal is skipped)
//   dV  += P^T . dO  (P^T rounded to bf16 as the register A operand: the
//          m64nN accumulator layout is the register-A fragment layout; dO
//          MN-major, the transpose bit), running under dS^T
//   dS^T = P^T * (dP^T - D_i), rounded to bf16
//   dK  += dS^T . Q  (the same register-A form)
//
// then the stage goes back to the producer once both products have
// completed. The epilogue writes dK * scale and dV as bf16 rows; each
// element is written by one thread and every sum runs in a fixed order
// (no atomics), so two launches are bit-identical. A consumer thread
// holds dK, dV, S^T/P^T, dP^T (32 f32 each) and the two A operands (16
// registers each); setmaxnreg moves registers from the producer to the
// consumers.

constexpr int kDkvBN = 128;  // keys of a work tile: two consumer warpgroups
constexpr int kDkvBM = 64;   // queries of a ring stage
constexpr int kDkvStages = 4;
constexpr int kDkvStatBox = kDkvBM + 4;  // a 16-byte aligned row-stat box
constexpr int kDkvStatPitch = 96;        // its slot: 384 bytes
constexpr uint32_t kDkvKVBytes = kDkvBN * kHd * sizeof(bf16);  // 16 KB
constexpr uint32_t kDkvStageBytes =
    2 * kDkvBM * kHd * sizeof(bf16) + 2 * kDkvStatBox * sizeof(float);

struct DkvSmem {  // every bf16 tile starts on a 1024-byte swizzle period
  bf16 k[2][kDkvBN * kHd];
  bf16 v[2][kDkvBN * kHd];
  bf16 q[kDkvStages][kDkvBM * kHd];
  bf16 dout[kDkvStages][kDkvBM * kHd];
  float lse[kDkvStages][kDkvStatPitch];  // slots on 128-byte boundaries
  float dd[kDkvStages][kDkvStatPitch];
  uint64_t kv_full[2];
  uint64_t kv_empty[2];
  uint64_t full[kDkvStages];
  uint64_t empty[kDkvStages];
};
constexpr int kDkvSmemBytes = sizeof(DkvSmem) + 1024;  // + alignment slack

// the work tile of round n of this CTA: the grid walks the heaviest-first
// list forwards on even rounds and backwards on odd ones
__device__ __forceinline__ int dkv_tile(int n) {
  return n * gridDim.x +
         ((n & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
}

// grid: one persistent CTA per SM (at most the work-tile count); block
// kFwdThreads; dynamic shared memory kDkvSmemBytes
__global__ void __launch_bounds__(kFwdThreads, 1)
dkv_bf16(const __grid_constant__ CUtensorMap tq,
         const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv,
         const __grid_constant__ CUtensorMap tdo,
         const __grid_constant__ CUtensorMap tlse,
         const __grid_constant__ CUtensorMap tdd, bf16* __restrict__ dk_out,
         bf16* __restrict__ dv_out, int S, int BH, float scale) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int nq = (S + kDkvBM - 1) / kDkvBM;
  const int n_tiles = (S + kDkvBN - 1) / kDkvBN * BH;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.kv_full[b], 1);
      mbar_init(&sm.kv_empty[b], 8);  // one arrival per consumer warp
    }
#pragma unroll
    for (int st = 0; st < kDkvStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every copy. Work tile n uses
    // K/V buffer n & 1; the ring's q tiles are counted across work tiles
    // (it), and so are the stages and their phases.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int n = 0;; ++n) {
        const int t = dkv_tile(n);
        if (t >= n_tiles) break;
        const int kt = t / BH, bh = t % BH, b = n & 1;
        // the buffer's previous work tile has read K and V (the first
        // two pass)
        mbar_wait(&sm.kv_empty[b], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&sm.kv_full[b], 2 * kDkvKVBytes);
        tma_load(sm.k[b], &tk, &sm.kv_full[b], kt * kDkvBN, bh);
        tma_load(sm.v[b], &tv, &sm.kv_full[b], kt * kDkvBN, bh);
        for (int qi = 2 * kt; qi < nq; ++qi, ++it) {
          const int st = it % kDkvStages, q0 = qi * kDkvBM;
          mbar_wait(&sm.empty[st], ((it / kDkvStages) & 1) ^ 1);
          mbar_expect_tx(&sm.full[st], kDkvStageBytes);
          tma_load(sm.q[st], &tq, &sm.full[st], q0, bh);
          tma_load(sm.dout[st], &tdo, &sm.full[st], q0, bh);
          const int x = (bh * S + q0) & ~3;  // a 16-byte boundary
          tma_load_1d(sm.lse[st], &tlse, &sm.full[st], x);
          tma_load_1d(sm.dd[st], &tdd, &sm.full[st], x);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t0 = threadIdx.x - 128;
    const int cw = t0 >> 7;  // consumer warpgroup: keys [64 cw, 64 cw + 64)
    const int warp = (t0 >> 5) & 3, lane = t0 & 31;
    const int g = lane >> 2, tg = lane & 3;
    const float sl2 = scale * kLog2e;
    // hand a barrier's slot back to the producer, once per warp
    auto arrive = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    int it = 0;
    for (int n = 0;; ++n) {
      const int t = dkv_tile(n);
      if (t >= n_tiles) break;
      const int kt = t / BH, bh = t % BH, b = n & 1;
      const int kb = kt * kDkvBN + 64 * cw;  // this warpgroup's first key
      const int key[2] = {kb + 16 * warp + g, kb + 16 * warp + g + 8};
      const uint64_t dka = sw128_desc(sm.k[b] + 64 * cw * kHd, 16, 1024);
      const uint64_t dva = sw128_desc(sm.v[b] + 64 * cw * kHd, 16, 1024);
      float dk[32], dv[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
      mbar_wait(&sm.kv_full[b], (n >> 1) & 1);

      for (int qi = 2 * kt; qi < nq; ++qi, ++it) {
        const int st = it % kDkvStages, q0 = qi * kDkvBM;
        // waited for even when skipped below: a release before the fill
        // would count toward the stage's previous phase, while the other
        // warpgroup may still read it
        mbar_wait(&sm.full[st], (it / kDkvStages) & 1);
        if (q0 + kDkvBM <= kb) {  // every query before every key
          arrive(&sm.empty[st]);
          continue;
        }
        // S^T = K . Q^T and dP^T = V . dO^T: two groups
        float s[32], dp[32];
        const uint64_t dqk = sw128_desc(sm.q[st], 16, 1024);
        const uint64_t ddk = sw128_desc(sm.dout[st], 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // +32 bytes per 16 head dims
          wgmma_qk64(s, dka + 2 * kk, dqk + 2 * kk, kk);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_qk64(dp, dva + 2 * kk, ddk + 2 * kk, kk);
        wgmma_commit();
        wgmma_wait_one();  // S^T
        fence_regs(s);

        // P^T: row key[c >> 1], column (query) i = q0 + 8 j + 2 tg + (c & 1)
        const int skip = (bh * S + q0) & 3;  // the box's rows before q0
        const float* lse_s = sm.lse[st] + skip;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int ci = 8 * j + 2 * tg + (c & 1);
            s[4 * j + c] = ex2(fmaf(s[4 * j + c], sl2, -lse_s[ci] * kLog2e));
          }
        if (q0 < kb + 64 || q0 + kDkvBM > S) {
          // the q tile crosses this warpgroup's diagonal or S
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int r = c >> 1, i = q0 + 8 * j + 2 * tg + (c & 1);
              const bool ok = key[r] <= i && i < S;
              if (!ok) s[4 * j + c] = 0.f;
            }
        }
        // dV += P^T . dO, P^T rounded to bf16: 16 queries per k step
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pa[kk][0] = pack(s[8 * kk + 0], s[8 * kk + 1]);
          pa[kk][1] = pack(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack(s[8 * kk + 6], s[8 * kk + 7]);
        }
        const uint64_t dom = sw128_desc(sm.dout[st], 1024, 1024);
        fence_regs(dv);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // +2048 bytes per 16 queries
          wgmma_pv(dv, pa[kk], dom + 128 * kk);
        wgmma_commit();
        wgmma_wait_one();  // dP^T
        fence_regs(dp);

        // dS^T = P^T * (dP^T - D_i), then dK += dS^T . Q
        const float* dd_s = sm.dd[st] + skip;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int ci = 8 * j + 2 * tg + (c & 1);
            s[4 * j + c] = s[4 * j + c] * (dp[4 * j + c] - dd_s[ci]);
          }
        uint32_t da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          da[kk][0] = pack(s[8 * kk + 0], s[8 * kk + 1]);
          da[kk][1] = pack(s[8 * kk + 2], s[8 * kk + 3]);
          da[kk][2] = pack(s[8 * kk + 4], s[8 * kk + 5]);
          da[kk][3] = pack(s[8 * kk + 6], s[8 * kk + 7]);
        }
        const uint64_t dqm = sw128_desc(sm.q[st], 1024, 1024);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_pv(dk, da[kk], dqm + 128 * kk);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);  // the two groups read pa and da until here
        fence_regs(da);
        arrive(&sm.empty[st]);
      }
      arrive(&sm.kv_empty[b]);  // the work tile's last read of K and V

      const size_t base = (size_t)bh * S * kHd;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (key[r] >= S) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const size_t at = base + (size_t)key[r] * kHd + 8 * j + 2 * tg;
          *reinterpret_cast<__nv_bfloat162*>(dk_out + at) =
              __floats2bfloat162_rn(dk[4 * j + 2 * r] * scale,
                                    dk[4 * j + 2 * r + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv_out + at) =
              __floats2bfloat162_rn(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// -- f32 kernels ----------------------------------------------------------------
//
// Two threads per row: thread half h owns head dims h, h + 2, ..., h + 62
// (the pair reads neighbouring words of a shared row: no bank conflict).

typedef float TileF[kTile][kHd];

__device__ __forceinline__ void load_tile_f32(TileF& dst, const float* src,
                                              int row0, int S) {
  for (int i = threadIdx.x; i < kTile * (kHd / 4); i += kThreads) {
    const int r = i / (kHd / 4), c = (i % (kHd / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S)
      val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * kHd +
                                             c);
    *reinterpret_cast<float4*>(&dst[r][c]) = val;
  }
}

__device__ __forceinline__ void load_row_f32(float (&x)[kHd / 2],
                                             const float* src, int row, int S,
                                             int h) {
#pragma unroll
  for (int d = 0; d < kHd / 2; ++d)
    x[d] = row < S ? src[(size_t)row * kHd + 2 * d + h] : 0.f;
}

// the full dot product of a row half-held by each thread of a pair with a
// shared-memory row
__device__ __forceinline__ float pair_dot(const float (&x)[kHd / 2],
                                          const float* t, int h) {
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < kHd / 2; ++i) d = fmaf(x[i], t[2 * i + h], d);
  return d + __shfl_xor_sync(0xffffffffu, d, 1);
}

__device__ __forceinline__ void store_row_f32(float* dst,
                                              const float (&x)[kHd / 2],
                                              float mul, int row, int S,
                                              int h) {
  if (row >= S) return;
#pragma unroll
  for (int d = 0; d < kHd / 2; ++d) dst[(size_t)row * kHd + 2 * d + h] = x[d] * mul;
}

__global__ void __launch_bounds__(kThreads) fwd_f32(Args p) {
  __shared__ __align__(16) TileF Ks, Vs;
  const int S = p.S, bh = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x, q0 = qt * kTile;
  const size_t base = (size_t)bh * S * kHd;
  const float* K = static_cast<const float*>(p.k) + base;
  const float* V = static_cast<const float*>(p.v) + base;
  const int h = threadIdx.x & 1, row = q0 + (threadIdx.x >> 1);
  float qr[kHd / 2], acc[kHd / 2];
  load_row_f32(qr, static_cast<const float*>(p.q) + base, row, S, h);
#pragma unroll
  for (int d = 0; d < kHd / 2; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile_f32(Ks, K, k0, S);
    load_tile_f32(Vs, V, k0, S);
    __syncthreads();
    float s[kTile];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float d = pair_dot(qr, Ks[j], h);
      const int col = k0 + j;
      s[j] = (col <= row && col < S) ? d * p.scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
    const float alpha = expf(m - m_safe);
    m = m_safe;
    float sum = 0.f;
#pragma unroll
    for (int d = 0; d < kHd / 2; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int col = k0 + j;
      const float pj = (col <= row && col < S) ? expf(s[j] - m) : 0.f;
      sum += pj;
#pragma unroll
      for (int d = 0; d < kHd / 2; ++d) acc[d] = fmaf(pj, Vs[j][2 * d + h], acc[d]);
    }
    l = l * alpha + sum;
  }
  const float lc = fmaxf(l, 1e-20f);
  if (h == 0 && row < S) p.lse_out[(size_t)bh * S + row] = m + logf(lc);
#pragma unroll
  for (int d = 0; d < kHd / 2; ++d) acc[d] = acc[d] / lc;
  store_row_f32(static_cast<float*>(p.out) + base, acc, 1.f, row, S, h);
}

__global__ void __launch_bounds__(kThreads) dq_f32(Args p) {
  __shared__ __align__(16) TileF Ks, Vs;
  const int S = p.S, bh = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x, q0 = qt * kTile;
  const size_t base = (size_t)bh * S * kHd;
  const float* K = static_cast<const float*>(p.k) + base;
  const float* V = static_cast<const float*>(p.v) + base;
  const int h = threadIdx.x & 1, row = q0 + (threadIdx.x >> 1);
  float qr[kHd / 2], dor[kHd / 2], acc[kHd / 2];
  load_row_f32(qr, static_cast<const float*>(p.q) + base, row, S, h);
  load_row_f32(dor, static_cast<const float*>(p.dout) + base, row, S, h);
#pragma unroll
  for (int d = 0; d < kHd / 2; ++d) acc[d] = 0.f;
  const float lse = row < S ? p.lse[(size_t)bh * S + row] : 0.f;
  const float dd = row < S ? p.delta[(size_t)bh * S + row] : 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile_f32(Ks, K, k0, S);
    load_tile_f32(Vs, V, k0, S);
    __syncthreads();
    for (int j = 0; j < kTile; ++j) {
      const float s = pair_dot(qr, Ks[j], h);
      const float dp = pair_dot(dor, Vs[j], h);
      const int col = k0 + j;
      const float pr = (col <= row && col < S) ? expf(s * p.scale - lse) : 0.f;
      const float ds = pr * (dp - dd);
#pragma unroll
      for (int d = 0; d < kHd / 2; ++d) acc[d] = fmaf(ds, Ks[j][2 * d + h], acc[d]);
    }
  }
  store_row_f32(static_cast<float*>(p.dq) + base, acc, p.scale, row, S, h);
}

__global__ void __launch_bounds__(kThreads) dkv_f32(Args p) {
  __shared__ __align__(16) TileF Qs, dOs;
  __shared__ float lse_s[kTile], dd_s[kTile];
  const int S = p.S, bh = blockIdx.y;
  const int kt = blockIdx.x, k0 = kt * kTile;
  const int n_q = (S + kTile - 1) / kTile;
  const size_t base = (size_t)bh * S * kHd;
  const float* Q = static_cast<const float*>(p.q) + base;
  const float* dO = static_cast<const float*>(p.dout) + base;
  const int h = threadIdx.x & 1, key = k0 + (threadIdx.x >> 1);
  float kr[kHd / 2], vr[kHd / 2], dk[kHd / 2], dv[kHd / 2];
  load_row_f32(kr, static_cast<const float*>(p.k) + base, key, S, h);
  load_row_f32(vr, static_cast<const float*>(p.v) + base, key, S, h);
#pragma unroll
  for (int d = 0; d < kHd / 2; ++d) dk[d] = dv[d] = 0.f;

  for (int qt = kt; qt < n_q; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile_f32(Qs, Q, q0, S);
    load_tile_f32(dOs, dO, q0, S);
    if (threadIdx.x < kTile) {
      const int i = q0 + threadIdx.x;
      lse_s[threadIdx.x] = i < S ? p.lse[(size_t)bh * S + i] : 0.f;
      dd_s[threadIdx.x] = i < S ? p.delta[(size_t)bh * S + i] : 0.f;
    }
    __syncthreads();
    for (int ci = 0; ci < kTile; ++ci) {
      const int i = q0 + ci;
      const float s = pair_dot(kr, Qs[ci], h);
      const float dp = pair_dot(vr, dOs[ci], h);
      const float pr = (key <= i && i < S) ? expf(s * p.scale - lse_s[ci]) : 0.f;
      const float ds = pr * (dp - dd_s[ci]);
#pragma unroll
      for (int d = 0; d < kHd / 2; ++d) {
        dv[d] = fmaf(pr, dOs[ci][2 * d + h], dv[d]);
        dk[d] = fmaf(ds, Qs[ci][2 * d + h], dk[d]);
      }
    }
  }
  store_row_f32(static_cast<float*>(p.dk) + base, dk, p.scale, key, S, h);
  store_row_f32(static_cast<float*>(p.dv) + base, dv, 1.f, key, S, h);
}

int check_args(int dtype, int BH, int S, int hd) {
  if (hd != kHd || BH < 1 || BH > 65535 || S < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// cuTensorMapEncodeTiled from the driver, reached through the runtime
// (the library links no libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a 3-D map over a bf16 [BH, S, 64] tensor, boxes of `rows` rows of one
// head, 128-byte swizzle; rows past S load as zeros
cudaError_t head_map(CUtensorMap* map, const void* base, int BH, int S,
                     int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)kHd, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {kHd * sizeof(bf16),
                                 (cuuint64_t)S * kHd * sizeof(bf16)};
  const cuuint32_t box[3] = {(cuuint32_t)kHd, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a 1-D map over an f32 row statistic [BH * S] (lse or D), boxes of
// kDkvStatBox elements; elements past BH * S load as zeros
cudaError_t stats_map(CUtensorMap* map, const void* base, int BH, int S) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[1] = {(cuuint64_t)BH * (cuuint64_t)S};
  const cuuint64_t strides[1] = {0};  // a rank-1 map has no stride
  const cuuint32_t box[1] = {(cuuint32_t)kDkvStatBox};
  const cuuint32_t elem[1] = {1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t sm_count(int* sms) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

cudaError_t launch_fwd_bf16(const void* q, const void* k, const void* v,
                            void* out, void* lse, int BH, int S, float scale,
                            cudaStream_t stream) {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmemBytes);
  if (allowed != cudaSuccess) return allowed;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  int sms;
  if ((err = head_map(&tq, q, BH, S, kFwdBM)) != cudaSuccess ||
      (err = head_map(&tk, k, BH, S, kFwdBN)) != cudaSuccess ||
      (err = head_map(&tv, v, BH, S, kFwdBN)) != cudaSuccess ||
      (err = sm_count(&sms)) != cudaSuccess)
    return err;
  const int tiles = (S + kFwdBM - 1) / kFwdBM * BH;
  fwd_bf16<<<tiles < sms ? tiles : sms, kFwdThreads, kFwdSmemBytes,
             stream>>>(tq, tk, tv, static_cast<bf16*>(out),
                       static_cast<float*>(lse), S, BH, scale);
  return cudaGetLastError();
}

cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int BH,
                            int S, float scale, cudaStream_t stream) {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      dkv_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmemBytes);
  if (allowed != cudaSuccess) return allowed;
  CUtensorMap tq, tk, tv, tdo, tlse, tdd;
  cudaError_t err;
  int sms;
  if ((err = head_map(&tq, q, BH, S, kDkvBM)) != cudaSuccess ||
      (err = head_map(&tdo, dout, BH, S, kDkvBM)) != cudaSuccess ||
      (err = head_map(&tk, k, BH, S, kDkvBN)) != cudaSuccess ||
      (err = head_map(&tv, v, BH, S, kDkvBN)) != cudaSuccess ||
      (err = stats_map(&tlse, lse, BH, S)) != cudaSuccess ||
      (err = stats_map(&tdd, delta, BH, S)) != cudaSuccess ||
      (err = sm_count(&sms)) != cudaSuccess)
    return err;
  const int tiles = (S + kDkvBN - 1) / kDkvBN * BH;
  dkv_bf16<<<tiles < sms ? tiles : sms, kFwdThreads, kDkvSmemBytes,
             stream>>>(tq, tk, tv, tdo, tlse, tdd, static_cast<bf16*>(dk),
                       static_cast<bf16*>(dv), S, BH, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the outputs share
// it); q, k, v, dout, out, dq, dk, dv are [BH, S, 64] contiguous; lse and
// delta [BH, S] float32. Each returns the launch's cudaError_t (0 on
// success) and allocates nothing.
int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                     void* lse, int dtype, int BH, int S, int hd, float scale,
                     void* stream) {
  if (int e = check_args(dtype, BH, S, hd)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)launch_fwd_bf16(q, k, v, out, lse, BH, S, scale, s);
  Args a = {q, k, v, nullptr, nullptr, nullptr, out, static_cast<float*>(lse),
            nullptr, nullptr, nullptr, S, scale};
  const dim3 grid((S + kTile - 1) / kTile, BH);
  fwd_f32<<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int dtype, int BH, int S, int hd,
                        float scale, void* stream) {
  if (int e = check_args(dtype, BH, S, hd)) return e;
  Args a = {q, k, v, dout, static_cast<const float*>(lse),
            static_cast<const float*>(delta), nullptr, nullptr, dq, nullptr,
            nullptr, S, scale};
  const dim3 grid((S + kTile - 1) / kTile, BH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    dq_bf16<<<grid, kThreads, 0, s>>>(a);
  else
    dq_f32<<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int dtype, int BH, int S, int hd,
                         float scale, void* stream) {
  if (int e = check_args(dtype, BH, S, hd)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_dkv_bf16(q, k, v, dout, lse, delta, dk, dv, BH, S,
                                scale, s);
  Args a = {q, k, v, dout, static_cast<const float*>(lse),
            static_cast<const float*>(delta), nullptr, nullptr, nullptr, dk,
            dv, S, scale};
  const dim3 grid((S + kTile - 1) / kTile, BH);
  dkv_f32<<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// the bf16 forward's and dK/dV's dynamic shared memory a CTA (rings, the
// tiles held for a whole work tile, the barriers), for the build report
int flash_fwd_smem_bytes() { return kFwdSmemBytes; }
int flash_dkv_smem_bytes() { return kDkvSmemBytes; }

const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
