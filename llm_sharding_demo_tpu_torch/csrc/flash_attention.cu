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
// Design (simple and right first; wgmma, TMA and warp specialisation are
// later work):
//
// - bf16: one block of 4 warps per (b*h, 64-row tile); each warp owns 16
//   rows and runs mma.sync m16n8k16 bf16 tiles with f32 accumulators. Q
//   (and dO) fragments stay in registers for the whole loop; K/V (or Q/dO
//   for dK/dV) tiles of 64 rows are staged in shared memory with a
//   144-byte row stride, so every fragment load is free of bank
//   conflicts. The online-softmax state (m, l) and the output accumulator
//   live in registers. As in FlashAttention-2, P is rounded to bf16
//   before the P.V product and dS to bf16 before the dS.K and dS^T.Q
//   products; l and every sum stay f32. The tests and chip_smoke.py hold
//   the bf16 kernels to a tolerance that covers these roundings.
// - f32: the same tiles with scalar f32 arithmetic (no TF32: the JAX
//   kernel casts everything to f32), two threads per row, each owning the
//   even or the odd head dims; dot products are completed with one
//   shuffle.
// - Causality: the forward and dQ walk the k tiles up to the diagonal
//   (tile index <= q tile), dK/dV the q tiles from the diagonal to the
//   end; tiles above the diagonal are never read. The mask j <= i, j < S
//   inside a tile also covers a ragged last tile (rows past S load as
//   zeros and are never written), so any S works.
// - Each output element is written by exactly one thread and summed in a
//   fixed order: no atomics, so two launches are bit-identical.
// - Blocks with the most tiles start first (the forward and dQ grids run
//   the q tiles in reverse, dK/dV the k tiles in order).

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

__global__ void __launch_bounds__(kThreads) fwd_bf16(Args p) {
  __shared__ __align__(16) Tile Qs, Ks, Vs;
  const int S = p.S, bh = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x, q0 = qt * kTile;
  const size_t base = (size_t)bh * S * kHd;
  const bf16* Q = static_cast<const bf16*>(p.q) + base;
  const bf16* K = static_cast<const bf16*>(p.k) + base;
  const bf16* V = static_cast<const bf16*>(p.v) + base;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3, wr = warp * 16;

  load_tile(Qs, Q, q0, S);
  __syncthreads();
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) frag_a(qa[kk], Qs, wr, kk * 16, g, tg);

  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile(Ks, K, k0, S);
    load_tile(Vs, V, k0, S);
    __syncthreads();
    float s[8][4];
    rows_dot_tile(s, qa, Ks, g, tg);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1, col = k0 + nt * 8 + 2 * tg + (c & 1);
        const bool ok = col <= row[r] && col < S;
        s[nt][c] = ok ? s[nt][c] * p.scale : kNegInf;
        mx[r] = fmaxf(mx[r], s[nt][c]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      // a row with nothing visible yet keeps its max at NEG_INF: shift to
      // 0 so that exp() underflows to exactly 0 (the JAX kernel's m_safe)
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      alpha[r] = expf(m[r] - m_safe);
      m[r] = m_safe;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1, col = k0 + nt * 8 + 2 * tg + (c & 1);
        const bool ok = col <= row[r] && col < S;
        s[nt][c] = ok ? expf(s[nt][c] - m[r]) : 0.f;
        sum[r] += s[nt][c];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }
    c_times_tile(o, s, Vs, g, tg);  // P rounded to bf16 here
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = fmaxf(l[r], 1e-20f);  // causal rows always see themselves
    if (tg == 0 && row[r] < S)
      p.lse_out[(size_t)bh * S + row[r]] = m[r] + logf(l[r]);
  }
  // out = acc / l, as the JAX kernel divides (not a multiply by 1 / l)
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nt][c] = o[nt][c] / l[c >> 1];
  store_rows(static_cast<bf16*>(p.out) + base, o, q0 + wr, 1.f, S, g, tg);
}

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

__global__ void __launch_bounds__(kThreads) dkv_bf16(Args p) {
  __shared__ __align__(16) Tile T0, T1;
  __shared__ float lse_s[kTile], dd_s[kTile];
  const int S = p.S, bh = blockIdx.y;
  const int kt = blockIdx.x, k0 = kt * kTile;
  const int n_q = (S + kTile - 1) / kTile;
  const size_t base = (size_t)bh * S * kHd;
  const bf16* Q = static_cast<const bf16*>(p.q) + base;
  const bf16* K = static_cast<const bf16*>(p.k) + base;
  const bf16* V = static_cast<const bf16*>(p.v) + base;
  const bf16* dO = static_cast<const bf16*>(p.dout) + base;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3, wr = warp * 16;

  load_tile(T0, K, k0, S);
  load_tile(T1, V, k0, S);
  __syncthreads();
  uint32_t ka[4][4], va[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    frag_a(ka[kk], T0, wr, kk * 16, g, tg);
    frag_a(va[kk], T1, wr, kk * 16, g, tg);
  }
  const int key[2] = {k0 + wr + g, k0 + wr + g + 8};
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[nt][c] = dv[nt][c] = 0.f;

  for (int qt = kt; qt < n_q; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile(T0, Q, q0, S);
    load_tile(T1, dO, q0, S);
    if (threadIdx.x < kTile) {
      const int i = q0 + threadIdx.x;
      lse_s[threadIdx.x] = i < S ? p.lse[(size_t)bh * S + i] : 0.f;
      dd_s[threadIdx.x] = i < S ? p.delta[(size_t)bh * S + i] : 0.f;
    }
    __syncthreads();
    // transposed scores: a warp's 16 keys against the tile's 64 queries
    float pt[8][4], dpt[8][4];
    rows_dot_tile(pt, ka, T0, g, tg);  // K . Q^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1, ci = nt * 8 + 2 * tg + (c & 1), i = q0 + ci;
        const bool ok = key[r] <= i && i < S;
        pt[nt][c] = ok ? expf(pt[nt][c] * p.scale - lse_s[ci]) : 0.f;
      }
    c_times_tile(dv, pt, T1, g, tg);    // P^T (rounded to bf16) . dO
    rows_dot_tile(dpt, va, T1, g, tg);  // V . dO^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ci = nt * 8 + 2 * tg + (c & 1);
        pt[nt][c] = pt[nt][c] * (dpt[nt][c] - dd_s[ci]);  // dS^T
      }
    c_times_tile(dk, pt, T0, g, tg);  // dS^T (rounded to bf16) . Q
  }
  store_rows(static_cast<bf16*>(p.dk) + base, dk, k0 + wr, p.scale, S, g,
             tg);
  store_rows(static_cast<bf16*>(p.dv) + base, dv, k0 + wr, 1.f, S, g, tg);
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
  Args a = {q, k, v, nullptr, nullptr, nullptr, out, static_cast<float*>(lse),
            nullptr, nullptr, nullptr, S, scale};
  const dim3 grid((S + kTile - 1) / kTile, BH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    fwd_bf16<<<grid, kThreads, 0, s>>>(a);
  else
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
  Args a = {q, k, v, dout, static_cast<const float*>(lse),
            static_cast<const float*>(delta), nullptr, nullptr, nullptr, dk,
            dv, S, scale};
  const dim3 grid((S + kTile - 1) / kTile, BH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    dkv_bf16<<<grid, kThreads, 0, s>>>(a);
  else
    dkv_f32<<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
