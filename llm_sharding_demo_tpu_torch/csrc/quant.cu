// Weight-only int8 decode matmuls: the block linear and the tied LM head.
//
// Replaces the two Pallas kernels of the JAX package's int8 path:
//
// - quant_linear_kernel <- llm_sharding_demo_tpu/ops/quant.py::
//   _linear_kernel (via _pallas_linear):
//     y[r, o] = round_to_bf16( (sum_k float(x[r, k]) * float(W[k, o]))
//                              * float(scale[o]) )
//   x [rows, d] in bf16, W int8 [d, out], scale [out] in bf16, rows <= 16.
//   f32 accumulation, one rounding to bf16 at the end.
// - quant_head_kernel <- llm_sharding_demo_tpu/ops/quant.py::_head_kernel
//   (via _pallas_head):
//     logits[r, v] = sum_k float(x[r, k]) * float(Q[v, k])      (f32 out)
//   x [rows, d] in bf16 with wte's per-d scale already folded in by the
//   caller, Q the int8 [V_pad, d] table (V_pad a multiple of 2048).
//
// What bounds them on the card: bytes. At rows <= 16 each weight byte
// takes part in at most 16 multiply-adds, two orders of magnitude below
// Hopper's balance point, so what matters is streaming the int8 weights
// once, with enough loads in flight to cover the memory latency, and
// never materialising a dequantised copy (the JAX package measured that
// a convert-then-dot form writes and re-reads the widened weights). Both
// kernels read each weight byte once and convert it in registers:
//
// - linear: at llama's untied head (768 -> 32000) it must stream 24.6 MB,
//   7.4 us at 3.35 TB/s. At 16 rows its 786 MFLOP would take ~12 us on
//   the f32 CUDA cores, above that bound, so the products run on the
//   tensor cores. The launch plan is ops/quant.py::linear_plan's: a CTA
//   owns bn output columns (128, or 64 where that puts more CTAs to
//   work) and one of `split` equal slices of the contraction, and the
//   split CTAs of a column tile form one cluster (grid (split, n / bn),
//   cluster (split, 1, 1), up to 16 CTAs, non-portable above 8). split
//   is 1 where the column tiles already fill the card (the head);
//   elsewhere it grows until the grid reaches one wave of CTAs. Each
//   weight byte is read once for all rows. A producer warp streams the
//   CTA's slice by TMA in boxes of 16 rows by bn columns (one mma step,
//   swizzled across the box row) into a ring of 16 stages, so 32 KB a
//   CTA (at bn = 128) are in flight whatever the registers; four
//   consumer warps take the steps in turn, each stage read by one warp
//   into registers and released at once. The codes become bf16 in registers (exact: |code| <= 127)
//   and enter mma.sync m16n8k16 as its A operand, the activations, staged
//   once in shared memory, as B (one n8 tile for rows <= 8, two for up
//   to 16; rows past `rows` are zero). The f32 sums of the warps meet in
//   shared memory (the ring, swizzled, free of bank conflicts) and are
//   added in warp order. With split > 1 each rank then adds, for its
//   1/split of the tile's elements, every rank's partial sums in rank
//   order through distributed shared memory, and scales and rounds once.
//   No atomics: two launches give identical bits.
// - head: at GPT-2's table (51200 x 768) it must stream 39.3 MB, 11.8 us
//   at 3.35 TB/s; at 16 rows its 1.26 GFLOP would take ~19 us on the f32
//   CUDA cores, so it too runs on the tensor cores. The table [V_pad, d]
//   is mma.sync's row-major A operand as it lies (16 vocab rows by 16
//   codes of the contraction), the activations the column-major B, so no
//   byte transpose is needed. The grid is ops/quant.py::head_plan's: two
//   CTAs on each SM (264; one per m16 tile of a smaller table), each
//   taking a contiguous span of m16 tiles balanced to within one tile,
//   all resident at once (the launch is refused otherwise), so the table
//   streams in one wave with no tail of idle SMs. In each CTA a producer
//   warp streams the span by TMA (the linear's tensor-map encode and ring
//   helpers) in boxes of 16 vocab rows by 128 codes, swizzled over 128
//   bytes (a row is 768 bytes, so unswizzled the 8 row groups of a
//   fragment read would share banks), into 32 stages: 64 KB in flight a
//   CTA, well above the ~24 KB an SM that 3.35 TB/s over ~1 us of latency
//   asks. One CTA an SM measured 1.5x slower: its one producer thread
//   could not issue the boxes fast enough (tools/head_sweep.py). Eight
//   consumer warps each own whole tiles (warp w tiles w, w + 8, ... of
//   the span) and four stages of their own (a stage is refilled only for
//   the warp that released it, so no wait can pass on the parity of an
//   earlier fill still in flight); the producer issues a round of eight
//   tiles box column by box column, and each warp reads a box into
//   registers and releases its stage at once. A lane reads 32 contiguous
//   codes of vocab rows g and g + 8 and the 32 activations of the same
//   contraction indices (the mma's k order is free as long as A and B
//   agree), staged once in shared memory as bf16 and swizzled so those
//   reads are conflict-free; each B fragment is read once per box, not
//   once per vocab row. The 48 mmas of a tile accumulate in one f32 chain
//   (the tensor cores' own f32 sums): within atol 1e-3, rtol 1e-5 of the
//   f32 product, and faster than adding each mma's sum from a zero C
//   with an ordinary add. The f32 logits are stored from the accumulator
//   fragments (8 consecutive vocab rows a lane group, one 32-byte
//   sector). It streams ~2.2 TB/s; what holds it there is not measured
//   (more producers helped, a deeper ring or more warps did not). No
//   atomics: two launches give identical bits.
//
// Both convert int8 codes to floats with a byte permute and one add in
// place of the quarter-rate integer-to-float conversion. The activations
// are bf16 only: the int8 regime runs its activations in bf16.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRows = 16;

constexpr int kLinWarps = 4;                     // consumer warps
constexpr int kLinThreads = (kLinWarps + 1) * 32;  // and one producer warp
constexpr int kStep = 16;      // contraction rows of one mma step and box
constexpr int kStages = 16;    // boxes in flight a CTA (32 KB at 128 columns)
constexpr int kMaxSplit = 16;  // Hopper's largest (non-portable) cluster

constexpr int kHeadWarps = 8;                        // consumer warps
constexpr int kHeadThreads = (kHeadWarps + 1) * 32;  // and one producer warp
constexpr int kHeadTile = 16;    // vocab rows of an m16 tile and of a box
constexpr int kHeadBoxK = 128;   // codes of the contraction in a box
constexpr int kHeadBox = kHeadTile * kHeadBoxK;  // bytes of one stage
constexpr int kHeadStages = 32;  // boxes in flight a CTA (64 KB)
constexpr int kHeadWarpStages = kHeadStages / kHeadWarps;  // a warp's own

using bf16 = __nv_bfloat16;

// -- shared by both kernels ---------------------------------------------------

// byte J % 4 of u as an exact float, u holding four int8 codes with
// their sign bits flipped (w ^ 0x80808080), so without the (quarter-rate)
// integer-to-float conversion: byte b of the word reads b + 128 as an
// unsigned byte u, placed as the low mantissa byte of 2^23 (0x4B000000)
// it reads as 2^23 + u, and subtracting 2^23 + 128 leaves b.
template <int J>
__device__ __forceinline__ float code_at(unsigned u) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + (J & 3))) -
         8388736.0f;
}

// two floats that bf16 holds exactly, as one bf16x2 register (lo in the
// low half): their high halves
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

__device__ __forceinline__ void mma(float (&d)[4], unsigned a0, unsigned a1,
                                    unsigned a2, unsigned a3, unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

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

// the int8 box at (column col, row row) of a 2-D tensor map (weight_map:
// kStep rows by bn columns of the linear's [d, n], kHeadTile vocab rows
// by kHeadBoxK codes of the head's [V_pad, d]) into shared memory,
// completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row)
      : "memory");
}

// -- the linear ---------------------------------------------------------------

// One lane's share of a warp step: the products of the step's 16
// contraction rows by the lane's kLC = bn / 8 columns. Lane (g, t)
// (g = lane / 4, t = lane % 4) holds rows 2t, 2t+1, 2t+8, 2t+9 (i = 0..3)
// of columns kLC*g .. kLC*g + kLC-1 of the tile as words, sign bits
// flipped: u[i][c / 4] byte c % 4 is (row i, column kLC*g + c). Those are
// its A fragments of the kLC / 2 m16 tiles j (rows m = g and g + 8 <->
// columns kLC*g + j and kLC*g + kLC/2 + j); its B fragments are
// activation row g (+ 8 per n8 tile) at the same contraction rows:
// xb[nt][0] = (2t, 2t+1), xb[nt][1] = (2t+8, 2t+9).
template <int kLC, int kNT, int J>
__device__ __forceinline__ void mma_tile(float (&acc)[kLC / 2][kNT][4],
                                         const unsigned (&u)[4][kLC / 4],
                                         const uint32_t (&xb)[kNT][2]) {
  constexpr int lo = J, hi = kLC / 2 + J;
  const unsigned a0 = pack_bf16(code_at<lo>(u[0][lo / 4]),
                                code_at<lo>(u[1][lo / 4]));
  const unsigned a1 = pack_bf16(code_at<hi>(u[0][hi / 4]),
                                code_at<hi>(u[1][hi / 4]));
  const unsigned a2 = pack_bf16(code_at<lo>(u[2][lo / 4]),
                                code_at<lo>(u[3][lo / 4]));
  const unsigned a3 = pack_bf16(code_at<hi>(u[2][hi / 4]),
                                code_at<hi>(u[3][hi / 4]));
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
    mma(acc[J][nt], a0, a1, a2, a3, xb[nt][0], xb[nt][1]);
  if constexpr (J + 1 < kLC / 2) mma_tile<kLC, kNT, J + 1>(acc, u, xb);
}

// Shared-memory index of partial sum (r, c) of a [rows][kBn] tile. The
// XOR moves c inside its group of kBn / 8 columns (the columns one lane
// holds), so that the 32 lanes of one accumulator store (columns
// kLC*g + const, rows 2t + const) and 32 consecutive columns of one row
// each fall in 32 different banks.
template <int kBn>
__device__ __forceinline__ int red_index(int r, int c) {
  constexpr int kShift = kBn == 128 ? 2 : 1;  // log2(kBn / 32)
  return r * kBn + (c ^ ((c >> 5) | (((r >> 1) & 3) << kShift)));
}

// Dynamic shared memory of a launch: the ring of kStages weight boxes
// (reused for the warps' partial sums once the products are done), the
// activations [8 * kNT rows][xstride] bf16 (rows past `rows` zero) and
// the ring's full and empty barriers.
__host__ __device__ constexpr int ring_bytes(int bn) {
  return kStages * kStep * bn;
}
__host__ __device__ inline int x_stride(int kchunk) {
  // kchunk + pad == 8 (mod 64) elements: a row is 16 bytes past a
  // multiple of 128, so the B-fragment reads (rows g, words t) hit 32
  // different banks
  return kchunk + (((8 - kchunk) % 64) + 64) % 64;
}
__host__ __device__ inline int linear_smem_bytes(int bn, int kchunk,
                                                 int nt) {
  return 1024 + ring_bytes(bn) + 8 * nt * x_stride(kchunk) * 2 +
         2 * kStages * 8;
}

// grid (split, n / kBn), cluster (split, 1, 1), kLinThreads threads
// (kLinWarps consumer warps, then the producer warp), dynamic shared
// memory linear_smem_bytes(kBn, kchunk, kNT). CTA rank r of a cluster
// handles contraction rows [r * kchunk, (r + 1) * kchunk) of columns
// [blockIdx.y * kBn, + kBn); kNT n8 tiles of activation rows.
template <int kBn, int kNT>
__global__ void __launch_bounds__(kLinThreads)
quant_linear_kernel(const __grid_constant__ CUtensorMap wmap,  // [d, n]
                    const bf16* __restrict__ x,      // [rows, d]
                    const bf16* __restrict__ scale,  // [n]
                    bf16* __restrict__ y,            // [rows, n]
                    int rows, int d, int kchunk) {
  constexpr int kLC = kBn / 8;           // columns a lane holds
  constexpr int kBox = kStep * kBn;      // bytes of one stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int xstride = x_stride(kchunk);
  bf16* xs = reinterpret_cast<bf16*>(ring + ring_bytes(kBn));
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + 8 * kNT * xstride);
  uint64_t* empty = full + kStages;
  float* red = reinterpret_cast<float*>(ring);  // [kLinWarps][rows][kBn]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = gridDim.x;
  const int rank = blockIdx.x;
  const int n = (int)gridDim.y * kBn;
  const int col0 = blockIdx.y * kBn;
  const int k0 = rank * kchunk;
  const int steps = kchunk / kStep;
  const int tile = rows * kBn;
  // the elements this rank merges: [lo, hi) of its tile, consumer thread
  // i taking lo + i, lo + i + kLinWarps * 32, ... (one column each)
  const int lo = rank * tile / split, hi = (rank + 1) * tile / split;
  const bool producer = warp == kLinWarps;

  if (producer && lane == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&wmap)) : "memory");
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 1);  // the one warp that takes the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < steps && s < kStages; ++s) {
      mbar_expect_tx(&full[s], kBox);
      tma_load(ring + s * kBox, &wmap, &full[s], col0, k0 + kStep * s);
    }
  }
  float sc = 0.f;
  if (!producer) {
    sc = __bfloat162float(scale[col0 + (lo + threadIdx.x) % kBn]);
    // the activations of this slice, 16 bytes a copy
    const int vecs = kchunk / 8;
    for (int i = threadIdx.x; i < 8 * kNT * vecs; i += kLinWarps * 32) {
      const int r = i / vecs, v = i - r * vecs;
      const uint4 val =
          r < rows ? __ldg(reinterpret_cast<const uint4*>(
                         x + (size_t)r * d + k0 + 8 * v))
                   : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(xs + r * xstride + 8 * v) = val;
    }
  }
  __syncthreads();

  float acc[kLC / 2][kNT][4];
#pragma unroll
  for (int j = 0; j < kLC / 2; ++j)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;

  if (producer) {
    // the rest of the steps, each into the stage its step - kStages left
    if (lane == 0)
      for (int s = kStages; s < steps; ++s) {
        const int st = s % kStages;
        mbar_wait(&empty[st], ((s / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], kBox);
        tma_load(ring + st * kBox, &wmap, &full[st], col0, k0 + kStep * s);
      }
  } else {
    // warp w takes steps w, w + kLinWarps, ...: stage s % kStages, which
    // only warp w reads. The lane reads rows 2t + (i & 1) + 8 (i >> 1) of
    // its kLC columns through the box's swizzle (16-byte chunk c of row r
    // stored at chunk c ^ (r % 8) for 128-byte rows, c ^ (r / 2 % 4) for
    // 64-byte rows): at 128 columns the 8 lanes of each quarter warp hit
    // 8 different chunks; at 64 the 8-byte reads conflict two ways.
    for (int s = warp; s < steps; s += kLinWarps) {
      const int st = s % kStages;
      mbar_wait(&full[st], (s / kStages) & 1);
      const uint8_t* stage = ring + st * kBox;
      unsigned u[4][kLC / 4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 2 * t + (i & 1) + 8 * (i >> 1);
        if constexpr (kBn == 128) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              stage + r * kBn + 16 * (g ^ (r & 7)));
          u[i][0] = v.x ^ 0x80808080u;
          u[i][1] = v.y ^ 0x80808080u;
          u[i][2] = v.z ^ 0x80808080u;
          u[i][3] = v.w ^ 0x80808080u;
        } else {
          const uint2 v = *reinterpret_cast<const uint2*>(
              stage + r * kBn + 16 * ((g >> 1) ^ ((r >> 1) & 3)) +
              8 * (g & 1));
          u[i][0] = v.x ^ 0x80808080u;
          u[i][1] = v.y ^ 0x80808080u;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // the stage is in registers
      uint32_t xb[kNT][2];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const bf16* xr = xs + (8 * nt + g) * xstride + kStep * s + 2 * t;
        xb[nt][0] = *reinterpret_cast<const uint32_t*>(xr);
        xb[nt][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
      }
      mma_tile<kLC, kNT, 0>(acc, u, xb);
    }
  }
  __syncthreads();  // every stage read: the ring takes the partial sums

  // the warp's partial tile: c0, c1 are (column m = g, activation rows
  // 2t, 2t+1), c2, c3 the same rows of column m = g + 8
  if (!producer) {
    float* mine = red + warp * tile;
#pragma unroll
    for (int j = 0; j < kLC / 2; ++j)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * nt + 2 * t + (e & 1);
          const int c = kLC * g + (e >> 1) * (kLC / 2) + j;
          if (r < rows) mine[red_index<kBn>(r, c)] = acc[j][nt][e];
        }
  }
  __syncthreads();

  if (split == 1) {
    if (!producer)
      for (int i = threadIdx.x; i < tile; i += kLinWarps * 32) {
        const int r = i / kBn, c = i - r * kBn;
        const int k = red_index<kBn>(r, c);
        float s = red[k];
#pragma unroll
        for (int wi = 1; wi < kLinWarps; ++wi) s += red[wi * tile + k];
        y[(size_t)r * n + col0 + c] = __float2bfloat16_rn(s * sc);
      }
    return;
  }

  // the rank's partial sums, in warp order, into warp 0's slot
  if (!producer)
    for (int i = threadIdx.x; i < tile; i += kLinWarps * 32) {
      const int r = i / kBn, c = i - r * kBn;
      const int k = red_index<kBn>(r, c);
      float s = red[k];
#pragma unroll
      for (int wi = 1; wi < kLinWarps; ++wi) s += red[wi * tile + k];
      red[k] = s;
    }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  // this rank's 1/split of the tile: every rank's partial sums read from
  // its shared memory (all reads issued before the first add, so the
  // ranks cost one remote latency, not split), added in rank order,
  // scaled, rounded once
  if (!producer)
    for (int i = lo + threadIdx.x; i < hi; i += kLinWarps * 32) {
      const int r = i / kBn, c = i - r * kBn;
      const int k = red_index<kBn>(r, c);
      float v[kMaxSplit];
#pragma unroll
      for (int b = 0; b < kMaxSplit; ++b)
        if (b < split) v[b] = cluster.map_shared_rank(red, b)[k];
      float s = v[0];
#pragma unroll
      for (int b = 1; b < kMaxSplit; ++b)
        if (b < split) s += v[b];
      y[(size_t)r * n + col0 + c] = __float2bfloat16_rn(s * sc);
    }
  cluster.sync();  // keep every CTA's shared memory alive until read
}

// -- the tied head -----------------------------------------------------------

// Dynamic shared memory of a head launch: the ring of kHeadStages boxes,
// the activations [8 * kNT rows][d] bf16 (rows past `rows` zero,
// swizzled by head_x_chunk) and the ring's full and empty barriers.
__host__ __device__ inline int head_smem_bytes(int d, int nt) {
  return 1024 + kHeadStages * kHeadBox + 8 * nt * d * 2 +
         2 * kHeadStages * 8;
}

// Where 16-byte chunk c (0..15) of a 128-code block of activation row n
// is stored within the block. A lane (g, t) reads chunks 4t..4t+3 of row
// g: in each quarter warp (rows 2p, 2p+1, t = 0..3) the XORs spread one
// read over the 8 chunk positions of 128 bytes, so no two lanes share a
// bank.
__device__ __forceinline__ int head_x_chunk(int n, int c) {
  return c ^ ((c >> 3) << 1) ^ (n & 1);
}

// grid head_plan's CTAs (one wave), kHeadThreads threads (kHeadWarps
// consumer warps, then the producer warp), dynamic shared memory
// head_smem_bytes(d, kNT); the launch bounds keep the registers low
// enough for head_plan's two CTAs an SM (HEAD_CTAS_PER_SM). CTA i owns
// m16 tiles [i * tiles / ctas, (i + 1) * tiles / ctas) of the table
// (ops/quant.py::head_span); kNT n8 tiles of activation rows.
template <int kNT>
__global__ void __launch_bounds__(kHeadThreads, 2)
quant_head_kernel(const __grid_constant__ CUtensorMap qmap,  // [v, d]
                  const bf16* __restrict__ x,  // [rows, d]
                  float* __restrict__ out,     // [rows, v]
                  int rows, int d, int v) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* xs = reinterpret_cast<bf16*>(ring + kHeadStages * kHeadBox);
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + 8 * kNT * d);
  uint64_t* empty = full + kHeadStages;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kcs = d / kHeadBoxK;  // boxes a tile
  const int tiles = v / kHeadTile;
  const int lo = (int)((long long)blockIdx.x * tiles / gridDim.x);
  const int hi = (int)((long long)(blockIdx.x + 1) * tiles / gridDim.x);
  const int span = hi - lo;
  const bool producer = warp == kHeadWarps;
  const int boxes = span * kcs;

  // The ring is kHeadWarps rings of kHeadWarpStages stages, one per
  // consumer warp, so a stage is always refilled for the warp that has
  // just released it (a warp's wait on its stage's next fill then cannot
  // pass on the parity of a fill not yet landed). Warp w takes tile w of
  // each round of kHeadWarps tiles of the span (the last round may hold
  // fewer); its i-th box (round r, box column kc: i = r * kcs + kc) goes
  // to its stage i % kHeadWarpStages. The producer issues a round's boxes
  // box column by box column, so every warp has its next boxes in
  // flight. issue() loads the box at the producer's position (round pr,
  // column pkc, warp pw) and steps it on.
  int pr = 0, pkc = 0, pw = 0, pnw = min(kHeadWarps, span);
  auto issue = [&]() {
    const int i = pr * kcs + pkc;
    const int st = pw * kHeadWarpStages + i % kHeadWarpStages;
    if (i >= kHeadWarpStages)
      mbar_wait(&empty[st], ((i / kHeadWarpStages) & 1) ^ 1);
    mbar_expect_tx(&full[st], kHeadBox);
    tma_load(ring + st * kHeadBox, &qmap, &full[st], pkc * kHeadBoxK,
             (lo + pr * kHeadWarps + pw) * kHeadTile);
    if (++pw == pnw) {
      pw = 0;
      if (++pkc == kcs) {
        pkc = 0;
        ++pr;
        pnw = min(kHeadWarps, span - pr * kHeadWarps);
      }
    }
  };
  int issued = 0;
  if (producer) {
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&qmap)) : "memory");
      for (int st = 0; st < kHeadStages; ++st) {
        mbar_init(&full[st], 1);
        mbar_init(&empty[st], 1);  // the warp that owns the stage
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      // the boxes that fill an empty stage are in flight while the
      // activations are staged
      for (; issued < boxes && pr * kcs + pkc < kHeadWarpStages; ++issued)
        issue();
    }
  } else {
    // the activations, 16 bytes a copy, into their swizzled chunks
    const int vecs = d / 8;
    for (int i = threadIdx.x; i < 8 * kNT * vecs; i += kHeadWarps * 32) {
      const int r = i / vecs, q = i - r * vecs;
      const uint4 val =
          r < rows ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)r * d +
                                                          8 * q))
                   : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(xs + r * d + (q >> 4) * kHeadBoxK +
                                8 * head_x_chunk(r, q & 15)) = val;
    }
  }
  __syncthreads();

  if (producer) {
    // the rest, each once its warp has released the stage's last box
    if (lane == 0)
      for (; issued < boxes; ++issued) issue();
    return;
  }

  for (int r = 0; r * kHeadWarps + warp < span; ++r) {
    const int tile = lo + r * kHeadWarps + warp;
    float acc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    for (int kc = 0; kc < kcs; ++kc) {
      const int ib = r * kcs + kc;  // this warp's ib-th box
      const int st = warp * kHeadWarpStages + ib % kHeadWarpStages;
      // B: activation row 8 nt + g at contraction 128 kc + 32 t + m, m =
      // 0..31, as 16 bf16 pairs (word i holds m = 2i, 2i + 1)
      uint32_t xb[kNT][16];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int n = 8 * nt + g;
        const bf16* xr = xs + n * d + kc * kHeadBoxK;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint4 val = *reinterpret_cast<const uint4*>(
              xr + 8 * head_x_chunk(n, 4 * t + i));
          xb[nt][4 * i] = val.x;
          xb[nt][4 * i + 1] = val.y;
          xb[nt][4 * i + 2] = val.z;
          xb[nt][4 * i + 3] = val.w;
        }
      }
      // A: codes 32 t + m of vocab rows g (h = 0) and g + 8 (h = 1) of
      // the box, chunks 2t and 2t + 1 of the row through the swizzle
      // (16-byte chunk c of row r stored at chunk c ^ (r % 8))
      mbar_wait(&full[st], (ib / kHeadWarpStages) & 1);
      const uint8_t* box = ring + st * kHeadBox;
      unsigned u[2][8];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int row = g + 8 * h;
          const uint4 val = *reinterpret_cast<const uint4*>(
              box + row * kHeadBoxK + 16 * ((2 * t + c) ^ (row & 7)));
          u[h][4 * c] = val.x ^ 0x80808080u;
          u[h][4 * c + 1] = val.y ^ 0x80808080u;
          u[h][4 * c + 2] = val.z ^ 0x80808080u;
          u[h][4 * c + 3] = val.w ^ 0x80808080u;
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // the box is in registers
      // step j: the mma's k = 2t, 2t+1, 2t+8, 2t+9 are m = 4j .. 4j+3
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const unsigned a0 =
            pack_bf16(code_at<0>(u[0][j]), code_at<1>(u[0][j]));
        const unsigned a1 =
            pack_bf16(code_at<0>(u[1][j]), code_at<1>(u[1][j]));
        const unsigned a2 =
            pack_bf16(code_at<2>(u[0][j]), code_at<3>(u[0][j]));
        const unsigned a3 =
            pack_bf16(code_at<2>(u[1][j]), code_at<3>(u[1][j]));
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma(acc[nt], a0, a1, a2, a3, xb[nt][2 * j], xb[nt][2 * j + 1]);
      }
    }
    // c0, c1: vocab row g, activation rows 2t, 2t+1; c2, c3: vocab row
    // g + 8
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 8 * nt + 2 * t + (e & 1);
        if (row < rows)
          out[(size_t)row * v + tile * kHeadTile + g + 8 * (e >> 1)] =
              acc[nt][e];
      }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (the library links no libcuda)
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

template <int kBn, int kNT>
cudaError_t launch_linear_t(const CUtensorMap& wmap, const void* x,
                            const void* scale, void* y, int rows, int d,
                            int n, int split, cudaStream_t stream) {
  auto kernel = quant_linear_kernel<kBn, kNT>;
  // clusters above 8 CTAs are non-portable, and the ring takes more than
  // the default 48 KB of dynamic shared memory: both allowed once
  static const cudaError_t allowed = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    return e;
  }();
  if (allowed != cudaSuccess) return allowed;
  const int kchunk = d / split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, n / kBn, 1);
  cfg.blockDim = dim3(kLinThreads, 1, 1);
  cfg.dynamicSmemBytes = linear_smem_bytes(kBn, kchunk, kNT);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, wmap, static_cast<const bf16*>(x),
      static_cast<const bf16*>(scale), static_cast<bf16*>(y), rows, d,
      kchunk);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// a 2-D map over an int8 [d, n] matrix (the linear's weights, or the
// head's [V_pad, d] table with d = V_pad and n = d): boxes of kStep rows
// by bn columns, swizzled across the box row (128 or 64 bytes)
static_assert(kStep == kHeadTile, "the head's boxes are weight_map's");
cudaError_t weight_map(CUtensorMap* map, const void* w, int d, int n,
                       int bn) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)d};
  const cuuint64_t strides[1] = {(cuuint64_t)n};
  const cuuint32_t box[2] = {(cuuint32_t)bn, (cuuint32_t)kStep};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      bn == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch_linear(const void* x, const void* w, const void* scale,
                          void* y, int rows, int d, int n, int bn, int split,
                          cudaStream_t stream) {
  CUtensorMap wmap;
  const cudaError_t err = weight_map(&wmap, w, d, n, bn);
  if (err != cudaSuccess) return err;
  if (bn == 128)
    return rows <= 8 ? launch_linear_t<128, 1>(wmap, x, scale, y, rows, d,
                                               n, split, stream)
                     : launch_linear_t<128, 2>(wmap, x, scale, y, rows, d,
                                               n, split, stream);
  return rows <= 8 ? launch_linear_t<64, 1>(wmap, x, scale, y, rows, d, n,
                                            split, stream)
                   : launch_linear_t<64, 2>(wmap, x, scale, y, rows, d, n,
                                            split, stream);
}

template <int kNT>
cudaError_t launch_head_t(const CUtensorMap& qmap, const void* x, void* out,
                          int rows, int d, int v, int ctas,
                          cudaStream_t stream) {
  auto kernel = quant_head_kernel<kNT>;
  static const cudaError_t allowed = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (allowed != cudaSuccess) return allowed;
  const int smem = head_smem_bytes(d, kNT);
  // the plan is one wave: every CTA resident at once, or the launch is
  // refused
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kHeadThreads, smem);
  if (err != cudaSuccess) return err;
  if (ctas > sms * per_sm) return cudaErrorInvalidConfiguration;
  kernel<<<ctas, kHeadThreads, smem, stream>>>(
      qmap, static_cast<const bf16*>(x), static_cast<float*>(out), rows, d,
      v);
  return cudaGetLastError();
}

cudaError_t launch_head(const void* x, const void* q, void* out, int rows,
                        int d, int v, int ctas, cudaStream_t stream) {
  CUtensorMap qmap;
  const cudaError_t err = weight_map(&qmap, q, v, d, kHeadBoxK);
  if (err != cudaSuccess) return err;
  return rows <= 8
             ? launch_head_t<1>(qmap, x, out, rows, d, v, ctas, stream)
             : launch_head_t<2>(qmap, x, out, rows, d, v, ctas, stream);
}

}  // namespace

extern "C" {

// x, scale and y are bfloat16. The plan (bn, split) is
// ops/quant.py::linear_plan's. Requires 1 <= rows <= 16, bn 64 or 128
// with n % bn == 0, 1 <= split <= 16 dividing d into slices of a whole number
// of 16-row steps, the slice's activations within a block's shared
// memory, and x and w aligned to 16 bytes. Returns the cudaError_t of the
// launch or of the weights' tensor-map encode (0 on success); allocates
// nothing.
int quant_linear_launch(const void* x, const void* w, const void* scale,
                        void* y, int rows, int d, int n, int bn, int split,
                        void* stream) {
  if (rows < 1 || rows > kMaxRows || (bn != 64 && bn != 128) || n % bn ||
      split < 1 || split > kMaxSplit || d % split || (d / split) % kStep ||
      linear_smem_bytes(bn, d / split, rows <= 8 ? 1 : 2) > 227 * 1024 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)
    return (int)cudaErrorInvalidValue;
  return (int)launch_linear(x, w, scale, y, rows, d, n, bn, split,
                            static_cast<cudaStream_t>(stream));
}

// x is bfloat16; out is float32 [rows, v]. ctas is
// ops/quant.py::head_plan's. Requires 1 <= rows <= 16, d % 128 == 0,
// v % 16 == 0, 1 <= ctas <= v / 16 all resident at once, the activations
// within a block's shared memory, and x and q aligned to 16 bytes.
// Returns the cudaError_t of the launch or of the table's tensor-map
// encode (0 on success); allocates nothing.
int quant_head_launch(const void* x, const void* q, void* out, int rows,
                      int d, int v, int ctas, void* stream) {
  if (rows < 1 || rows > kMaxRows || d < kHeadBoxK || d % kHeadBoxK ||
      v < kHeadTile || v % kHeadTile || ctas < 1 || ctas > v / kHeadTile ||
      head_smem_bytes(d, rows <= 8 ? 1 : 2) > 227 * 1024 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q)) % 16)
    return (int)cudaErrorInvalidValue;
  return (int)launch_head(x, q, out, rows, d, v, ctas,
                          static_cast<cudaStream_t>(stream));
}

const char* quant_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
