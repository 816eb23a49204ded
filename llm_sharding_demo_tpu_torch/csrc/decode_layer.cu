// Whole-stack decode: one token through all L blocks in one launch, for
// the GPT-2 and the llama family (the family is a template parameter).
//
// Replaces the Pallas megakernels of the JAX package:
// llm_sharding_demo_tpu/ops/decode_layer.py::_kernel (GPT-2, called
// through _build_call / _call and decode_layers) and ::_llama_kernel
// (llama, with _rms and _rope_rows, called through _llama_call and
// decode_layers_llama). For each layer l, on the hidden state h [B, D]
// (bf16 values), GPT-2:
//
//   a    = LN1(h)                          f32 statistics, rounded to bf16
//   qkv  = mm(a, Wqkv) + bqkv              (one rounding, see mm below)
//   o    = attention(q, cache[l] rows [valid_from[b], off), self term)
//          with [k | v] written into cache[l, b, head, off]; o rounded
//   h    = h + (mm(o, Wout) + bout)        bf16 add
//   m    = LN2(h)
//   t    = gelu_new(mm(m, Wfc) + bfc)      gelu in f32 on the rounded
//                                          product, rounded again
//   h    = h + (mm(t, Wproj) + bproj)
//
// llama (no biases; H query heads share Hkv kv heads, g = H / Hkv):
//
//   a    = RMS(h)                          f32 statistics, rounded, then
//                                          * scale, rounded (HF order)
//   q, k, v = mm(a, Wq), mm(a, Wk), mm(a, Wv)   each rounded once
//   q, k = rope(q), rope(k)                rotate-half in f32 with the
//                                          row's cos/sin [B, 64]
//   o    = attention as above; query head kh * g + j reads kv head kh;
//          the self term uses the f32 rotated k; the row written is
//          [rope(k) | v] rounded
//   h    = h + mm(o, Wo)
//   m    = RMS(h)
//   t    = (gate * round(sigmoid(gate))) * up   each product rounded,
//          gate = mm(m, Wgate), up = mm(m, Wup)
//   h    = h + mm(t, Wdown)
//
// where mm(x, W) + b = round_bf16(sum_k x[k] * float(W[k, n]) (* scale[n]
// for int8 W) + bias[n]) with f32 accumulation: the JAX kernels' _matmul.
// Attention is f32 with an online softmax and the self term folded in
// last, as in csrc/decode_attention.cu. The weights are the model's
// stacked [L, ...] tensors (int8 with bf16 per-column scales, or bf16);
// activations, norm parameters, biases and the fused [L, B, Hkv, Smax,
// 128] cache are bf16; head_dim is 64 and B <= 16.
//
// What bounds it on the card: bytes. At B <= 16 each weight byte takes
// part in at most 16 multiply-adds; one step must stream every layer's
// weights (85 MB int8 for GPT-2 124M, 75 MB for llama 124M) and the live
// cache once. What the TPU kernels did with a sequential grid (carry h in
// VMEM from one layer to the next) needs a different shape here, since
// blocks run in parallel and nothing carries between them: ONE persistent
// cooperative launch, every block resident, walks the layers in a loop
// and separates the phases of a layer with grid-wide barriers (7 per
// layer):
//
//   1. QKV: every block recomputes the first norm of h into shared
//      memory, then the blocks share out (128-column tile, 64-row
//      contraction slice) tasks of the q/k/v products (one weight for
//      GPT-2, three for llama, their outputs side by side); each task
//      writes its f32 partial sums.
//   2. ATT: one block per (batch row, kv head, span of cached positions),
//      the spans sized so that the items fill the grid: it sums its q/k/v
//      partials in a fixed order (llama: for the kv head's g query heads,
//      then rotates q and k), runs the decode-attention loop (8 warps, 8
//      rows in flight per warp, f32 online softmax for each query head,
//      every cache row read once for the group) over its span and leaves
//      the span's softmax states (max, sum, 64 accumulators); the first
//      span's block also leaves the self term's states and makes the one
//      row write.
//   3. OUT: output projection tasks (32-row slices); each task first
//      merges the softmax states of its 32 attention outputs in position
//      order, the self term last.
//   4. RES1: the blocks share out h + (sum of partials) over B * D.
//   5. FC: the second norm recomputed per block, then c_fc tasks (llama:
//      gate and up side by side).
//   6. PROJ: each task sums its slice of the FC partials, applies gelu_new
//      (llama: the SwiGLU), then runs its down-projection slice.
//   7. RES2: the residual, into h for the next layer (and the output).
//
// The contraction is split so that the narrow (768-wide) outputs put
// every SM to work. The split sums are reduced in a fixed order by whoever
// consumes them, never by float atomics, so two launches on the same
// inputs give the same bits. Partials live in a workspace the wrapper
// allocates.
//
// What holds it back is latency, not the rate: a weight task moves 4-32 KB,
// less than one memory round trip of work for its SM, and each phase is a
// chain of short steps between two grid barriers. The weight bytes are
// taken off that chain, since they do not depend on the activations: a
// block's weight slices for the whole launch are fixed by blockIdx.x and
// the grid. For each layer, its QKV task's [kc x 128] slice, then OUT's,
// FC's and PROJ's (a block with no task in a phase has no entry; more
// tasks a block follow the task rule t += gridDim.x). One thread of each
// block keeps the next slices of that sequence in flight with TMA
// (cp.async.bulk.tensor, one 3-D tensor map per stacked weight, boxes of
// 128 columns x rows x 1 layer) into a ring of 16 KB shared-memory stages,
// each completing on its own mbarrier. An int8 slice takes one stage; a
// bf16 one of 128 rows two, read in row order. The first fills are issued
// at the kernel's start, so layer 0's q/k/v weights arrive under the first
// norm; a slice's stages are filled again as soon as every thread has read
// it, so the next slices stream under the current phase, its barrier,
// attention and the residual phases. The number of stages is
// ops/decode_layer.py::stage_plan's: what shared memory holds beside the
// activations at two blocks an SM. No L2 prefetch runs besides: with the
// ring's weights in flight, every thread prefetching the layer's later
// weights at the end of attention only slowed attention
// (tools/megakernel_sweep.py). A task reads its slice from the stage as it
// read it from global memory before (16 bytes, 16 int8 or 8 bf16 columns
// a thread, byte-permute int8 -> f32, each thread's rows in the same
// order), so every sum keeps its order. The activations in shared memory
// (xs) are bf16: every value they hold is a rounded bf16 value.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;       // output columns per weight task
constexpr int kRowGroup = 4;     // activation rows per register pass
constexpr int kMaxB = 16;
constexpr int kHd = 64;
constexpr int kChunk = 8;        // cache rows a warp loads before using any
constexpr int kSpanStep = kWarps * kChunk;   // rows one block round covers
constexpr int kState = kHd + 2;  // a softmax state: acc[64], max, sum
constexpr int kMaxBlocksPerSm = 2;
// contraction rows per task of each product (a multiple of the rows one
// pass of the block covers: 32 for int8, 16 for bf16 weights)
constexpr int kKcQkv = 64;
constexpr int kKcOut = 32;
constexpr int kKcFc = 128;
constexpr int kKcProj = 128;
constexpr float kNegInf = -1e30f;
constexpr int kNumWeights = 16;
// the weight ring: stages of kStageBytes, at most kMaxStages, the first
// kRingAlign-aligned in dynamic shared memory (the plan's smem_bytes
// counts the slack)
constexpr int kStageBytes = 16384;
constexpr int kMaxStages = 8;
constexpr int kRingAlign = 128;
constexpr int kWeightPhases = 4;   // QKV, OUT, FC, PROJ
// the most boxes one block reads in a layer (the launch refuses more)
constexpr int kMaxLayerBoxes = 32;
// stacked weights with a tensor map: GPT-2 c_attn, attn c_proj, c_fc,
// mlp c_proj; llama wq, wk, wv, wo, gate, up, down
constexpr int kMaxMaps = 7;

// The two families. kMaxG: query heads one attention item carries (GPT-2
// has one per kv head).
struct Gpt2 {
  static constexpr bool kLlama = false;
  static constexpr int kMaxG = 1;
};
struct Llama {
  static constexpr bool kLlama = true;
  static constexpr int kMaxG = 4;
};

// a kernel parameter (__grid_constant__): the tensor maps must sit on 64
// bytes
struct alignas(64) Params {
  // one 3-D map per stacked weight ([L, K, N], boxes of kTile columns x
  // the phase's slice rows (at most a stage) x 1 layer), kMaxMaps order
  CUtensorMap maps[kMaxMaps];
  // operands in the JAX kernel's order; scales are null for bf16 weights.
  // GPT-2: ln1 s/b, qkv w/s/b, out w/s/b, ln2 s/b, fc w/s/b, proj w/s/b.
  // llama: ln_attn s, wq w/s, wk w/s, wv w/s, wo w/s, ln_mlp s, gate w/s,
  // up w/s, down w/s.
  const void* w[kNumWeights];
  const bf16* h_in;        // [B, D]
  bf16* h_out;             // [B, D]
  bf16* kv;                // [L, B, Hkv, Smax, 2 * kHd]
  const int* valid_from;   // [B] or null
  const float* cos;        // [B, kHd] (llama) or null
  const float* sin;
  float* ws;
  int L, B, H, Hkv, D, I, Smax, off;
  int stages;              // the weight ring's (stage_plan)
  float eps;
};

// softmax-state slots per (batch row, query head): at most Smax /
// kSpanStep spans, then the self term
__host__ __device__ inline int state_slots(int Smax) {
  return Smax / kSpanStep + 2;
}

// the widths of the partial-sum rows: q, k and v side by side; the FC
// output (GPT-2: c_fc, 4D = I; llama: gate and up, 2I)
__host__ __device__ inline int qkv_width(int D, int Hkv) {
  return D + 2 * Hkv * kHd;
}
__host__ __device__ inline int fc_width(int I, bool llama) {
  return llama ? 2 * I : I;
}

// workspace layout (floats): h, hm [B, D]; the partial sums of each
// product; the attention softmax states [B, H, state_slots, kState]
struct Workspace {
  float *h, *hm, *qkv, *o, *fc, *proj, *att;
};

__host__ __device__ inline size_t workspace_floats(int B, int D, int H,
                                                   int Hkv, int I, bool llama,
                                                   int Smax) {
  const size_t bd = (size_t)B * D;
  return 2 * bd + (size_t)(D / kKcQkv) * B * qkv_width(D, Hkv) +
         (size_t)(D / kKcOut) * bd +
         (size_t)(D / kKcFc) * B * fc_width(I, llama) +
         (size_t)(I / kKcProj) * bd +
         (size_t)B * H * state_slots(Smax) * kState;
}

__device__ inline Workspace carve(float* ws, int B, int D, int Hkv, int I,
                                  bool llama) {
  const size_t bd = (size_t)B * D;
  Workspace w;
  w.h = ws;
  w.hm = w.h + bd;
  w.qkv = w.hm + bd;
  w.o = w.qkv + (size_t)(D / kKcQkv) * B * qkv_width(D, Hkv);
  w.fc = w.o + (size_t)(D / kKcOut) * bd;
  w.proj = w.fc + (size_t)(D / kKcFc) * B * fc_width(I, llama);
  w.att = w.proj + (size_t)(I / kKcProj) * bd;
  return w;
}

#ifdef DECODE_LAYERS_PHASE_CLOCK
// Per-phase clock, compiled in only with -DDECODE_LAYERS_PHASE_CLOCK (see
// llm_sharding_demo_tpu_torch/tools/megakernel_phases.py). In %globaltimer
// ns: block 0's start; at each barrier (l, k) the arrival of the last
// block and block 0's release; the last block's end in slot (L - 1, 6).
constexpr int kClockLayers = 48;
constexpr int kClockPhases = 8;
constexpr int kClockSlots = kClockLayers * kClockPhases;
__device__ unsigned long long g_clock_start;
__device__ unsigned long long g_clock_arrive[kClockSlots];
__device__ unsigned long long g_clock_release[kClockSlots];

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// the block's arrival at the end of phase k of layer l; the clock build
// stamps it (every thread of the block done)
__device__ __forceinline__ void clock_arrive(int l, int k) {
#ifdef DECODE_LAYERS_PHASE_CLOCK
  __syncthreads();
  if (threadIdx.x == 0 && l < kClockLayers)
    atomicMax(&g_clock_arrive[l * kClockPhases + k], globaltimer());
#endif
}

// the grid barrier closing phase k of layer l
__device__ __forceinline__ void phase_sync(cg::grid_group& grid, int l,
                                           int k) {
  clock_arrive(l, k);
  grid.sync();
#ifdef DECODE_LAYERS_PHASE_CLOCK
  if (blockIdx.x == 0 && threadIdx.x == 0 && l < kClockLayers)
    g_clock_release[l * kClockPhases + k] = globaltimer();
#endif
}

__device__ __forceinline__ float rnd(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float ld(const bf16* p, size_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes of weights -> floats. int8: the byte permute of csrc/quant.cu
// (b + 128 as the low mantissa byte of 2^23, minus 2^23 + 128); bf16: the
// 16 bits are a float's high half.
template <typename W>
struct Unpack;

template <>
struct Unpack<int8_t> {
  static constexpr int kCols = 16;
  __device__ __forceinline__ static void run(const int4& raw, float* out) {
    const unsigned w[4] = {(unsigned)raw.x, (unsigned)raw.y, (unsigned)raw.z,
                           (unsigned)raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned u = w[i] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[4 * i + j] =
            __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + j)) -
            8388736.0f;
    }
  }
};

template <>
struct Unpack<bf16> {
  static constexpr int kCols = 8;
  __device__ __forceinline__ static void run(const int4& raw, float* out) {
    const unsigned w[4] = {(unsigned)raw.x, (unsigned)raw.y, (unsigned)raw.z,
                           (unsigned)raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// -- the weight ring -----------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
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

// the box at (column col, row row, layer layer) of a 3-D tensor map into
// shared memory, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int layer) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(layer)
      : "memory");
}

// weight rows of type W in one stage: a box is at most this tall
template <typename W>
__host__ __device__ constexpr int box_rows() {
  return kStageBytes / (kTile * (int)sizeof(W));
}

// contraction rows per task of weight phase ph (0 QKV, 1 OUT, 2 FC, 3
// PROJ), and the stages (boxes) one of its slices takes
__host__ __device__ inline int phase_kc(int ph) {
  return ph == 0 ? kKcQkv : ph == 1 ? kKcOut : ph == 2 ? kKcFc : kKcProj;
}
template <typename W>
__host__ __device__ inline int slice_boxes(int kc) {
  return (kc + box_rows<W>() - 1) / box_rows<W>();
}

// weight phase ph's tasks: (128-column tile, contraction split) pairs,
// task t = split * tiles + tile
template <bool kLlama>
__host__ __device__ inline int phase_tiles(const Params& p, int ph) {
  const int n = ph == 0 ? qkv_width(p.D, p.Hkv)
                : ph == 2 ? fc_width(p.I, kLlama) : p.D;
  return n / kTile;
}
template <bool kLlama>
__host__ __device__ inline int phase_tasks(const Params& p, int ph) {
  return phase_tiles<kLlama>(p, ph) * ((ph == 3 ? p.I : p.D) / phase_kc(ph));
}

// the tensor map that holds column col of weight phase ph's output row;
// col becomes the column within that weight
template <bool kLlama>
__device__ inline int phase_map(const Params& p, int ph, int& col) {
  if (!kLlama) return ph;
  const int kvw = p.Hkv * kHd;
  if (ph == 0) {
    if (col < p.D) return 0;
    col -= p.D;
    if (col < kvw) return 1;
    col -= kvw;
    return 2;
  }
  if (ph == 2) {
    if (col < p.I) return 4;
    col -= p.I;
    return 5;
  }
  return ph == 1 ? 3 : 6;
}

// The block's weight ring. Its slices are the same every layer, so the
// producer lists one layer's boxes (tab: column, row, map, bytes) once, at
// the start; staging one is then a table read and two TMA instructions.
// Every thread keeps the ring's head (the stage of the next box the
// block's tasks read) and that stage's fill parity: the block reads every
// box together, so one count serves all its threads. The producer, thread
// kProducer, alone keeps the tail (the next stage to fill) and the place
// of the next box to stage (layer l, table entry k).
constexpr int kProducer = kThreads - 1;   // idle in a task's sums at B < 4
struct Ring {
  unsigned char* buf;   // stages x kStageBytes
  uint64_t* full;       // one mbarrier per stage
  const int4* tab;      // one layer's boxes, in the order they are read
  int stages, n;        // stages; boxes a layer (the producer's)
  int head, parity;     // every thread
  int tail, l, k;       // the producer
};

// the producer: stages the next box of the block's sequence into stage
// tail, then steps past it
template <typename W>
__device__ __forceinline__ void ring_stage(const Params& p, Ring& r) {
  const int4 e = r.tab[r.k];
  mbar_expect_tx(&r.full[r.tail], e.w);
  tma_load(r.buf + (size_t)r.tail * kStageBytes, &p.maps[e.z],
           &r.full[r.tail], e.x, e.y, r.l);
  if (++r.tail == r.stages) r.tail = 0;
  if (++r.k == r.n) {
    r.k = 0;
    ++r.l;
  }
}

// every thread: the block's ring over dynamic shared memory; the producer
// lists the block's boxes of a layer (weight phase by weight phase, its
// tasks t = blockIdx.x + i * gridDim.x in turn, each slice's boxes in row
// order), sets up the barriers and fills the first stages
template <typename W, typename F>
__device__ Ring ring_start(const Params& p, unsigned char* buf,
                           uint64_t* full, int4* tab) {
  Ring r;
  r.buf = buf;
  r.full = full;
  r.tab = tab;
  r.stages = p.stages;
  r.n = r.head = r.parity = r.tail = r.l = r.k = 0;
  if (threadIdx.x == kProducer) {
    for (int ph = 0; ph < kWeightPhases; ++ph) {
      const int tiles = phase_tiles<F::kLlama>(p, ph);
      const int kc = phase_kc(ph);
      const int rows = min(kc, box_rows<W>());
      for (int t = blockIdx.x; t < phase_tasks<F::kLlama>(p, ph);
           t += gridDim.x) {
        int col = (t % tiles) * kTile;
        const int map = phase_map<F::kLlama>(p, ph, col);
        for (int b = 0; b < slice_boxes<W>(kc); ++b)
          tab[r.n++] = make_int4(col, (t / tiles) * kc + b * rows, map,
                                 rows * kTile * (int)sizeof(W));
      }
    }
    for (int m = 0; m < kMaxMaps; ++m)
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&p.maps[m]))
                   : "memory");
    for (int s = 0; s < r.stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (r.n == 0) r.l = p.L;
    for (int s = 0; s < r.stages && r.l < p.L; ++s) ring_stage<W>(p, r);
  }
  __syncthreads();
  return r;
}

// every thread: box b of the block's next slice, once its fill landed
__device__ __forceinline__ const unsigned char* ring_wait(const Ring& r,
                                                          int b) {
  int s = r.head + b;
  uint32_t parity = r.parity;
  if (s >= r.stages) {
    s -= r.stages;
    parity ^= 1;
  }
  mbar_wait(&r.full[s], parity);
  return r.buf + (size_t)s * kStageBytes;
}

// every thread, once every thread has read the block's next slice (boxes
// stages): its stages take the next boxes of the sequence
template <typename W>
__device__ __forceinline__ void ring_release(const Params& p, Ring& r,
                                             int boxes) {
  r.head += boxes;
  if (r.head >= r.stages) {
    r.head -= r.stages;
    r.parity ^= 1;
  }
  if (threadIdx.x == kProducer)
    for (int b = 0; b < boxes && r.l < p.L; ++b) ring_stage<W>(p, r);
}

// One weight task: the block's next slice of the ring ([kc, kTile] of a
// layer weight, rows in one or two stages) times the activations xs
// (shared memory, row b at xs[b * ldx], already offset to the slice's
// first row). Writes the f32 partial sums to part[b * ldp + pcol0 + c]
// (this split's slice of the workspace, whose rows may hold several
// weights' outputs side by side). The order of every sum is fixed; the
// lanes' sums of a row group's absent rows (r0 + r >= B) are skipped, as
// nothing reads them. Once every thread has read the slice (the barrier
// after the last row group's products), its stages take the next boxes
// of the sequence while the warps' sums are added.
template <typename W>
__device__ void weight_task(const Params& p, Ring& ring, const bf16* xs,
                            int ldx, int kc, int B, float* part, int ldp,
                            int pcol0, float (*red)[kRowGroup][kTile]) {
  constexpr int kCpt = Unpack<W>::kCols;   // columns per thread
  constexpr int kTpr = kTile / kCpt;       // threads per weight row
  constexpr int kRpp = kThreads / kTpr;    // weight rows per pass
  constexpr int kRows = box_rows<W>();     // rows per stage
  const int boxes = slice_boxes<W>(kc);
  const unsigned char* s0 = ring_wait(ring, 0);
  const unsigned char* s1 = boxes > 1 ? ring_wait(ring, 1) : s0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cseg = (tid % kTpr) * kCpt;
  const int krow = tid / kTpr;
  for (int r0 = 0; r0 < B; r0 += kRowGroup) {
    float acc[kRowGroup][kCpt];
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r)
#pragma unroll
      for (int j = 0; j < kCpt; ++j) acc[r][j] = 0.f;
#pragma unroll 4
    for (int kk = krow; kk < kc; kk += kRpp) {
      const unsigned char* row =
          (kk < kRows ? s0 : s1) + (size_t)(kk % kRows) * kTile * sizeof(W);
      const int4 raw =
          *reinterpret_cast<const int4*>(row + cseg * sizeof(W));
      float wf[kCpt];
      Unpack<W>::run(raw, wf);
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
        if (r0 + r < B) {
          const float xv = __bfloat162float(xs[(r0 + r) * ldx + kk]);
#pragma unroll
          for (int j = 0; j < kCpt; ++j) acc[r][j] += xv * wf[j];
        }
      }
    }
    // the lanes of a warp that share columns differ by multiples of kTpr
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) {
      if (r0 + r < B) {
#pragma unroll
        for (int j = 0; j < kCpt; ++j) {
          float v = acc[r][j];
#pragma unroll
          for (int o = kTpr; o < 32; o <<= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
          acc[r][j] = v;
        }
        if (lane < kTpr) {
#pragma unroll
          for (int j = 0; j < kCpt; ++j) red[warp][r][cseg + j] = acc[r][j];
        }
      }
    }
    __syncthreads();
    if (r0 + kRowGroup >= B) ring_release<W>(p, ring, boxes);
    for (int i = tid; i < kRowGroup * kTile; i += kThreads) {
      const int r = i / kTile;
      const int c = i - r * kTile;
      if (r0 + r < B) {
        float s = 0.f;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) s += red[wi][r][c];
        part[(size_t)(r0 + r) * ldp + pcol0 + c] = s;
      }
    }
    __syncthreads();
  }
}

// the column's final value: split sums in order, * scale, + bias (if
// any), rounded. The split loads are issued kInFlight at a time before
// any is added (a load-then-add loop would wait one memory latency per
// split); absent splits add an exact 0, so the order and the bits do not
// depend on the batching.
constexpr int kInFlight = 16;
__device__ __forceinline__ float finish(const float* part, size_t split_stride,
                                        int splits, size_t idx,
                                        const bf16* scale, const bf16* bias,
                                        int col) {
  float s = 0.f;
  for (int sp0 = 0; sp0 < splits; sp0 += kInFlight) {
    float v[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j)
      v[j] = sp0 + j < splits ? part[(sp0 + j) * split_stride + idx] : 0.f;
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) s += v[j];
  }
  if (scale != nullptr) s *= ld(scale, col);
  if (bias != nullptr) s += ld(bias, col);
  return rnd(s);
}

__device__ __forceinline__ float gelu_new(float x) {
  return 0.5f * x *
         (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

// The first (or second) norm of h rows (bf16 source hb or float source hf,
// whose values are bf16 values) into xs [B][D]: the block loads all B * D
// values at once (every load in flight), then one warp per row takes the
// statistics from shared memory. GPT-2: LayerNorm with scale s and bias b,
// one rounding. llama: RMSNorm, rounded, then times s, rounded again (b
// unused).
template <bool kRms>
__device__ void norm_rows(const bf16* hb, const float* hf, const bf16* s,
                          const bf16* b, bf16* xs, int B, int D, float eps) {
  for (int i = threadIdx.x; i < B * D; i += kThreads)
    xs[i] = hb != nullptr ? hb[i] : __float2bfloat16_rn(hf[i]);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < B; r += kWarps) {
    bf16* x = xs + (size_t)r * D;
    if (kRms) {
      float sq = 0.f;
      for (int c = lane; c < D; c += 32) sq += ld(x, c) * ld(x, c);
      const float inv = rsqrtf(warp_sum(sq) / D + eps);
      for (int c = lane; c < D; c += 32)
        x[c] = __float2bfloat16_rn(rnd(ld(x, c) * inv) * ld(s, c));
    } else {
      float sum = 0.f;
      for (int c = lane; c < D; c += 32) sum += ld(x, c);
      const float mean = warp_sum(sum) / D;
      float sq = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float d = ld(x, c) - mean;
        sq += d * d;
      }
      const float inv = rsqrtf(warp_sum(sq) / D + eps);
      for (int c = lane; c < D; c += 32)
        x[c] = __float2bfloat16_rn((ld(x, c) - mean) * inv * ld(s, c) +
                                   ld(b, c));
    }
  }
  __syncthreads();
}

// folds the softmax state (m, l, a) into the running one (mf, lf, of)
__device__ __forceinline__ void merge_state(float& mf, float& lf, float& of,
                                            float m, float l, float a) {
  const float m_new = fmaxf(mf, m);
  const float ro = expf(mf - m_new), rn = expf(m - m_new);
  lf = lf * ro + l * rn;
  of = of * ro + a * rn;
  mf = m_new;
}

// the tasks of weight phase ph (QKV or FC) on the normed rows xs [B][D]:
// each of the block's tasks reads its slice from the ring and writes its
// split's partial sums, part[split][b][N] (the phase's weights side by
// side: GPT-2's one c_attn or c_fc; llama's q | k | v, gate | up)
template <typename W, typename F>
__device__ void weight_phase(const Params& p, Ring& ring, int ph,
                             const bf16* xs, float* part,
                             float (*red)[kRowGroup][kTile]) {
  const int tiles = phase_tiles<F::kLlama>(p, ph);
  const int tasks = phase_tasks<F::kLlama>(p, ph);
  const int kc = phase_kc(ph);
  const int N = tiles * kTile;
  for (int t = blockIdx.x; t < tasks; t += gridDim.x) {
    const int tile = t % tiles;
    const int split = t / tiles;
    weight_task<W>(p, ring, xs + split * kc, p.D, kc, p.B,
                      part + (size_t)split * p.B * N, N, tile * kTile, red);
  }
}

template <typename W, typename F>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSm)
decode_layers_kernel(const __grid_constant__ Params p) {
  constexpr int kG = F::kMaxG;
  constexpr bool kLlama = F::kLlama;
  // operand indices of the two families (see Params)
  constexpr int iNorm1 = 0;
  constexpr int iWo = kLlama ? 7 : 5;
  constexpr int iNorm2 = kLlama ? 9 : 8;
  constexpr int iWd = kLlama ? 14 : 13;
  // dynamic: the weight ring (p.stages x kStageBytes, kRingAlign-aligned),
  // then the activations xs [B][D] bf16
  extern __shared__ __align__(16) unsigned char dsm[];
  // rows 0..g-1: the item's query heads; kG: k; kG + 1: v
  __shared__ float qkv_s[kG + 2][kHd];
  __shared__ float sm_m[kWarps][kG], sm_l[kWarps][kG];
  __shared__ float sm_acc[kWarps][kG][kHd];
  __shared__ float red[kWarps][kRowGroup][kTile];
  __shared__ uint64_t full[kMaxStages];
  __shared__ int4 box_tab[kMaxLayerBoxes];
  cg::grid_group grid = cg::this_grid();
#ifdef DECODE_LAYERS_PHASE_CLOCK
  if (blockIdx.x == 0 && threadIdx.x == 0) g_clock_start = globaltimer();
#endif
  unsigned char* ring_buf =
      dsm + ((kRingAlign - (smem_u32(dsm) & (kRingAlign - 1))) &
             (kRingAlign - 1));
  bf16* xs = reinterpret_cast<bf16*>(ring_buf +
                                     (size_t)p.stages * kStageBytes);
  Ring ring = ring_start<W, F>(p, ring_buf, full, box_tab);

  const int B = p.B, D = p.D, H = p.H, Hkv = p.Hkv, I = p.I, off = p.off;
  const int g = H / Hkv;
  const int kvw = Hkv * kHd;
  const int nqkv = qkv_width(D, Hkv);
  const int nfc = fc_width(I, kLlama);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t bd = (size_t)B * D;
  const Workspace ws = carve(p.ws, B, D, Hkv, I, kLlama);
  const bool quantized = sizeof(W) == 1;
  const int s_qkv = D / kKcQkv, s_out = D / kKcOut, s_fc = D / kKcFc,
            s_proj = I / kKcProj;
  const int gtid = blockIdx.x * kThreads + tid;
  const int gthreads = gridDim.x * kThreads;
  // attention spans: whole block rounds of cached positions, as few
  // per (b, kv head) as fill the grid; the self term's state follows them
  const int per_bh = max(1, (int)gridDim.x / (B * Hkv));
  const int rounds = (off + kSpanStep - 1) / kSpanStep;
  const int span = max(1, (rounds + per_bh - 1) / per_bh) * kSpanStep;
  const int n_spans = max(1, (off + span - 1) / span);
  const int slots = state_slots(p.Smax);
  // the query head that is member j of kv head kh's group: query head h
  // reads kv head h / g (HF repeat_kv order)
  auto q_head = [&](int kh, int j) { return kh * g + j; };

  for (int l = 0; l < p.L; ++l) {
    auto vec = [&](int i, int width) {
      return static_cast<const bf16*>(p.w[i]) + (size_t)l * width;
    };
    auto scale = [&](int i, int width) {
      return quantized ? vec(i, width) : static_cast<const bf16*>(nullptr);
    };
    auto bias = [&](int i, int width) {
      return kLlama ? static_cast<const bf16*>(nullptr) : vec(i, width);
    };
    // the layer's input h: the caller's tensor at layer 0, else ws.h
    const bf16* hb = l == 0 ? p.h_in : nullptr;
    const float* hf = l == 0 ? nullptr : ws.h;

    // 1. QKV
    if (blockIdx.x < (nqkv / kTile) * s_qkv) {
      norm_rows<kLlama>(hb, hf, vec(iNorm1, D), kLlama ? nullptr : vec(1, D),
                        xs, B, D, p.eps);
      weight_phase<W, F>(p, ring, 0, xs, ws.qkv, red);
    }
    phase_sync(grid, l, 0);

    // 2. ATT: one block per (b, kv head, span), carrying the kv head's g
    // query heads
    for (int item = blockIdx.x; item < B * Hkv * n_spans;
         item += gridDim.x) {
      const int sp = item % n_spans;
      const int bk = item / n_spans;
      const int b = bk / Hkv;
      const int kh = bk - b * Hkv;
      for (int i = tid; i < (g + 2) * kHd; i += kThreads) {
        const int r = i / kHd;
        const int d = i - r * kHd;
        int row, col, wcol;
        const bf16* sc;
        const bf16* bi;
        if (r < g) {            // query head q_head(kh, r)
          row = r;
          col = q_head(kh, r) * kHd + d;
          wcol = col;
          sc = kLlama ? scale(2, D) : scale(3, 3 * D);
        } else if (r == g) {    // k
          row = kG;
          col = D + kh * kHd + d;
          wcol = kLlama ? col - D : col;
          sc = kLlama ? scale(4, kvw) : scale(3, 3 * D);
        } else {                // v
          row = kG + 1;
          col = D + kvw + kh * kHd + d;
          wcol = kLlama ? col - D - kvw : col;
          sc = kLlama ? scale(6, kvw) : scale(3, 3 * D);
        }
        bi = bias(4, 3 * D);
        qkv_s[row][d] = finish(ws.qkv, (size_t)B * nqkv, s_qkv,
                               (size_t)b * nqkv + col, sc, bi, wcol);
      }
      __syncthreads();
      if (kLlama) {
        // RoPE, rotate-half in f32, on the query rows and the k row, in
        // place: x[d] cos[d] + rot[d] sin[d], rot[d] = -x[d + 32] for
        // d < 32 and x[d - 32] above (two products and a sum, no fma, as
        // the plain version computes it)
        constexpr int kVals = ((kG + 1) * kHd + kThreads - 1) / kThreads;
        float rv[kVals];
        const float* cs = p.cos + (size_t)b * kHd;
        const float* sn = p.sin + (size_t)b * kHd;
#pragma unroll
        for (int j = 0; j < kVals; ++j) {
          const int i = tid + j * kThreads;
          if (i < (g + 1) * kHd) {
            const int r = i / kHd;
            const int d = i - r * kHd;
            const float* x = qkv_s[r < g ? r : kG];
            const float rot = d < kHd / 2 ? -x[d + kHd / 2] : x[d - kHd / 2];
            rv[j] = __fadd_rn(__fmul_rn(x[d], cs[d]), __fmul_rn(rot, sn[d]));
          }
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kVals; ++j) {
          const int i = tid + j * kThreads;
          if (i < (g + 1) * kHd) {
            const int r = i / kHd;
            qkv_s[r < g ? r : kG][i - r * kHd] = rv[j];
          }
        }
        __syncthreads();
      }
      const int d0 = lane * 2;
      const float qscale = 0.125f;   // 1 / sqrt(64)
      float qa[kG], qb[kG];
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        qa[j] = qkv_s[j][d0] * qscale;
        qb[j] = qkv_s[j][d0 + 1] * qscale;
      }
      bf16* slab = p.kv + (((size_t)l * B + b) * Hkv + kh) *
                              (size_t)p.Smax * (2 * kHd);
      float m[kG], lsum[kG], a0[kG], a1[kG];
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        m[j] = kNegInf;
        lsum[j] = a0[j] = a1[j] = 0.f;
      }
      const int start = p.valid_from != nullptr ? max(p.valid_from[b], 0) : 0;
      // this span's cached positions [lo, hi)
      const int lo = max(start, sp * span);
      const int hi = min(off, (sp + 1) * span);
      for (int p0 = lo + warp * kChunk; p0 < hi; p0 += kWarps * kChunk) {
        __nv_bfloat162 kc[kChunk], vc[kChunk];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const bf16* r = slab + (size_t)min(p0 + c, hi - 1) * (2 * kHd);
          kc[c] = *reinterpret_cast<const __nv_bfloat162*>(r + d0);
          vc[c] = *reinterpret_cast<const __nv_bfloat162*>(r + kHd + d0);
        }
#pragma unroll
        for (int j = 0; j < kG; ++j) {
          if (j < g) {
            float s[kChunk];
            float cmax = kNegInf;
#pragma unroll
            for (int c = 0; c < kChunk; ++c) {
              const float2 kf = __bfloat1622float2(kc[c]);
              s[c] = warp_sum(qa[j] * kf.x + qb[j] * kf.y);
              if (p0 + c < hi) cmax = fmaxf(cmax, s[c]);
            }
            const float m_new = fmaxf(m[j], cmax);
            const float corr = expf(m[j] - m_new);
            lsum[j] *= corr;
            a0[j] *= corr;
            a1[j] *= corr;
#pragma unroll
            for (int c = 0; c < kChunk; ++c) {
              if (p0 + c < hi) {
                const float pe = expf(s[c] - m_new);
                const float2 vf = __bfloat1622float2(vc[c]);
                lsum[j] += pe;
                a0[j] += pe * vf.x;
                a1[j] += pe * vf.y;
              }
            }
            m[j] = m_new;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        if (j < g) {
          if (lane == 0) {
            sm_m[warp][j] = m[j];
            sm_l[warp][j] = lsum[j];
          }
          sm_acc[warp][j][d0] = a0[j];
          sm_acc[warp][j][d0 + 1] = a1[j];
        }
      }
      __syncthreads();
      if (warp == 0) {
        // each query head's span state: the warps' states merged in warp
        // order
#pragma unroll
        for (int j = 0; j < kG; ++j) {
          if (j < g) {
            float mf = kNegInf;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) mf = fmaxf(mf, sm_m[w][j]);
            float lf = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) {
              const float c = expf(sm_m[w][j] - mf);
              lf += sm_l[w][j] * c;
              o0 += sm_acc[w][j][d0] * c;
              o1 += sm_acc[w][j][d0 + 1] * c;
            }
            float* st = ws.att +
                        ((size_t)(b * H + q_head(kh, j)) * slots + sp) *
                            kState;
            st[d0] = o0;
            st[d0 + 1] = o1;
            if (lane == 0) {
              st[kHd] = mf;
              st[kHd + 1] = lf;
            }
          }
        }
      } else if (warp == 1 && sp == 0) {
        // the self term's states (score, weight 1, v) and the one cache
        // write of this (layer, b, kv head): row off, [k | v] (llama: the
        // rotated k)
        const float* kr = qkv_s[kG];
        const float* vr = qkv_s[kG + 1];
#pragma unroll
        for (int j = 0; j < kG; ++j) {
          if (j < g) {
            const float s_self =
                warp_sum(qa[j] * kr[d0] + qb[j] * kr[d0 + 1]);
            float* st = ws.att +
                        ((size_t)(b * H + q_head(kh, j)) * slots +
                         n_spans) * kState;
            st[d0] = vr[d0];
            st[d0 + 1] = vr[d0 + 1];
            if (lane == 0) {
              st[kHd] = s_self;
              st[kHd + 1] = 1.f;
            }
          }
        }
        bf16* dst = slab + (size_t)off * (2 * kHd);
        for (int i = lane; i < kHd; i += 32) {
          dst[i] = __float2bfloat16_rn(kr[i]);
          dst[kHd + i] = __float2bfloat16_rn(vr[i]);
        }
      }
      __syncthreads();
    }
    phase_sync(grid, l, 1);

    // 3. OUT: the output projection of the attention output, 32-row
    // slices; each task first merges the softmax states of its 32 outputs
    // (half a query head)
    {
      const int tiles = D / kTile;
      for (int t = blockIdx.x; t < tiles * s_out; t += gridDim.x) {
        const int tile = t % tiles;
        const int split = t / tiles;
        const int k0 = split * kKcOut;
        for (int i = tid; i < B * kKcOut; i += kThreads) {
          const int r = i / kKcOut;
          const int c = k0 + (i - r * kKcOut);
          const int hh = c / kHd;
          const float* st = ws.att + (size_t)(r * H + hh) * slots * kState;
          float mf = kNegInf, lf = 0.f, of = 0.f;
          for (int s = 0; s <= n_spans; ++s, st += kState)
            merge_state(mf, lf, of, st[kHd], st[kHd + 1], st[c - hh * kHd]);
          xs[i] = __float2bfloat16_rn(of / lf);
        }
        __syncthreads();
        weight_task<W>(p, ring, xs, kKcOut, kKcOut, B,
                          ws.o + (size_t)split * bd, D, tile * kTile, red);
      }
    }
    phase_sync(grid, l, 2);

    // 4. RES1: hm = h + (attention projection)
    for (int i = gtid; i < B * D; i += gthreads) {
      const int c = i % D;
      const float y = finish(ws.o, bd, s_out, i, scale(iWo + 1, D),
                             bias(iWo + 2, D), c);
      const float hv = hb != nullptr ? ld(hb, i) : hf[i];
      ws.hm[i] = rnd(hv + y);
    }
    phase_sync(grid, l, 3);

    // 5. FC: the second norm, then c_fc (llama: gate | up)
    if (blockIdx.x < (nfc / kTile) * s_fc) {
      norm_rows<kLlama>(nullptr, ws.hm, vec(iNorm2, D),
                        kLlama ? nullptr : vec(9, D), xs, B, D, p.eps);
      weight_phase<W, F>(p, ring, 2, xs, ws.fc, red);
    }
    phase_sync(grid, l, 4);

    // 6. PROJ: gelu_new (llama: the SwiGLU) of the FC slice, then the down
    // projection
    {
      const int tiles = D / kTile;
      for (int t = blockIdx.x; t < tiles * s_proj; t += gridDim.x) {
        const int tile = t % tiles;
        const int split = t / tiles;
        for (int i = tid; i < B * kKcProj; i += kThreads) {
          const int r = i / kKcProj;
          const int col = split * kKcProj + (i - r * kKcProj);
          const size_t idx = (size_t)r * nfc + col;
          if (kLlama) {
            const float gt = finish(ws.fc, (size_t)B * nfc, s_fc, idx,
                                    scale(11, I), nullptr, col);
            const float up = finish(ws.fc, (size_t)B * nfc, s_fc, idx + I,
                                    scale(13, I), nullptr, col);
            const float sg = rnd(1.f / (1.f + expf(-gt)));
            xs[i] = __float2bfloat16_rn(rnd(gt * sg) * up);
          } else {
            const float y = finish(ws.fc, (size_t)B * nfc, s_fc, idx,
                                   scale(11, 4 * D), vec(12, 4 * D), col);
            xs[i] = __float2bfloat16_rn(gelu_new(y));
          }
        }
        __syncthreads();
        weight_task<W>(p, ring, xs, kKcProj, kKcProj, B,
                          ws.proj + (size_t)split * bd, D, tile * kTile, red);
      }
    }
    phase_sync(grid, l, 5);

    // 7. RES2: h = hm + (MLP projection), the next layer's input
    const bool last = l + 1 == p.L;
    for (int i = gtid; i < B * D; i += gthreads) {
      const int c = i % D;
      const float y = finish(ws.proj, bd, s_proj, i, scale(iWd + 1, D),
                             bias(iWd + 2, D), c);
      const float hv = rnd(ws.hm[i] + y);
      if (last)
        p.h_out[i] = __float2bfloat16_rn(hv);
      else
        ws.h[i] = hv;
    }
    if (!last) phase_sync(grid, l, 6);
  }
  clock_arrive(p.L - 1, 6);
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
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// a 3-D map over a stacked [L, K, N] weight of type W (16-byte aligned
// base, rows of N * sizeof(W) bytes): boxes of kTile columns x rows x 1
// layer, unswizzled (a box is [rows][kTile] in shared memory)
template <typename W>
cudaError_t weight_map(CUtensorMap* map, const void* w, int L, int K, int N,
                       int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t es = sizeof(W);
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)L};
  const cuuint64_t strides[2] = {N * es, (cuuint64_t)K * N * es};
  const cuuint32_t box[3] = {(cuuint32_t)kTile, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      sizeof(W) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(w), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the dynamic shared memory of a plan: the ring with its alignment slack,
// then xs
size_t plan_smem(int B, int D, int stages) {
  return kRingAlign + (size_t)stages * kStageBytes +
         (size_t)B * D * sizeof(bf16);
}

// Encodes the maps of the family's stacked weights into p and launches on
// the plan (stages of stage_bytes, smem_bytes of dynamic shared memory:
// ops/decode_layer.py::stage_plan), two blocks on every SM. Refuses a plan
// that is not the kernel's, or widths that give a block more boxes a
// layer than its table holds (cudaErrorInvalidValue), and a plan that
// leaves fewer than two blocks an SM resident
// (cudaErrorCooperativeLaunchTooLarge).
template <typename W, typename F>
cudaError_t launch_typed(Params& p, int stages, int stage_bytes,
                         int smem_bytes, cudaStream_t stream) {
  if (stage_bytes != kStageBytes || stages < slice_boxes<W>(kKcFc) ||
      stages > kMaxStages || smem_bytes < 0 ||
      (size_t)smem_bytes != plan_smem(p.B, p.D, stages))
    return cudaErrorInvalidValue;
  p.stages = stages;
  // (operand, K, N, weight phase) of each map, kMaxMaps order
  const int D = p.D, I = p.I, kvw = p.Hkv * kHd;
  const int gpt2[4][4] = {{2, D, 3 * D, 0}, {5, D, D, 1}, {10, D, I, 2},
                          {13, I, D, 3}};
  const int llama[7][4] = {{1, D, D, 0},   {3, D, kvw, 0}, {5, D, kvw, 0},
                           {7, D, D, 1},   {10, D, I, 2},  {12, D, I, 2},
                           {14, I, D, 3}};
  const int n_maps = F::kLlama ? 7 : 4;
  for (int m = 0; m < n_maps; ++m) {
    const int* spec = F::kLlama ? llama[m] : gpt2[m];
    const cudaError_t err = weight_map<W>(
        &p.maps[m], p.w[spec[0]], p.L, spec[1], spec[2],
        min(phase_kc(spec[3]), box_rows<W>()));
    if (err != cudaSuccess) return err;
  }
  const void* kernel = (const void*)decode_layers_kernel<W, F>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem_bytes);
  if (err != cudaSuccess) return err;
  // every block must be resident for the grid barriers, and the attention
  // spans and the weight tasks are shared out over the plan's grid
  if (per_sm < kMaxBlocksPerSm) return cudaErrorCooperativeLaunchTooLarge;
  // a block's boxes of a layer fit its table
  const int blocks = sms * kMaxBlocksPerSm;
  int boxes = 0;
  for (int ph = 0; ph < kWeightPhases; ++ph)
    boxes += (phase_tasks<F::kLlama>(p, ph) + blocks - 1) / blocks *
             slice_boxes<W>(phase_kc(ph));
  if (boxes > kMaxLayerBoxes) return cudaErrorInvalidValue;
  void* kargs[] = {&p};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads),
                                    kargs, smem_bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

Params make_params(const void* const* w, const void* h_in, void* h_out,
                   void* kv, const void* valid_from, void* ws, int L, int B,
                   int H, int D, int Smax, int off, float eps) {
  Params p;
  for (int i = 0; i < kNumWeights; ++i) p.w[i] = w[i];
  p.h_in = static_cast<const bf16*>(h_in);
  p.h_out = static_cast<bf16*>(h_out);
  p.kv = static_cast<bf16*>(kv);
  p.valid_from = static_cast<const int*>(valid_from);
  p.cos = p.sin = nullptr;
  p.ws = static_cast<float*>(ws);
  p.L = L;
  p.B = B;
  p.H = H;
  p.Hkv = H;
  p.D = D;
  p.I = 4 * D;
  p.Smax = Smax;
  p.off = off;
  p.stages = 0;
  p.eps = eps;
  return p;
}

}  // namespace

extern "C" {

// GPT-2. w: host array of the 16 stacked operands in the JAX kernel's
// order (scales null for bf16 weights); h_in/h_out [B, D] and kv bf16; ws
// a float32 workspace of ws_floats >= decode_layers_workspace_floats(B, D,
// H, Smax) elements; (stages, stage_bytes, smem_bytes) the weight ring's
// plan, ops/decode_layer.py::stage_plan's. Requires head_dim 64 (D == 64 *
// H), D % 128 == 0, 1 <= B <= 16, 0 <= off < Smax and the weights 16-byte
// aligned. Returns the cudaError_t of the launch or of a weight's
// tensor-map encode (0 on success); allocates nothing.
int decode_layers_launch(const void* const* w, const void* h_in, void* h_out,
                         void* kv, const void* valid_from, void* ws,
                         int ws_floats, int quantized, int L, int B, int H,
                         int D, int Smax, int off, float eps, int stages,
                         int stage_bytes, int smem_bytes, void* stream) {
  if (L < 1 || B < 1 || B > kMaxB || D != H * kHd || D % kTile != 0 ||
      off < 0 || off >= Smax ||
      (size_t)ws_floats < workspace_floats(B, D, H, H, 4 * D, false, Smax))
    return (int)cudaErrorInvalidValue;
  Params p = make_params(w, h_in, h_out, kv, valid_from, ws, L, B, H, D, Smax,
                         off, eps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      quantized ? launch_typed<int8_t, Gpt2>(p, stages, stage_bytes,
                                             smem_bytes, s)
                : launch_typed<bf16, Gpt2>(p, stages, stage_bytes, smem_bytes,
                                           s);
  return (int)err;
}

// the float32 workspace, in elements, that decode_layers_launch needs for
// these sizes (-1 past INT_MAX)
int decode_layers_workspace_floats(int B, int D, int H, int Smax) {
  const size_t n = workspace_floats(B, D, H, H, 4 * D, false, Smax);
  return n > (size_t)INT_MAX ? -1 : (int)n;
}

// llama. w: the 16 stacked operands in the JAX llama kernel's order
// (ln_attn, wq, sq, wk, sk, wv, sv, wo, so, ln_mlp, wgate, sgate, wup,
// sup, wdown, sdown; scales null for bf16 weights); cos/sin [B, 64]
// float32, the step's rotary angles; kv [L, B, Hkv, Smax, 128]; ws as
// decode_layers_llama_workspace_floats(B, D, H, Hkv, I, Smax). Requires
// head_dim 64 (D == 64 * H), H % Hkv == 0 with H / Hkv <= 4, D, 64 * Hkv
// and I multiples of 128, 1 <= B <= 16 and 0 <= off < Smax; the plan and
// the weights as for GPT-2.
int decode_layers_llama_launch(const void* const* w, const void* h_in,
                               void* h_out, void* kv, const void* valid_from,
                               const void* cos, const void* sin, void* ws,
                               int ws_floats, int quantized, int L, int B,
                               int H, int Hkv, int D, int I, int Smax,
                               int off, float eps, int stages,
                               int stage_bytes, int smem_bytes,
                               void* stream) {
  if (L < 1 || B < 1 || B > kMaxB || D != H * kHd || D % kTile != 0 ||
      Hkv < 1 || H % Hkv != 0 || H / Hkv > Llama::kMaxG ||
      (Hkv * kHd) % kTile != 0 || I < kTile || I % kTile != 0 ||
      off < 0 || off >= Smax || cos == nullptr || sin == nullptr ||
      (size_t)ws_floats < workspace_floats(B, D, H, Hkv, I, true, Smax))
    return (int)cudaErrorInvalidValue;
  Params p = make_params(w, h_in, h_out, kv, valid_from, ws, L, B, H, D, Smax,
                         off, eps);
  p.Hkv = Hkv;
  p.I = I;
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      quantized ? launch_typed<int8_t, Llama>(p, stages, stage_bytes,
                                              smem_bytes, s)
                : launch_typed<bf16, Llama>(p, stages, stage_bytes,
                                            smem_bytes, s);
  return (int)err;
}

int decode_layers_llama_workspace_floats(int B, int D, int H, int Hkv, int I,
                                         int Smax) {
  const size_t n = workspace_floats(B, D, H, Hkv, I, true, Smax);
  return n > (size_t)INT_MAX ? -1 : (int)n;
}

#ifdef DECODE_LAYERS_PHASE_CLOCK
// copies the clock of the last launch into out (1 + 2 * kClockSlots
// values: start, arrivals, releases, slot l * 8 + k) and zeroes it
int decode_layers_phase_clock(unsigned long long* out) {
  static const unsigned long long zero[kClockSlots] = {};
  const size_t n = sizeof(zero);
  cudaError_t err = cudaMemcpyFromSymbol(out, g_clock_start, sizeof(*out));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out + 1, g_clock_arrive, n);
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out + 1 + kClockSlots, g_clock_release, n);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_clock_arrive, zero, n);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_clock_release, zero, n);
  return (int)err;
}
#endif

const char* decode_layers_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
