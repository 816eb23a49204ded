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
//      row write. Meanwhile every thread prefetches the weights of the
//      layer's later phases into L2.
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
// allocates. Weight tasks reuse the int8 linear's design (16-byte loads,
// 16 int8 columns per thread, byte-permute int8 -> f32). Simple first:
// each task has only a few loads in flight.

#include <cooperative_groups.h>
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

struct Params {
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

// One weight task: rows [k0, k0 + kc) of a [K, ldw] layer weight times the
// activations xs (shared memory, row b at xs[b * ldx], already offset to
// k0), columns [col0, col0 + kTile). Writes the f32 partial sums to
// part[b * ldp + pcol0 + c] (this split's slice of the workspace, whose
// rows may hold several weights' outputs side by side). The order of
// every sum is fixed.
template <typename W>
__device__ void weight_task(const float* xs, int ldx, const W* w, int ldw,
                            int k0, int kc, int col0, int B, float* part,
                            int ldp, int pcol0,
                            float (*red)[kRowGroup][kTile]) {
  constexpr int kCpt = Unpack<W>::kCols;   // columns per thread
  constexpr int kTpr = kTile / kCpt;       // threads per weight row
  constexpr int kRpp = kThreads / kTpr;    // weight rows per pass
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cseg = (tid % kTpr) * kCpt;
  const int krow = tid / kTpr;
  const W* wcol = w + (size_t)k0 * ldw + col0 + cseg;
  for (int r0 = 0; r0 < B; r0 += kRowGroup) {
    float acc[kRowGroup][kCpt];
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r)
#pragma unroll
      for (int j = 0; j < kCpt; ++j) acc[r][j] = 0.f;
#pragma unroll 4
    for (int kk = krow; kk < kc; kk += kRpp) {
      const int4 raw =
          __ldg(reinterpret_cast<const int4*>(wcol + (size_t)kk * ldw));
      float wf[kCpt];
      Unpack<W>::run(raw, wf);
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
        if (r0 + r < B) {
          const float xv = xs[(r0 + r) * ldx + kk];
#pragma unroll
          for (int j = 0; j < kCpt; ++j) acc[r][j] += xv * wf[j];
        }
      }
    }
    // the lanes of a warp that share columns differ by multiples of kTpr
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r)
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
      for (int r = 0; r < kRowGroup; ++r)
#pragma unroll
        for (int j = 0; j < kCpt; ++j) red[warp][r][cseg + j] = acc[r][j];
    }
    __syncthreads();
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

// The first (or second) norm of h rows (bf16 source hb or float source hf)
// into xs [B][D]: the block loads all B * D values at once (every load in
// flight), then one warp per row takes the statistics from shared memory.
// GPT-2: LayerNorm with scale s and bias b, one rounding. llama: RMSNorm,
// rounded, then times s, rounded again (b unused).
template <bool kRms>
__device__ void norm_rows(const bf16* hb, const float* hf, const bf16* s,
                          const bf16* b, float* xs, int B, int D, float eps) {
  for (int i = threadIdx.x; i < B * D; i += kThreads)
    xs[i] = hb != nullptr ? ld(hb, i) : hf[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < B; r += kWarps) {
    float* x = xs + (size_t)r * D;
    if (kRms) {
      float sq = 0.f;
      for (int c = lane; c < D; c += 32) sq += x[c] * x[c];
      const float inv = rsqrtf(warp_sum(sq) / D + eps);
      for (int c = lane; c < D; c += 32)
        x[c] = rnd(rnd(x[c] * inv) * ld(s, c));
    } else {
      float sum = 0.f;
      for (int c = lane; c < D; c += 32) sum += x[c];
      const float mean = warp_sum(sum) / D;
      float sq = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float d = x[c] - mean;
        sq += d * d;
      }
      const float inv = rsqrtf(warp_sum(sq) / D + eps);
      for (int c = lane; c < D; c += 32)
        x[c] = rnd((x[c] - mean) * inv * ld(s, c) + ld(b, c));
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes,
                                            size_t tid, size_t threads) {
  const char* c = static_cast<const char*>(p);
  for (size_t o = tid * 128; o < bytes; o += threads * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + o));
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

// up to three weights whose outputs sit side by side in one partial-sum
// row (GPT-2's one c_attn or c_fc; llama's q | k | v, gate | up)
template <typename W>
struct Segs {
  const W* w[3];
  int n[3];
  int count;
};

template <typename W>
__device__ void weight_phase(const float* xs, int ldx_full, const Segs<W>& sg,
                             int K, int kc, int B, float* part,
                             float (*red)[kRowGroup][kTile]) {
  int N = 0;
  for (int s = 0; s < sg.count; ++s) N += sg.n[s];
  const int tiles = N / kTile;
  const int tasks = tiles * (K / kc);
  for (int t = blockIdx.x; t < tasks; t += gridDim.x) {
    const int tile = t % tiles;
    const int split = t / tiles;
    int s = 0, col = tile * kTile;
    while (s + 1 < sg.count && col >= sg.n[s]) col -= sg.n[s++];
    weight_task<W>(xs + split * kc, ldx_full, sg.w[s], sg.n[s], split * kc,
                   kc, col, B, part + (size_t)split * B * N, N, tile * kTile,
                   red);
  }
}

template <typename W, typename F>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSm)
decode_layers_kernel(const Params p) {
  constexpr int kG = F::kMaxG;
  constexpr bool kLlama = F::kLlama;
  // operand indices of the two families (see Params)
  constexpr int iNorm1 = 0;
  constexpr int iWo = kLlama ? 7 : 5;
  constexpr int iNorm2 = kLlama ? 9 : 8;
  constexpr int iWfc = 10;
  constexpr int iWd = kLlama ? 14 : 13;
  extern __shared__ __align__(16) float xs[];   // [B][D] f32
  // rows 0..g-1: the item's query heads; kG: k; kG + 1: v
  __shared__ float qkv_s[kG + 2][kHd];
  __shared__ float sm_m[kWarps][kG], sm_l[kWarps][kG];
  __shared__ float sm_acc[kWarps][kG][kHd];
  __shared__ float red[kWarps][kRowGroup][kTile];
  cg::grid_group grid = cg::this_grid();
#ifdef DECODE_LAYERS_PHASE_CLOCK
  if (blockIdx.x == 0 && threadIdx.x == 0) g_clock_start = globaltimer();
#endif

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
    auto mat = [&](int i, int rows, int cols, int layer) {
      return static_cast<const W*>(p.w[i]) + (size_t)layer * rows * cols;
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
    {
      Segs<W> sg;
      if (kLlama) {
        sg = {{mat(1, D, D, l), mat(3, D, kvw, l), mat(5, D, kvw, l)},
              {D, kvw, kvw}, 3};
      } else {
        sg = {{mat(2, D, 3 * D, l), nullptr, nullptr}, {3 * D, 0, 0}, 1};
      }
      if (blockIdx.x < (nqkv / kTile) * s_qkv) {
        norm_rows<kLlama>(hb, hf, vec(iNorm1, D),
                          kLlama ? nullptr : vec(1, D), xs, B, D, p.eps);
        weight_phase<W>(xs, D, sg, D, kKcQkv, B, ws.qkv, red);
      }
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
    // the layer's later weights and the next layer's q/k/v, into L2
    const size_t wsz = sizeof(W);
    prefetch_l2(mat(iWo, D, D, l), (size_t)D * D * wsz, gtid, gthreads);
    if (kLlama) {
      prefetch_l2(mat(10, D, I, l), (size_t)D * I * wsz, gtid, gthreads);
      prefetch_l2(mat(12, D, I, l), (size_t)D * I * wsz, gtid, gthreads);
      prefetch_l2(mat(14, I, D, l), (size_t)I * D * wsz, gtid, gthreads);
      if (l + 1 < p.L) {
        prefetch_l2(mat(1, D, D, l + 1), (size_t)D * D * wsz, gtid, gthreads);
        prefetch_l2(mat(3, D, kvw, l + 1), (size_t)D * kvw * wsz, gtid,
                    gthreads);
        prefetch_l2(mat(5, D, kvw, l + 1), (size_t)D * kvw * wsz, gtid,
                    gthreads);
      }
    } else {
      prefetch_l2(mat(10, D, 4 * D, l), (size_t)4 * D * D * wsz, gtid,
                  gthreads);
      prefetch_l2(mat(13, 4 * D, D, l), (size_t)4 * D * D * wsz, gtid,
                  gthreads);
      if (l + 1 < p.L)
        prefetch_l2(mat(2, D, 3 * D, l + 1), (size_t)3 * D * D * wsz, gtid,
                    gthreads);
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
          xs[i] = rnd(of / lf);
        }
        __syncthreads();
        weight_task<W>(xs, kKcOut, mat(iWo, D, D, l), D, split * kKcOut,
                       kKcOut, tile * kTile, B, ws.o + (size_t)split * bd, D,
                       tile * kTile, red);
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
    {
      Segs<W> sg;
      if (kLlama) {
        sg = {{mat(iWfc, D, I, l), mat(12, D, I, l), nullptr}, {I, I, 0}, 2};
      } else {
        sg = {{mat(iWfc, D, 4 * D, l), nullptr, nullptr}, {4 * D, 0, 0}, 1};
      }
      if (blockIdx.x < (nfc / kTile) * s_fc) {
        norm_rows<kLlama>(nullptr, ws.hm, vec(iNorm2, D),
                          kLlama ? nullptr : vec(9, D), xs, B, D, p.eps);
        weight_phase<W>(xs, D, sg, D, kKcFc, B, ws.fc, red);
      }
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
            xs[i] = rnd(rnd(gt * sg) * up);
          } else {
            const float y = finish(ws.fc, (size_t)B * nfc, s_fc, idx,
                                   scale(11, 4 * D), vec(12, 4 * D), col);
            xs[i] = rnd(gelu_new(y));
          }
        }
        __syncthreads();
        weight_task<W>(xs, kKcProj, mat(iWd, I, D, l), D, split * kKcProj,
                       kKcProj, tile * kTile, B, ws.proj + (size_t)split * bd,
                       D, tile * kTile, red);
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

template <typename W, typename F>
cudaError_t launch_typed(const Params& p, cudaStream_t stream) {
  const void* kernel = (const void*)decode_layers_kernel<W, F>;
  const size_t smem = (size_t)p.B * p.D * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  // every block must be resident for the grid barriers; the cooperative
  // launch refuses a grid that is not (cudaErrorCooperativeLaunchTooLarge)
  const int blocks = sms * max(1, min(per_sm, kMaxBlocksPerSm));
  Params args = p;
  void* kargs[] = {&args};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads),
                                    kargs, smem, stream);
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
  p.eps = eps;
  return p;
}

}  // namespace

extern "C" {

// GPT-2. w: host array of the 16 stacked operands in the JAX kernel's
// order (scales null for bf16 weights); h_in/h_out [B, D] and kv bf16; ws
// a float32 workspace of ws_floats >= decode_layers_workspace_floats(B, D,
// H, Smax) elements. Requires head_dim 64 (D == 64 * H), D % 128 == 0,
// 1 <= B <= 16 and 0 <= off < Smax. Returns the launch's cudaError_t
// (0 on success); allocates nothing.
int decode_layers_launch(const void* const* w, const void* h_in, void* h_out,
                         void* kv, const void* valid_from, void* ws,
                         int ws_floats, int quantized, int L, int B, int H,
                         int D, int Smax, int off, float eps, void* stream) {
  if (L < 1 || B < 1 || B > kMaxB || D != H * kHd || D % kTile != 0 ||
      off < 0 || off >= Smax ||
      (size_t)ws_floats < workspace_floats(B, D, H, H, 4 * D, false, Smax))
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(w, h_in, h_out, kv, valid_from, ws, L, B, H, D,
                               Smax, off, eps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = quantized ? launch_typed<int8_t, Gpt2>(p, s)
                                    : launch_typed<bf16, Gpt2>(p, s);
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
// and I multiples of 128, 1 <= B <= 16 and 0 <= off < Smax.
int decode_layers_llama_launch(const void* const* w, const void* h_in,
                               void* h_out, void* kv, const void* valid_from,
                               const void* cos, const void* sin, void* ws,
                               int ws_floats, int quantized, int L, int B,
                               int H, int Hkv, int D, int I, int Smax,
                               int off, float eps, void* stream) {
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
  const cudaError_t err = quantized ? launch_typed<int8_t, Llama>(p, s)
                                    : launch_typed<bf16, Llama>(p, s);
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
