// Whole-stack GPT-2 decode: one token through all L blocks in one launch.
//
// Replaces the Pallas megakernel of the JAX package:
// llm_sharding_demo_tpu/ops/decode_layer.py::_kernel (called through
// _build_call / _call and decode_layers). For each layer l, on the hidden
// state h [B, D] (bf16 values):
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
// where mm(x, W) + b = round_bf16(sum_k x[k] * float(W[k, n]) (* scale[n]
// for int8 W) + bias[n]) with f32 accumulation: the JAX kernel's _matmul.
// Attention is f32 with an online softmax and the self term folded in
// last, as in csrc/decode_attention.cu. The weights are the model's
// stacked [L, ...] tensors (int8 with bf16 per-column scales, or bf16);
// activations, LN parameters, biases and the fused [L, B, H, Smax, 128]
// cache are bf16; head_dim is 64 and B <= 16.
//
// What bounds it on the card: bytes. At B <= 16 each weight byte takes
// part in at most 16 multiply-adds; one step must stream every layer's
// weights (85 MB int8 for GPT-2 124M) and the live cache once. What the
// TPU kernel did with a sequential grid (carry h in VMEM from one layer to
// the next) needs a different shape here, since blocks run in parallel
// and nothing carries between them: ONE persistent cooperative launch,
// every block resident, walks the layers in a loop and separates the
// phases of a layer with grid-wide barriers (7 per layer):
//
//   1. QKV: every block recomputes LN1 of h into shared memory, then the
//      blocks share out (128-column tile, 64-row contraction slice)
//      tasks of the QKV product; each task writes its f32 partial sums.
//   2. ATT: one block per (batch row, head, span of cached positions),
//      the spans sized so that the items fill the grid: it sums its q/k/v
//      partials in a fixed order, runs the decode-attention loop (8
//      warps, 8 rows in flight per warp, f32 online softmax) over its
//      span and leaves the span's softmax state (max, sum, 64
//      accumulators); the first span's block also leaves the self term's
//      state and makes the one row write. Meanwhile every thread
//      prefetches the weights of the layer's later phases into L2.
//   3. OUT: c_proj tasks (32-row slices, so 144 tasks fill the card);
//      each task first merges the softmax states of its 32 attention
//      outputs in position order, the self term last.
//   4. RES1: the blocks share out h + (sum of partials) over B * D.
//   5. FC: LN2 recomputed per block, then c_fc tasks.
//   6. PROJ: each task sums its slice of the c_fc partials, applies
//      gelu_new, then runs its c_proj slice.
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

struct Params {
  // operand order of the JAX kernel: ln1 s/b, qkv w/s/b, out w/s/b,
  // ln2 s/b, fc w/s/b, proj w/s/b; scales are null for bf16 weights
  const void* w[kNumWeights];
  const bf16* h_in;        // [B, D]
  bf16* h_out;             // [B, D]
  bf16* kv;                // [L, B, H, Smax, 2 * kHd]
  const int* valid_from;   // [B] or null
  float* ws;
  int L, B, H, D, Smax, off;
  float eps;
};

// softmax-state slots per (batch row, head): at most Smax / kSpanStep
// spans, then the self term
__host__ __device__ inline int state_slots(int Smax) {
  return Smax / kSpanStep + 2;
}

// workspace layout (floats): h, hm [B, D]; the partial sums of each
// product; the attention softmax states [B, H, state_slots, kState]
struct Workspace {
  float *h, *hm, *qkv, *o, *fc, *proj, *att;
};

__host__ __device__ inline size_t workspace_floats(int B, int D, int H,
                                                   int Smax) {
  const size_t bd = (size_t)B * D;
  return 2 * bd + (size_t)(D / kKcQkv) * 3 * bd + (size_t)(D / kKcOut) * bd +
         (size_t)(D / kKcFc) * 4 * bd + (size_t)(4 * D / kKcProj) * bd +
         (size_t)B * H * state_slots(Smax) * kState;
}

__device__ inline Workspace carve(float* ws, int B, int D) {
  const size_t bd = (size_t)B * D;
  Workspace w;
  w.h = ws;
  w.hm = w.h + bd;
  w.qkv = w.hm + bd;
  w.o = w.qkv + (size_t)(D / kKcQkv) * 3 * bd;
  w.fc = w.o + (size_t)(D / kKcOut) * bd;
  w.proj = w.fc + (size_t)(D / kKcFc) * 4 * bd;
  w.att = w.proj + (size_t)(4 * D / kKcProj) * bd;
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

// One weight task: rows [k0, k0 + kc) of a [K, N] layer weight times the
// activations xs (shared memory, row b at xs[b * ldx], already offset to
// k0), columns [col0, col0 + kTile). Writes the f32 partial sums to
// part[b * N + col] (this split's slice of the workspace). The order of
// every sum is fixed.
template <typename W>
__device__ void weight_task(const float* xs, int ldx, const W* w, int N,
                            int k0, int kc, int col0, int B, float* part,
                            float (*red)[kRowGroup][kTile]) {
  constexpr int kCpt = Unpack<W>::kCols;   // columns per thread
  constexpr int kTpr = kTile / kCpt;       // threads per weight row
  constexpr int kRpp = kThreads / kTpr;    // weight rows per pass
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cseg = (tid % kTpr) * kCpt;
  const int krow = tid / kTpr;
  const W* wcol = w + (size_t)k0 * N + col0 + cseg;
  for (int r0 = 0; r0 < B; r0 += kRowGroup) {
    float acc[kRowGroup][kCpt];
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r)
#pragma unroll
      for (int j = 0; j < kCpt; ++j) acc[r][j] = 0.f;
#pragma unroll 4
    for (int kk = krow; kk < kc; kk += kRpp) {
      const int4 raw =
          __ldg(reinterpret_cast<const int4*>(wcol + (size_t)kk * N));
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
        part[(size_t)(r0 + r) * N + col0 + c] = s;
      }
    }
    __syncthreads();
  }
}

// the column's final value: split sums in order, * scale, + bias, rounded.
// The split loads are issued kInFlight at a time before any is added (a
// load-then-add loop would wait one memory latency per split); absent
// splits add an exact 0, so the order and the bits do not depend on the
// batching.
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
  return rnd(s + ld(bias, col));
}

__device__ __forceinline__ float gelu_new(float x) {
  return 0.5f * x *
         (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

// LayerNorm of h rows (bf16 source hb or float source hf) into xs [B][D]:
// the block loads all B * D values at once (every load in flight), then
// one warp per row takes the statistics from shared memory
__device__ void layer_norm_rows(const bf16* hb, const float* hf,
                                const bf16* s, const bf16* b, float* xs,
                                int B, int D, float eps) {
  for (int i = threadIdx.x; i < B * D; i += kThreads)
    xs[i] = hb != nullptr ? ld(hb, i) : hf[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < B; r += kWarps) {
    float* x = xs + (size_t)r * D;
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

template <typename W>
__device__ void weight_phase(const float* xs, int ldx_full, const W* w,
                             int N, int K, int kc, int B, float* part,
                             float (*red)[kRowGroup][kTile]) {
  const int tiles = N / kTile;
  const int tasks = tiles * (K / kc);
  for (int t = blockIdx.x; t < tasks; t += gridDim.x) {
    const int tile = t % tiles;
    const int split = t / tiles;
    weight_task<W>(xs + split * kc, ldx_full, w, N, split * kc, kc,
                   tile * kTile, B, part + (size_t)split * B * N, red);
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSm)
decode_layers_kernel(const Params p) {
  extern __shared__ __align__(16) float xs[];   // [B][D] f32
  __shared__ float qkv_s[3][kHd];
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][kHd];
  __shared__ float red[kWarps][kRowGroup][kTile];
  cg::grid_group grid = cg::this_grid();
#ifdef DECODE_LAYERS_PHASE_CLOCK
  if (blockIdx.x == 0 && threadIdx.x == 0) g_clock_start = globaltimer();
#endif

  const int B = p.B, D = p.D, H = p.H, off = p.off;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t bd = (size_t)B * D;
  const Workspace ws = carve(p.ws, B, D);
  const bool quantized = sizeof(W) == 1;
  const int s_qkv = D / kKcQkv, s_out = D / kKcOut, s_fc = D / kKcFc,
            s_proj = 4 * D / kKcProj;
  const int gtid = blockIdx.x * kThreads + tid;
  const int gthreads = gridDim.x * kThreads;
  // attention spans: whole block rounds of cached positions, as few
  // per (b, head) as fill the grid; the self term's state follows them
  const int per_bh = max(1, (int)gridDim.x / (B * H));
  const int rounds = (off + kSpanStep - 1) / kSpanStep;
  const int span = max(1, (rounds + per_bh - 1) / per_bh) * kSpanStep;
  const int n_spans = max(1, (off + span - 1) / span);
  const int slots = state_slots(p.Smax);

  for (int l = 0; l < p.L; ++l) {
    auto vec = [&](int i, int width) {
      return static_cast<const bf16*>(p.w[i]) + (size_t)l * width;
    };
    auto mat = [&](int i, int rows, int cols) {
      return static_cast<const W*>(p.w[i]) + (size_t)l * rows * cols;
    };
    auto scale = [&](int i, int width) {
      return quantized ? vec(i, width) : static_cast<const bf16*>(nullptr);
    };
    // the layer's input h: the caller's tensor at layer 0, else ws.h
    const bf16* hb = l == 0 ? p.h_in : nullptr;
    const float* hf = l == 0 ? nullptr : ws.h;

    // 1. QKV
    if (blockIdx.x < (3 * D / kTile) * s_qkv) {
      layer_norm_rows(hb, hf, vec(0, D), vec(1, D), xs, B, D, p.eps);
      weight_phase<W>(xs, D, mat(2, D, 3 * D), 3 * D, D, kKcQkv, B, ws.qkv,
                        red);
    }
    phase_sync(grid, l, 0);

    // 2. ATT: one block per (b, head, span)
    for (int item = blockIdx.x; item < B * H * n_spans; item += gridDim.x) {
      const int sp = item % n_spans;
      const int bh = item / n_spans;
      const int b = bh / H;
      const int hh = bh - b * H;
      if (tid < 3 * kHd) {
        const int part = tid / kHd;
        const int col = part * D + hh * kHd + (tid - part * kHd);
        qkv_s[part][tid - part * kHd] =
            finish(ws.qkv, 3 * bd, s_qkv, (size_t)b * 3 * D + col,
                   scale(3, 3 * D), vec(4, 3 * D), col);
      }
      __syncthreads();
      const int d0 = lane * 2;
      const float qscale = 0.125f;   // 1 / sqrt(64)
      const float q0 = qkv_s[0][d0] * qscale, q1 = qkv_s[0][d0 + 1] * qscale;
      bf16* slab = p.kv + (((size_t)l * B + b) * H + hh) * (size_t)p.Smax *
                              (2 * kHd);
      float m = kNegInf, lsum = 0.f, a0 = 0.f, a1 = 0.f;
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
        float s[kChunk];
        float cmax = kNegInf;
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const float2 kf = __bfloat1622float2(kc[c]);
          s[c] = warp_sum(q0 * kf.x + q1 * kf.y);
          if (p0 + c < hi) cmax = fmaxf(cmax, s[c]);
        }
        const float m_new = fmaxf(m, cmax);
        const float corr = expf(m - m_new);
        lsum *= corr;
        a0 *= corr;
        a1 *= corr;
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          if (p0 + c < hi) {
            const float pe = expf(s[c] - m_new);
            const float2 vf = __bfloat1622float2(vc[c]);
            lsum += pe;
            a0 += pe * vf.x;
            a1 += pe * vf.y;
          }
        }
        m = m_new;
      }
      if (lane == 0) {
        sm_m[warp] = m;
        sm_l[warp] = lsum;
      }
      sm_acc[warp][d0] = a0;
      sm_acc[warp][d0 + 1] = a1;
      __syncthreads();
      float* states = ws.att + (size_t)bh * slots * kState;
      if (warp == 0) {
        // the span's state: the warps' states merged in warp order
        float mf = kNegInf;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) mf = fmaxf(mf, sm_m[w]);
        float lf = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float c = expf(sm_m[w] - mf);
          lf += sm_l[w] * c;
          o0 += sm_acc[w][d0] * c;
          o1 += sm_acc[w][d0 + 1] * c;
        }
        float* st = states + (size_t)sp * kState;
        st[d0] = o0;
        st[d0 + 1] = o1;
        if (lane == 0) {
          st[kHd] = mf;
          st[kHd + 1] = lf;
        }
      } else if (warp == 1 && sp == 0) {
        // the self term's state (score, weight 1, v) and the one cache
        // write of this (layer, b, head): row off
        const float s_self =
            warp_sum(q0 * qkv_s[1][d0] + q1 * qkv_s[1][d0 + 1]);
        float* st = states + (size_t)n_spans * kState;
        st[d0] = qkv_s[2][d0];
        st[d0 + 1] = qkv_s[2][d0 + 1];
        if (lane == 0) {
          st[kHd] = s_self;
          st[kHd + 1] = 1.f;
        }
        bf16* dst = slab + (size_t)off * (2 * kHd);
        for (int i = lane; i < kHd; i += 32) {
          dst[i] = __float2bfloat16_rn(qkv_s[1][i]);
          dst[kHd + i] = __float2bfloat16_rn(qkv_s[2][i]);
        }
      }
      __syncthreads();
    }
    // the layer's later weights and the next layer's QKV, into L2
    prefetch_l2(mat(5, D, D), (size_t)D * D * sizeof(W), gtid, gthreads);
    prefetch_l2(mat(10, D, 4 * D), (size_t)4 * D * D * sizeof(W), gtid,
                gthreads);
    prefetch_l2(mat(13, 4 * D, D), (size_t)4 * D * D * sizeof(W), gtid,
                gthreads);
    if (l + 1 < p.L)
      prefetch_l2(mat(2, D, 3 * D) + (size_t)3 * D * D, (size_t)3 * D * D *
                  sizeof(W), gtid, gthreads);
    phase_sync(grid, l, 1);

    // 3. OUT: c_proj of the attention output, 32-row slices; each task
    // first merges the softmax states of its 32 outputs (half a head)
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
        weight_task<W>(xs, kKcOut, mat(5, D, D), D, split * kKcOut, kKcOut,
                       tile * kTile, B, ws.o + (size_t)split * bd, red);
      }
    }
    phase_sync(grid, l, 2);

    // 4. RES1: hm = h + (attention projection)
    for (int i = gtid; i < B * D; i += gthreads) {
      const int c = i % D;
      const float y = finish(ws.o, bd, s_out, i, scale(6, D), vec(7, D), c);
      const float hv = hb != nullptr ? ld(hb, i) : hf[i];
      ws.hm[i] = rnd(hv + y);
    }
    phase_sync(grid, l, 3);

    // 5. FC: LN2, then c_fc
    if (blockIdx.x < (4 * D / kTile) * s_fc) {
      layer_norm_rows(nullptr, ws.hm, vec(8, D), vec(9, D), xs, B, D, p.eps);
      weight_phase<W>(xs, D, mat(10, D, 4 * D), 4 * D, D, kKcFc, B, ws.fc,
                        red);
    }
    phase_sync(grid, l, 4);

    // 6. PROJ: gelu_new of the c_fc slice, then c_proj
    {
      const int tiles = D / kTile;
      for (int t = blockIdx.x; t < tiles * s_proj; t += gridDim.x) {
        const int tile = t % tiles;
        const int split = t / tiles;
        for (int i = tid; i < B * kKcProj; i += kThreads) {
          const int r = i / kKcProj;
          const int col = split * kKcProj + (i - r * kKcProj);
          const float y = finish(ws.fc, 4 * bd, s_fc, (size_t)r * 4 * D + col,
                                 scale(11, 4 * D), vec(12, 4 * D), col);
          xs[i] = rnd(gelu_new(y));
        }
        __syncthreads();
        weight_task<W>(xs, kKcProj, mat(13, 4 * D, D), D, split * kKcProj,
                       kKcProj, tile * kTile, B, ws.proj + (size_t)split * bd,
                       red);
      }
    }
    phase_sync(grid, l, 5);

    // 7. RES2: h = hm + (MLP projection), the next layer's input
    const bool last = l + 1 == p.L;
    for (int i = gtid; i < B * D; i += gthreads) {
      const int c = i % D;
      const float y =
          finish(ws.proj, bd, s_proj, i, scale(14, D), vec(15, D), c);
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

template <typename W>
cudaError_t launch_typed(const Params& p, cudaStream_t stream) {
  const void* kernel = (const void*)decode_layers_kernel<W>;
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

}  // namespace

extern "C" {

// w: host array of the 16 stacked operands in the JAX kernel's order
// (scales null for bf16 weights); h_in/h_out [B, D] and kv bf16; ws a
// float32 workspace of ws_floats >= decode_layers_workspace_floats(B, D,
// H, Smax) elements. Requires head_dim 64 (D == 64 * H), D % 128 == 0,
// 1 <= B <= 16 and 0 <= off < Smax. Returns the launch's cudaError_t
// (0 on success); allocates nothing.
int decode_layers_launch(const void* const* w, const void* h_in, void* h_out,
                         void* kv, const void* valid_from, void* ws,
                         int ws_floats, int quantized, int L, int B, int H,
                         int D, int Smax, int off, float eps, void* stream) {
  if (L < 1 || B < 1 || B > kMaxB || D != H * kHd || D % kTile != 0 ||
      off < 0 || off >= Smax ||
      (size_t)ws_floats < workspace_floats(B, D, H, Smax))
    return (int)cudaErrorInvalidValue;
  Params p;
  for (int i = 0; i < kNumWeights; ++i) p.w[i] = w[i];
  p.h_in = static_cast<const bf16*>(h_in);
  p.h_out = static_cast<bf16*>(h_out);
  p.kv = static_cast<bf16*>(kv);
  p.valid_from = static_cast<const int*>(valid_from);
  p.ws = static_cast<float*>(ws);
  p.L = L;
  p.B = B;
  p.H = H;
  p.D = D;
  p.Smax = Smax;
  p.off = off;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      quantized ? launch_typed<int8_t>(p, s) : launch_typed<bf16>(p, s);
  return (int)err;
}

// the float32 workspace, in elements, that decode_layers_launch needs for
// these sizes (-1 past INT_MAX)
int decode_layers_workspace_floats(int B, int D, int H, int Smax) {
  const size_t n = workspace_floats(B, D, H, Smax);
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
