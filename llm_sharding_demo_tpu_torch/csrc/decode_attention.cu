// Single-token cached attention with an in-place fused-cache row write.
//
// Replaces the Pallas flash-decode kernel of the JAX package:
// llm_sharding_demo_tpu/ops/decode_attention.py::_kernel (called through
// _call and decode_attention). It computes the same function:
//
//   for batch row b, query head h (kv head kvh = h / g):
//     q'      = float(q[b, h]) * scale                       (f32)
//     s_p     = q' . K[li, b, kvh, p]      for valid_from[b] <= p < off
//     s_self  = q' . k_new[b, kvh]
//     out     = softmax([s_p..., s_self]) . [V[li, b, kvh, p]..., v_new]
//   and the row [k_new | v_new] is written into KV[li, b, kvh, off, :].
//
// Scores, softmax and the accumulator are f32; the output is rounded once
// to the input dtype. The cache is the fused [L, B, Hkv, Smax, 2*hd]
// layout, so one position is one contiguous 2*hd row (256 bytes in bf16
// at hd = 64).
//
// What bounds it on the card: bytes. Each step reads the live part of one
// layer's cache (off rows of 2*hd elements per (b, kv head)) and does two
// multiply-adds per element read, far below Hopper's ~295 flop/byte
// balance point. So the design keeps every cache byte read exactly once
// and spreads the reads over enough SMs to stream at the memory rate:
//
// - A thread-block cluster of C CTAs per (b, kv head): the grid is
//   (C, Hkv, B) with cluster (C, 1, 1). C comes from host integers only
//   (ops/decode_attention.py::cluster_plan: at most 96 CTAs in all, one
//   wave; spans of at least 64 positions; at most 16 a cluster), and CTA
//   rank r takes the span [r * span, (r + 1) * span) of [0, off), span =
//   ceil(off / C).
// - Each CTA holds all g query heads of its kv head (g a template
//   argument, so per-head state stays in registers). A warp reads four
//   positions per load: eight lanes per position, 16 bytes of K and of V
//   each, so a score is eight products and three shuffles. Each lane
//   issues its chunk of row loads before using any. Each group of eight
//   lanes keeps an online softmax over its positions, rescaled once per
//   chunk; the groups merge by shuffles and the warps through shared
//   memory into the CTA's state (m, l, acc[g][64]).
// - After cluster.sync(), rank 0 reads every rank's state through
//   distributed shared memory, all at once (lane r reads rank r's max and
//   normaliser), sums them in rank order, folds in the self term and
//   writes the output; it also writes the row. A second cluster.sync()
//   keeps every CTA (and its shared memory) alive until rank 0 has read
//   it. A span with nothing visible (below valid_from, or past off)
//   leaves m = -1e30, l = 0, acc = 0, which merges with weight exactly 0:
//   the self term is always there, so the final max is finite.
// - No float atomics, no workspace and one launch per call: launches are
//   bit-identical and the call captures into a CUDA graph.
//
// No Mosaic mechanics carry over (lane-routing matrices, the 8-row
// read-modify-write window): the row write is one plain 2*hd copy that
// touches no other cache byte. Positions >= off are never read, so the
// row write needs no ordering against the reads.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kGroups = 4;     // positions a warp reads per load: 8 lanes each
constexpr int kChunk = 4;      // loads per lane before any is used
constexpr int kMaxG = 8;       // query heads per kv head
constexpr int kMaxCluster = 16;  // H100's largest (non-portable) cluster
constexpr int kHd = 64;        // head dim of every GPT-2 size
constexpr int kDpl = kHd / 32; // head dims per lane in the merges
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// 8 consecutive head dims: one 16-byte load in bf16, two in f32
template <typename T>
__device__ __forceinline__ void load8(float (&x)[8], const T* p) {
  using V = Vec<T, 16 / sizeof(T)>;
  constexpr int n = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < 8; i += n) {
    const V v = *reinterpret_cast<const V*>(p + i);
#pragma unroll
    for (int j = 0; j < n; ++j) x[i + j] = to_f(v.v[j]);
  }
}

// one CTA's softmax state after its warps are merged: the running max,
// the normaliser and the unnormalised output of each query head
struct State {
  float m[kMaxG];
  float l[kMaxG];
  float acc[kMaxG][kHd];
};

// grid (C, Hkv, B), cluster (C, 1, 1), block kWarps * 32; G query heads
// per kv head.
//
// A warp reads kGroups positions per load: lane group grp = lane / 8
// takes one position and lane sub = lane % 8 its head dims [8 sub,
// 8 sub + 8) of K and of V (16-byte loads), so a score is 8 products and
// three shuffles. Each lane group keeps its own online softmax over its
// positions; the groups merge by shuffles at the end.
template <typename T, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q,       // [B, Hkv*g, hd]
                        const T* __restrict__ k_new,   // [B, Hkv, hd]
                        const T* __restrict__ v_new,   // [B, Hkv, hd]
                        T* __restrict__ kv,            // [L, B, Hkv, Smax, 2hd]
                        const int* __restrict__ valid_from,  // [B] or null
                        T* __restrict__ out,           // [B, Hkv*g, hd]
                        int B, int Hkv, int Smax, int li, int off,
                        float scale) {
  constexpr int hd = kHd;
  constexpr int DPL = kDpl;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;  // == cluster.block_rank(): grid.x == C
  const int nranks = gridDim.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 3, sub = lane & 7;
  const int H = Hkv * G;

  float qr[G][8];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    load8(qr[h], q + ((size_t)b * H + (size_t)kvh * G + h) * hd + 8 * sub);
#pragma unroll
    for (int j = 0; j < 8; ++j) qr[h][j] *= scale;
  }

  const size_t row = 2 * hd;
  T* slab = kv + (((size_t)li * B + b) * Hkv + kvh) * (size_t)Smax * row;

  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[h][j] = 0.f;
  }

  // this rank's span of [0, off), cut to the row's visible positions
  const int span = (off + nranks - 1) / nranks;
  const int start = valid_from != nullptr ? max(valid_from[b], 0) : 0;
  const int lo = max(rank * span, start);
  const int hi = min((rank + 1) * span, off);
  // each warp takes kChunk * kGroups consecutive positions per step, all
  // loads issued before any is used; lane group grp reads positions
  // p0 + kGroups * c + grp, so the groups of a warp read neighbouring rows
  constexpr int kStep = kChunk * kGroups;
  for (int p0 = lo + warp * kStep; p0 < hi; p0 += kWarps * kStep) {
    float kc[kChunk][8], vc[kChunk][8];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const T* r = slab + (size_t)min(p0 + kGroups * c + grp, hi - 1) * row;
      load8(kc[c], r + 8 * sub);
      load8(vc[c], r + hd + 8 * sub);
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float s[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) t += qr[h][j] * kc[c][j];
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
        s[c] = t;
        if (p0 + kGroups * c + grp < hi) cmax = fmaxf(cmax, s[c]);
      }
      const float m_new = fmaxf(m[h], cmax);
      const float corr = expf(m[h] - m_new);
      l[h] *= corr;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[h][j] *= corr;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (p0 + kGroups * c + grp < hi) {
          const float pe = expf(s[c] - m_new);
          l[h] += pe;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[h][j] += pe * vc[c][j];
        }
      }
      m[h] = m_new;
    }
  }

  // the lane groups merged (lanes 8 and 16 apart hold the same dims; the
  // merge is symmetric, so both lanes of a pair end with the same bits)
#pragma unroll
  for (int o = 8; o < 32; o <<= 1) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[h], o);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[h], o);
      const float mm = fmaxf(m[h], mo);
      const float cs = expf(m[h] - mm), co = expf(mo - mm);
      l[h] = l[h] * cs + lo_ * co;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[h][j], o);
        acc[h][j] = acc[h][j] * cs + ao * co;
      }
      m[h] = mm;
    }
  }

  // the warps' states, merged into this CTA's state by warp h for head h
  __shared__ float sm_m[kWarps][kMaxG];
  __shared__ float sm_l[kWarps][kMaxG];
  __shared__ float sm_acc[kWarps][kMaxG][kHd];
  __shared__ State st;
  if (grp == 0) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (lane == 0) {
        sm_m[warp][h] = m[h];
        sm_l[warp][h] = l[h];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) sm_acc[warp][h][8 * sub + j] = acc[h][j];
    }
  }
  __syncthreads();
  const int dim0 = lane * DPL;
  if (warp < G) {
    const int h = warp;
    float mc = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mc = fmaxf(mc, sm_m[w][h]);
    float lc = 0.f, a[DPL] = {};
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][h] - mc);
      lc += sm_l[w][h] * c;
#pragma unroll
      for (int j = 0; j < DPL; ++j) a[j] += sm_acc[w][h][dim0 + j] * c;
    }
    if (lane == 0) {
      st.m[h] = mc;
      st.l[h] = lc;
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) st.acc[h][dim0 + j] = a[j];
  }
  // every rank's state is written before rank 0 reads any (release /
  // acquire across the cluster)
  cluster.sync();

  const size_t new_off = ((size_t)b * Hkv + kvh) * hd;
  if (rank == 0) {
    if (warp < G) {
      const int h = warp;
      using V = Vec<T, DPL>;
      const V qv = *reinterpret_cast<const V*>(
          q + ((size_t)b * H + (size_t)kvh * G + h) * hd + dim0);
      const V kn = *reinterpret_cast<const V*>(k_new + new_off + dim0);
      const V vn = *reinterpret_cast<const V*>(v_new + new_off + dim0);
      float s_self = 0.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        s_self += to_f(qv.v[j]) * scale * to_f(kn.v[j]);
      s_self = warp_sum(s_self);
      // every rank's state read at once through distributed shared
      // memory: lane r < C holds rank r's max, normaliser and weight
      float mr = kNegInf, lr = 0.f;
      if (lane < nranks) {
        const State* rs = cluster.map_shared_rank(&st, lane);
        mr = rs->m[h];
        lr = rs->l[h];
      }
      float ar[kMaxCluster][DPL];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
#pragma unroll
        for (int j = 0; j < DPL; ++j) ar[r][j] = 0.f;
        if (r < nranks) {
          const State* rs = cluster.map_shared_rank(&st, r);
#pragma unroll
          for (int j = 0; j < DPL; ++j) ar[r][j] = rs->acc[h][dim0 + j];
        }
      }
      const float mf = fmaxf(s_self, warp_max(mr));
      const float cr = expf(mr - mf);
      // the ranks summed in rank order
      float lf = 0.f, a[DPL] = {};
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        const float lw = __shfl_sync(0xffffffffu, lr * cr, r);
        const float c = __shfl_sync(0xffffffffu, cr, r);
        if (r < nranks) {
          lf += lw;
#pragma unroll
          for (int j = 0; j < DPL; ++j) a[j] += ar[r][j] * c;
        }
      }
      const float ps = expf(s_self - mf);
      lf += ps;
      T* o = out + ((size_t)b * H + (size_t)kvh * G + h) * hd + dim0;
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        o[j] = from_f<T>((a[j] + ps * to_f(vn.v[j])) / lf);
    }
    if (warp == kWarps - 1) {
      // the in-place row write: [k_new | v_new] into position off
      T* dst = slab + (size_t)off * row;
      for (int i = lane; i < hd; i += 32) {
        dst[i] = k_new[new_off + i];
        dst[hd + i] = v_new[new_off + i];
      }
    }
  }
  // no CTA leaves (and frees its shared memory) before rank 0 has read it
  cluster.sync();
}

template <typename T, int G>
cudaError_t launch_g(const void* q, const void* k_new, const void* v_new,
                     void* kv, const void* valid_from, void* out, int B,
                     int Hkv, int Smax, int li, int off, int cluster,
                     float scale, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, G>;
  // clusters above 8 CTAs are non-portable: allowed once per kernel
  static const cudaError_t allowed = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (allowed != cudaSuccess) return allowed;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, Hkv, B);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(kv),
      static_cast<const int*>(valid_from), static_cast<T*>(out), B, Hkv,
      Smax, li, off, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k_new, const void* v_new,
                         void* kv, const void* valid_from, void* out, int B,
                         int Hkv, int g, int Smax, int li, int off,
                         int cluster, float scale, cudaStream_t stream) {
#define DA_LAUNCH(G)                                                       \
  case G:                                                                  \
    return launch_g<T, G>(q, k_new, v_new, kv, valid_from, out, B, Hkv,    \
                          Smax, li, off, cluster, scale, stream);
  switch (g) {
    DA_LAUNCH(1)
    DA_LAUNCH(2)
    DA_LAUNCH(3)
    DA_LAUNCH(4)
    DA_LAUNCH(5)
    DA_LAUNCH(6)
    DA_LAUNCH(7)
    DA_LAUNCH(8)
  }
#undef DA_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k_new, v_new, kv and out share it).
// Requires hd == 64, 1 <= g <= 8 and 1 <= cluster <= 16 (the CTAs that
// split [0, off) for each (b, kv head)). Returns the launch's cudaError_t
// (0 on success); allocates nothing.
int decode_attention_launch(const void* q, const void* k_new,
                            const void* v_new, void* kv,
                            const void* valid_from, void* out, int dtype,
                            int B, int Hkv, int g, int hd, int Smax, int li,
                            int off, int cluster, float scale, void* stream) {
  if (hd != kHd || g < 1 || g > kMaxG || cluster < 1 ||
      cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_typed<float>(q, k_new, v_new, kv, valid_from, out, B, Hkv,
                              g, Smax, li, off, cluster, scale, s);
  else if (dtype == 1)
    err = launch_typed<__nv_bfloat16>(q, k_new, v_new, kv, valid_from, out,
                                      B, Hkv, g, Smax, li, off, cluster,
                                      scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
