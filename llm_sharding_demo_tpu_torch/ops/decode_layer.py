"""Whole-stack decode: one token through every block in one launch.

Counterpart of ``llm_sharding_demo_tpu/ops/decode_layer.py``. One
hand-written CUDA source (``csrc/decode_layer.cu``, the model family a
template parameter) replaces both TPU megakernels there:

- ``decode_layers`` replaces ``_kernel`` (GPT-2): for each of the
  stacked blocks, LN1, the fused QKV projection, cached attention with
  the new row written into the fused cache at ``offset``, the output
  projection and residual, LN2, the MLP and its residual;
- ``decode_layers_llama`` replaces ``_llama_kernel``: RMSNorm, the q/k/v
  projections, RoPE on q and k, grouped-query attention (each kv head's
  cache rows read once for its query heads), the output projection and
  residual, RMSNorm, SwiGLU and its residual; no biases.

Each runs all of a stage's layers in one persistent launch. Each block
stages its weight slices into shared memory by TMA, a phase or more
ahead of the products that read them; ``stage_plan`` sizes that ring and
``block_slices`` mirrors the order a block reads its slices in.

Numerics are the megakernel's, not the per-layer path's: every
projection is an f32 product of upcast operands, times the int8 scale,
plus the bias in f32, rounded ONCE to the activation dtype (the
per-layer path rounds before the bias add); LN statistics and attention
are f32; gelu_new runs in f32 on the rounded product.

llama: q/k/v are rounded once each, RoPE and attention are f32 (the
self term uses the f32 rotated k, the cache row stores ``[rope(k) | v]``
rounded), and the SwiGLU is ``gate * round(sigmoid(gate))`` then
``* up``, each product rounded (the JAX kernel's bf16 ops).

Each wrapper runs its plain version (``decode_layers_plain``,
``decode_layers_llama_plain``) only for CPU tensors; for CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build as cb
from . import decode_attention as DA
from .decode_attention import KERNEL_HEAD_DIM, decode_attention_plain
from .layers import layer_norm, rms_norm
from .quant import is_quantized
from .rope import rotate_half

# the kernel's batch budget; the model takes the per-layer kernels past it
MAX_BATCH = 16
_LANE = 128

# -- the weight ring (csrc/decode_layer.cu) ----------------------------------

# the kernel's grid: two blocks on each of the H100's 132 SMs
SMS, BLOCKS_PER_SM = 132, 2
GRID = SMS * BLOCKS_PER_SM
STAGE_BYTES = 16384    # kStageBytes
MAX_STAGES = 8         # kMaxStages
RING_ALIGN = 128       # kRingAlign: the ring's alignment slack
MAX_LAYER_BOXES = 32   # kMaxLayerBoxes: a block's boxes a layer
# an SM's shared memory, and what the card keeps of it for each block
SM_SHARED_BYTES, BLOCK_RESERVED_BYTES = 233472, 1024
_THREADS, _ROW_GROUP, _HD = 256, 4, 64   # kThreads, kRowGroup, kHd
# the contraction rows a task of each weight phase (QKV, OUT, FC, PROJ)
PHASE_KC = (64, 32, 128, 128)            # kKcQkv, kKcOut, kKcFc, kKcProj


def static_smem_bytes(llama: bool) -> int:
    """The kernel's static shared memory: ``red`` (the warps' partial
    sums), the attention item's q/k/v rows and softmax states (for the
    family's query heads per item), the ring's barriers and its table of
    a layer's boxes."""
    g = LLAMA_MAX_G if llama else 1
    warps = _THREADS // 32
    return (4 * (warps * _ROW_GROUP * _LANE + (g + 2) * _HD
                 + 2 * warps * g + warps * g * _HD)
            + 8 * MAX_STAGES + 16 * MAX_LAYER_BOXES)


def _box_rows(quantized: bool) -> int:
    """Weight rows in one stage (128 int8 or 64 bf16 columns' rows)."""
    return STAGE_BYTES // (_LANE * (1 if quantized else 2))


def slice_boxes(quantized: bool, phase: int) -> int:
    """The stages one slice of weight phase ``phase`` takes."""
    return -(-PHASE_KC[phase] // _box_rows(quantized))


def stage_plan(quantized: bool, batch: int, d: int, kv_width: int,
               inter: int, llama: bool) -> Tuple[int, int, int]:
    """``(stages, stage_bytes, smem_bytes)`` of the weight ring at these
    widths: as many 16 KB stages (at most ``MAX_STAGES``) as fit beside
    the activations (``batch x d`` bf16) and the static shared memory
    with two blocks on an SM; ``smem_bytes`` is the launch's dynamic
    shared memory (the ring, its alignment slack and the activations).
    Raises where the ring would not hold the largest slice."""
    if (any(w % _LANE for w in (d, kv_width, inter))
            or not 1 <= batch <= MAX_BATCH):
        raise ValueError(f"stage_plan: widths ({d}, {kv_width}, {inter}) "
                         f"must be multiples of {_LANE} and 1 <= batch <= "
                         f"{MAX_BATCH}, got batch {batch}")
    xs = batch * d * 2
    room = (SM_SHARED_BYTES // BLOCKS_PER_SM - BLOCK_RESERVED_BYTES
            - static_smem_bytes(llama) - RING_ALIGN - xs)
    stages = min(MAX_STAGES, room // STAGE_BYTES)
    need = max(slice_boxes(quantized, ph) for ph in range(len(PHASE_KC)))
    if stages < need:
        raise ValueError(f"stage_plan: {stages} stages of {STAGE_BYTES} "
                         f"bytes fit beside {batch} x {d} activations; a "
                         f"slice takes {need}")
    return stages, STAGE_BYTES, RING_ALIGN + stages * STAGE_BYTES + xs


def phase_tiles(phase: int, d: int, kv_width: int, inter: int,
                llama: bool) -> Tuple[int, int]:
    """``(tiles, splits)`` of weight phase ``phase``: its 128-column
    output tiles (the phase's weights side by side) and contraction
    slices; task ``t`` is tile ``t % tiles`` of split ``t // tiles``."""
    n = (d + 2 * kv_width if llama else 3 * d,
         d, 2 * inter if llama else inter, d)[phase]
    k = inter if phase == 3 else d
    return n // _LANE, k // PHASE_KC[phase]


def block_slices(block: int, grid: int, n_layer: int, d: int, kv_width: int,
                 inter: int, llama: bool) -> List[Tuple[int, int, int, int]]:
    """The weight slices block ``block`` of ``grid`` reads, in the order
    it reads them and its ring stages them: ``(layer, phase, tile,
    split)``, for each layer its QKV task's slice, then OUT's, FC's and
    PROJ's, a block's tasks ``t = block, block + grid, ...`` of each
    phase in turn (the kernel's ``ring_stage``)."""
    out = []
    for layer in range(n_layer):
        for ph in range(len(PHASE_KC)):
            tiles, splits = phase_tiles(ph, d, kv_width, inter, llama)
            for t in range(block, tiles * splits, grid):
                out.append((layer, ph, t % tiles, t // tiles))
    return out


def mega_requested(decode_kernel: Optional[str], seq_len: int) -> bool:
    """Whether a forward takes the whole-stack route: a mega engine and a
    single-token input (a decode step, or a 1-token prompt's prefill)."""
    return decode_kernel == "mega" and seq_len == 1


def mega_downgrade(decode_kernel: Optional[str]) -> Optional[str]:
    """The per-layer mode a mega engine runs where the megakernel does not
    apply (a batch past ``MAX_BATCH``, a multi-token prefill)."""
    return "layer" if decode_kernel == "mega" else decode_kernel


def eligible(config, max_seq: int) -> bool:
    """Whether the megakernel applies to this GPT-2 geometry: the
    per-layer decode kernel's rule (``decode_attention.eligible``: fused
    rows of whole 128-element groups, a cache of whole 256-slot blocks)
    at the CUDA kernels' head dim (64, every GPT-2 size), plus the JAX
    package's 128-aligned width. The batch is checked per call
    (``MAX_BATCH``)."""
    return (DA.eligible(max_seq, config.head_dim, 1)
            and config.head_dim == KERNEL_HEAD_DIM
            and config.n_embd % _LANE == 0)


_WEIGHT_ORDER = (("ln_1", "scale"), ("ln_1", "bias"),
                 ("attn", "c_attn"), ("attn", "c_proj"),
                 ("ln_2", "scale"), ("ln_2", "bias"),
                 ("mlp", "c_fc"), ("mlp", "c_proj"))
# the llama kernel's operand order (the JAX kernel's): RMSNorm scales as
# tensors, each projection as (weight, scale or None, None)
_LLAMA_ORDER = (("ln_attn", "scale"), ("attn", "wq"), ("attn", "wk"),
                ("attn", "wv"), ("attn", "wo"), ("ln_mlp", "scale"),
                ("mlp", "gate"), ("mlp", "up"), ("mlp", "down"))


def _parts(blocks, order=_WEIGHT_ORDER):
    """The stacked block tree in a kernel's operand order: norm vectors
    as tensors, each projection as ``(weight, scale or None, bias or
    None)``; returns ``(parts, quantized)``. A tree that mixes int8 and
    float kernels is refused (the kernel would read codes as floats)."""
    parts, kinds = [], set()
    for group, name in order:
        if name in ("scale", "bias"):
            parts.append(blocks[group][name])
            continue
        leaf = blocks[group][name]
        w = leaf["kernel"]
        kinds.add(is_quantized(w))
        if is_quantized(w):
            parts.append((w.q, w.scale, leaf.get("bias")))
        else:
            parts.append((w, None, leaf.get("bias")))
    if len(kinds) != 1:
        raise ValueError("mixed quantized/float block kernels")
    return parts, kinds.pop()


def _layer(parts, li):
    """Layer ``li`` of every stacked part."""
    return [p[li] if isinstance(p, torch.Tensor)
            else tuple(None if t is None else t[li] for t in p)
            for p in parts]


def _mm(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The megakernel's projection: f32 product of the upcast operands,
    times the int8 scale, plus the bias (llama has none), one rounding to
    x's dtype."""
    y = torch.matmul(x.float(), w.float())
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _check(h, KV, offset, k_valid_from, n_head, n_kv_head=None):
    if h.dim() != 3 or h.shape[1] != 1:
        raise ValueError(f"megakernel is single-token only, got h "
                         f"{tuple(h.shape)}")
    b, _, d = h.shape
    if d % n_head:
        raise ValueError(f"n_embd {d} not divisible by n_head {n_head}")
    hd = d // n_head
    n_kv = n_head if n_kv_head is None else n_kv_head
    if KV.dim() != 5 or tuple(KV.shape[1:3]) != (b, n_kv) \
            or KV.shape[-1] != 2 * hd:
        raise ValueError(f"cache {tuple(KV.shape)} is not a fused "
                         f"[L, {b}, {n_kv}, Smax, {2 * hd}] cache")
    if not 0 <= offset < KV.shape[3]:
        raise ValueError(f"offset {offset} outside the {KV.shape[3]}-slot "
                         "cache")
    if k_valid_from is not None and tuple(k_valid_from.shape) != (b,):
        raise ValueError(f"k_valid_from must be [{b}], got "
                         f"{tuple(k_valid_from.shape)}")
    return b, d, hd


def decode_layers_plain(blocks, h: torch.Tensor, KV: torch.Tensor,
                        offset: int,
                        k_valid_from: Optional[torch.Tensor] = None, *,
                        n_head: int, eps: float,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (same inputs, same result):
    layer by layer, writing only row ``offset`` of each (layer, b, head)
    of the cache."""
    b, d, hd = _check(h, KV, offset, k_valid_from, n_head)
    parts, _ = _parts(blocks)
    x = h.reshape(b, d)
    for li in range(KV.shape[0]):
        ln1_s, ln1_b, qkv, out, ln2_s, ln2_b, fc, proj = _layer(parts, li)
        a = layer_norm(x, ln1_s, ln1_b, eps)
        q, k, v = (t.reshape(b, n_head, 1, hd)
                   for t in _mm(a, *qkv).split(d, dim=-1))
        attn, _ = decode_attention_plain(q, k, v, KV, li, offset,
                                         k_valid_from)
        x = x + _mm(attn.reshape(b, d), *out)
        m = layer_norm(x, ln2_s, ln2_b, eps)
        t = F.gelu(_mm(m, *fc).float(), approximate="tanh").to(x.dtype)
        x = x + _mm(t, *proj)
    return x.reshape(b, 1, d), KV


def decode_layers(blocks, h: torch.Tensor, KV: torch.Tensor, offset: int,
                  k_valid_from: Optional[torch.Tensor] = None, *,
                  n_head: int, eps: float,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the stacked GPT-2 blocks for ONE decode token.

    ``blocks``: the stacked ``[L, ...]`` block tree (bf16, or int8
    ``QuantizedTensor`` kernels with bf16 scales); ``h`` ``[B, 1, D]``
    the embedded token; ``KV`` the fused ``[L, B, H, Smax, 2*hd]`` cache,
    whose row ``offset`` is written in place; ``k_valid_from`` ([B]
    int32) masks each row's left-pad prefix. Returns ``(h [B, 1, D],
    KV)`` for ln_f and the head. CPU tensors take the plain version;
    CUDA tensors launch the kernel (bf16 activations, B <= 16, head dim
    64) or raise."""
    if h.device.type == "cpu":
        return decode_layers_plain(blocks, h, KV, offset, k_valid_from,
                                   n_head=n_head, eps=eps)
    if h.device.type != "cuda":
        raise ValueError(f"decode_layers: unsupported device {h.device}")
    b, d, hd = _check(h, KV, offset, k_valid_from, n_head)
    parts, quantized = _parts(blocks)
    _check_kernel_shape("decode_layers", h, KV, b, hd, (d,))
    n_layer = KV.shape[0]
    shapes = (d, d, (d, 3 * d), (d, d), d, d, (d, 4 * d), (4 * d, d))
    tensors = [h, KV]
    ptrs = _pointers(parts, shapes, quantized, n_layer, True, tensors)
    plan = stage_plan(quantized, b, d, d, 4 * d, False)
    n_ws = cb.DECODE_LAYERS.library.load().decode_layers_workspace_floats(
        b, d, n_head, KV.shape[3])
    ws = _workspace("decode_layers", n_ws, h, tensors, k_valid_from)
    h_out = torch.empty_like(h)
    ptr_array = (ctypes.c_void_p * len(ptrs))(*ptrs)
    cb.DECODE_LAYERS.launch(
        h.device, ctypes.addressof(ptr_array), h.data_ptr(), h_out.data_ptr(),
        KV.data_ptr(),
        None if k_valid_from is None else k_valid_from.data_ptr(),
        ws.data_ptr(), n_ws, int(quantized), n_layer, b, n_head, d,
        KV.shape[3], offset, eps, *plan, cb.stream_handle(h))
    return h_out, KV


# -- the llama family -----------------------------------------------------

# query heads per kv head the llama kernel carries through one attention
# item (csrc/decode_layer.cu, the llama family's kMaxG)
LLAMA_MAX_G = 4


def llama_eligible(config, max_seq: int) -> bool:
    """Whether the llama megakernel applies: GPT-2's rule (head_dim 64,
    a 128-aligned width, a cache of whole 256-slot blocks) plus a
    128-aligned kv width and SwiGLU hidden size, and at most
    ``LLAMA_MAX_G`` query heads per kv head."""
    return (eligible(config, max_seq)
            and (config.n_kv_head * config.head_dim) % _LANE == 0
            and config.intermediate_size % _LANE == 0
            and config.n_head // config.n_kv_head <= LLAMA_MAX_G)


def rope_rows(x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor) -> torch.Tensor:
    """Rotate f32 rows ``x`` ``[B, heads, hd]`` by per-row angles ``[B,
    hd]`` (rotate-half, f32)."""
    return x * cos[:, None] + rotate_half(x) * sin[:, None]


def _check_llama(h, KV, offset, cos, sin, k_valid_from, n_head):
    if KV.dim() != 5 or n_head % KV.shape[2]:
        raise ValueError(f"cache {tuple(KV.shape)}: its kv heads must "
                         f"divide n_head {n_head}")
    b, d, hd = _check(h, KV, offset, k_valid_from, n_head, KV.shape[2])
    for name, t in (("cos", cos), ("sin", sin)):
        if tuple(t.shape) != (b, hd) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{b}, {hd}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    return b, d, hd, KV.shape[2]


def decode_layers_llama_plain(blocks, h: torch.Tensor, KV: torch.Tensor,
                              offset: int, cos: torch.Tensor,
                              sin: torch.Tensor,
                              k_valid_from: Optional[torch.Tensor] = None,
                              *, n_head: int, eps: float,
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the llama kernel (same inputs, same
    result), op by op as the JAX ``_llama_kernel``: layer by layer,
    writing only row ``offset`` of each (layer, b, kv head)."""
    b, d, hd, n_kv = _check_llama(h, KV, offset, cos, sin, k_valid_from,
                                  n_head)
    parts, _ = _parts(blocks, _LLAMA_ORDER)
    x = h.reshape(b, d)
    for li in range(KV.shape[0]):
        ln_a, wq, wk, wv, wo, ln_m, wg, wu, wd = _layer(parts, li)
        a = rms_norm(x, ln_a, eps)
        q = _mm(a, *wq).float().reshape(b, n_head, hd)
        k = _mm(a, *wk).float().reshape(b, n_kv, hd)
        v = _mm(a, *wv).float().reshape(b, n_kv, 1, hd)
        q = rope_rows(q, cos, sin)
        k = rope_rows(k, cos, sin)
        # query head i reads kv head i // g; the row written is
        # [rope(k) | v], rounded to the cache dtype
        attn, _ = decode_attention_plain(q[:, :, None], k[:, :, None], v,
                                         KV, li, offset, k_valid_from)
        x = x + _mm(attn.reshape(b, d).to(x.dtype), *wo)
        m = rms_norm(x, ln_m, eps)
        gate = _mm(m, *wg)
        t = (gate * torch.sigmoid(gate.float()).to(gate.dtype)) * _mm(m, *wu)
        x = x + _mm(t, *wd)
    return x.reshape(b, 1, d), KV


def decode_layers_llama(blocks, h: torch.Tensor, KV: torch.Tensor,
                        offset: int, cos: torch.Tensor, sin: torch.Tensor,
                        k_valid_from: Optional[torch.Tensor] = None, *,
                        n_head: int, eps: float,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the stacked llama blocks for ONE decode token.

    ``blocks``: the stacked ``[L, ...]`` llama block tree (bf16, or int8
    ``QuantizedTensor`` kernels with bf16 scales); ``h`` ``[B, 1, D]``;
    ``KV`` the fused ``[L, B, Hkv, Smax, 2*hd]`` cache, row ``offset``
    written in place; ``cos``/``sin`` the step's rotary angles ``[B,
    hd]`` float32 (``ops.rope`` convention); ``k_valid_from`` ([B]
    int32) masks each row's left-pad prefix. CPU tensors take the plain
    version; CUDA tensors launch the kernel (bf16 activations, B <= 16,
    head dim 64, at most ``LLAMA_MAX_G`` query heads per kv head) or
    raise."""
    if h.device.type == "cpu":
        return decode_layers_llama_plain(blocks, h, KV, offset, cos, sin,
                                         k_valid_from, n_head=n_head,
                                         eps=eps)
    if h.device.type != "cuda":
        raise ValueError(f"decode_layers_llama: unsupported device "
                         f"{h.device}")
    b, d, hd, n_kv = _check_llama(h, KV, offset, cos, sin, k_valid_from,
                                  n_head)
    parts, quantized = _parts(blocks, _LLAMA_ORDER)
    kvw = n_kv * hd
    inter = parts[6][0].shape[-1]
    _check_kernel_shape("decode_layers_llama", h, KV, b, hd, (d, kvw, inter))
    if n_head // n_kv > LLAMA_MAX_G:
        raise ValueError(f"decode_layers_llama kernel carries at most "
                         f"{LLAMA_MAX_G} query heads per kv head, got "
                         f"{n_head // n_kv}")
    n_layer = KV.shape[0]
    shapes = (d, (d, d), (d, kvw), (d, kvw), (d, d), d, (d, inter),
              (d, inter), (inter, d))
    tensors = [h, KV, cos, sin]
    ptrs = _pointers(parts, shapes, quantized, n_layer, False, tensors)
    plan = stage_plan(quantized, b, d, kvw, inter, True)
    lib = cb.DECODE_LAYERS_LLAMA.library.load()
    n_ws = lib.decode_layers_llama_workspace_floats(b, d, n_head, n_kv, inter,
                                                    KV.shape[3])
    ws = _workspace("decode_layers_llama", n_ws, h, tensors, k_valid_from)
    h_out = torch.empty_like(h)
    ptr_array = (ctypes.c_void_p * len(ptrs))(*ptrs)
    cb.DECODE_LAYERS_LLAMA.launch(
        h.device, ctypes.addressof(ptr_array), h.data_ptr(), h_out.data_ptr(),
        KV.data_ptr(),
        None if k_valid_from is None else k_valid_from.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), ws.data_ptr(), n_ws, int(quantized),
        n_layer, b, n_head, n_kv, d, inter, KV.shape[3], offset, eps, *plan,
        cb.stream_handle(h))
    return h_out, KV


# -- operand checks shared by both wrappers --------------------------------

def _check_kernel_shape(name, h, KV, b, hd, widths) -> None:
    if h.dtype != torch.bfloat16 or KV.dtype != torch.bfloat16:
        raise ValueError(f"{name} kernel takes bfloat16 activations and "
                         f"cache, got {h.dtype} / {KV.dtype}")
    if not 1 <= b <= MAX_BATCH or hd != KERNEL_HEAD_DIM or any(
            w % _LANE for w in widths):
        raise ValueError(f"{name} kernel needs 1 <= B <= {MAX_BATCH}, "
                         f"head_dim {KERNEL_HEAD_DIM} and widths % {_LANE} "
                         f"== 0, got B={b} hd={hd} widths={widths}")


def _pointers(parts, shapes, quantized, n_layer, biased, tensors):
    """The kernel's operand pointers in ``parts`` order, each operand
    checked against its stacked shape (a vector's width, a projection's
    ``(rows, width)``) and appended to ``tensors``: per projection the
    weight, its scale (null for bf16 weights) and, for GPT-2, its
    bias."""
    ptrs = []
    for p, shape in zip(parts, shapes):
        if isinstance(p, torch.Tensor):
            _expect(p, (n_layer, shape), torch.bfloat16, "norm parameter")
            tensors.append(p)
            ptrs.append(p.data_ptr())
            continue
        (k, width), (w, scale, bias) = shape, p
        _expect(w, (n_layer, k, width),
                torch.int8 if quantized else torch.bfloat16, "weight")
        # the tensor maps' base and row stride (a stage's view of the
        # stacked weights starts layers in)
        if w.data_ptr() % 16 or w.stride(1) * w.element_size() % 16:
            raise ValueError(f"megakernel: a weight's base and rows must "
                             f"sit on 16 bytes, got base {w.data_ptr():#x}"
                             f", rows of {w.stride(1) * w.element_size()} "
                             "bytes")
        if scale is not None:
            _expect(scale, (n_layer, width), torch.bfloat16, "scale")
        ptrs += [w.data_ptr(), None if scale is None else scale.data_ptr()]
        if biased:
            _expect(bias, (n_layer, width), torch.bfloat16, "bias")
            ptrs.append(bias.data_ptr())
        elif bias is not None:
            raise ValueError("the llama kernel takes no biases")
        tensors += [t for t in (w, scale, bias) if t is not None]
    return ptrs


def _workspace(name, n_ws, h, tensors, k_valid_from) -> torch.Tensor:
    """Check every operand's device and layout, then allocate the
    kernel's f32 scratch (split partial sums, softmax states), whose
    size comes from the kernel source."""
    if k_valid_from is not None:
        if k_valid_from.dtype != torch.int32:
            raise ValueError("k_valid_from must be int32")
        tensors.append(k_valid_from)
    for t in tensors:
        if t.device != h.device or not t.is_contiguous():
            raise ValueError(f"{name} operands must be contiguous and on "
                             "one CUDA device")
    if n_ws < 0:
        raise ValueError(f"{name}: workspace exceeds 2**31 floats")
    return torch.empty(n_ws, dtype=torch.float32, device=h.device)


def _expect(t: torch.Tensor, shape, dtype, what: str) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"megakernel: {what} must be {dtype} "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
