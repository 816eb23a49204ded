"""int8 against fp32 at full width, in both packages, on the CPU.

Not a test (pytest does not collect it): a measurement run once, by hand,
to settle whether int8's distance from fp32 at GPT-2 124M's width is the
port's or the quantization's. It imports both packages, which only the
test directory may; the port's own tools import no JAX.

On the same seeded full-width GPT-2 weights (numpy, std 0.02 as
``models.gpt2.init_params``), it teacher-forces 48 positions after a
41-token prompt and prints the logit MSE and top-1 agreement of

- the JAX package's int8 engine against its fp32 engine (its full
  no-cache forward over the run params, every position at once);
- the port's int8 plain path against its fp32 path, the same way and on
  the cached decode path (the prefill, then one cached step a token);
- each package's int8 against the other's.

Then, on seeded full-width llama-124m weights (same prompt and forced
tokens), the quantized KV pools (int8, fp8 e4m3) against fp32 as the
``kv.int8`` / ``kv.fp8`` budgets are measured (the JAX package's
``_QuantizedKVProbe``: for each position the history before its last
token prefilled exactly, its cache sent once through the pool, the last
token forwarded on the gathered cache), in each package.

Run from the repository root (a few minutes, ~4 GB):

    JAX_PLATFORMS=cpu python tests/compare_int8_width.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _report(name, approx, exact):
    a, e = np.asarray(approx, np.float64), np.asarray(exact, np.float64)
    mse = float(((a - e) ** 2).mean(axis=-1).mean())
    agree = float((a.argmax(-1) == e.argmax(-1)).mean())
    print(f"{name}: logit_mse {mse:.4e}, top1 {agree:.4f} "
          f"({a.shape[0]} positions)")
    return mse


def main() -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from llm_sharding_demo_tpu.models import gpt2 as jgpt2
    from llm_sharding_demo_tpu.runtime import engine as jengine
    from llm_sharding_demo_tpu_torch.models import gpt2
    from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
    from test_torch_model import np_gpt2_params, teacher_forced_logits

    jax.config.update("jax_default_matmul_precision", "highest")
    dims = dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12,
                n_head=12)
    tree = np_gpt2_params(seed=0, std=0.02, dims=dims)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, dims["vocab_size"], 41).tolist()
    forced = rng.integers(0, dims["vocab_size"], 48).tolist()
    seq = prompt + forced[:-1]
    rows = slice(len(prompt) - 1, None)

    jcfg = jgpt2.GPT2Config(**dims)
    jlogits = {}
    for regime in ("float32", "int8"):
        eng = jengine.DecodeEngine(jax.tree.map(jnp.asarray, tree), jcfg,
                                   max_seq=128, dtype=regime,
                                   decode_kernel="xla")
        out = jgpt2.forward(eng._run_params(), jnp.asarray([seq]), jcfg)
        jlogits[regime] = np.asarray(out, np.float32)[0, rows]
        del eng
    _report("JAX int8 vs JAX fp32 (no-cache forward)", jlogits["int8"],
            jlogits["float32"])

    cfg = gpt2.GPT2Config(**dims)
    params = params_from_numpy(tree, device="cpu")
    fwd, cached = {}, {}
    for regime in ("float32", "int8"):
        eng = DecodeEngine(params, cfg, max_seq=128, dtype=regime,
                           decode_kernel="xla", device="cpu")
        with torch.inference_mode():
            fwd[regime] = gpt2.forward(eng.params, torch.tensor([seq]),
                                       cfg)[0, rows].float().numpy()
        cached[regime] = teacher_forced_logits(eng, prompt, forced).numpy()
        del eng
    _report("port int8 vs port fp32 (no-cache forward)", fwd["int8"],
            fwd["float32"])
    _report("port int8 vs port fp32 (cached decode path)", cached["int8"],
            cached["float32"])
    _report("port fp32 vs JAX fp32 (no-cache forward)", fwd["float32"],
            jlogits["float32"])
    _report("port int8 vs JAX int8 (no-cache forward)", fwd["int8"],
            jlogits["int8"])
    kv_pools(prompt, forced)


def kv_pools(prompt, forced) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from llm_sharding_demo_tpu.models import llama as jllama
    from llm_sharding_demo_tpu.runtime import engine as jengine
    from llm_sharding_demo_tpu.runtime import kv_pool as jkv
    from llm_sharding_demo_tpu_torch.models import llama
    from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
    from llm_sharding_demo_tpu_torch.runtime.kv_pool import KVBlockPool
    from test_torch_llama import np_llama_params
    from test_torch_model import teacher_forced_logits

    dims = dict(vocab_size=32000, n_positions=4096, n_embd=768, n_layer=12,
                n_head=12, n_kv_head=4, intermediate_size=2048)
    tree = np_llama_params(seed=0, std=0.02, dims=dims)
    prompt = [t % dims["vocab_size"] for t in prompt]
    forced = [t % dims["vocab_size"] for t in forced]
    max_seq, bs = 128, 16

    jcfg = jllama.LlamaConfig(**dims)
    jeng = jengine.DecodeEngine(jax.tree.map(jnp.asarray, tree), jcfg,
                                max_seq=max_seq, decode_kernel="xla")
    params = jeng._run_params()
    seq = jnp.asarray([prompt + forced[:-1]])
    jexact = np.asarray(jllama.forward(params, seq, jcfg),
                        np.float32)[0, len(prompt) - 1:]

    def jprobe(pool):
        rows = []
        for t in range(len(forced)):
            hist = prompt + forced[:t]
            # the engine's prefill, eager: one compiled program a length
            # would take minutes at this width
            _, cache = jeng._prefill_impl(params, jnp.asarray([hist[:-1]]),
                                          None)
            row = pool.allocator.alloc(pool.nbm)
            try:
                tables = np.asarray([row], np.int32)
                pool.scatter(cache, tables)
                working = pool.gather(tables, len(hist) - 1)
                logits, _ = jeng._forward_cached(
                    params, jnp.asarray([hist[-1:]]), working, None)
            finally:
                pool.allocator.free(row)
            rows.append(np.asarray(logits, np.float32)[0, -1])
        return np.stack(rows)

    cfg = llama.LlamaConfig(**dims)
    eng = DecodeEngine(params_from_numpy(tree, device="cpu"), cfg,
                       max_seq=max_seq, device="cpu")
    exact = teacher_forced_logits(eng, prompt, forced).numpy()
    _report("llama-124m port fp32 vs JAX fp32", exact, jexact)

    def probe(pool):
        rows = []
        with torch.inference_mode():
            for t in range(len(forced)):
                hist = prompt + forced[:t]
                _, cache = eng._prefill(eng._ids([hist[:-1]]), None)
                row = pool.allocator.alloc(pool.nbm)
                try:
                    tables = np.asarray([row], np.int32)
                    pool.scatter(cache, tables)
                    working = pool.gather(tables, len(hist) - 1)
                    logits, _ = eng._forward_cached(eng._ids([hist[-1:]]),
                                                    working, None)
                finally:
                    pool.allocator.free(row)
                rows.append(logits[0, -1])
        return torch.stack(rows).float().numpy()

    for regime in ("int8", "fp8"):
        jpool = jkv.KVBlockPool.for_engine(jeng, num_blocks=2 * max_seq // bs,
                                           block_size=bs, block_dtype=regime)
        _report(f"llama-124m JAX {regime} KV pool vs JAX fp32 (probe)",
                jprobe(jpool), jexact)
        pool = KVBlockPool.for_engine(eng, num_blocks=2 * max_seq // bs,
                                      block_size=bs, block_dtype=regime)
        _report(f"llama-124m port {regime} KV pool vs port fp32 (probe)",
                probe(pool), exact)


if __name__ == "__main__":
    main()
