"""A local Hugging Face GPT-2/llama model -> the port's checkpoint.

Counterpart of the repository's ``tools/convert_hf.py`` (which writes the
JAX package's Orbax form)::

    python -m llm_sharding_demo_tpu_torch.tools.convert_hf MODEL_DIR OUT_DIR
    python -m llm_sharding_demo_tpu_torch.tools.convert_hf MODEL_DIR OUT_DIR \\
        --dtype bfloat16

``MODEL_DIR`` is a local HF model directory (``save_pretrained`` output
with one ``model.safetensors``); nothing is downloaded and
``transformers`` is not needed. It writes ``utils.checkpoint``'s layout
and copies the tokenizer assets it finds (``vocab.json``, ``merges.txt``
and the rest) to ``OUT_DIR/tokenizer``; serve it with
``CHECKPOINT_DIR=OUT_DIR``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import torch

from ..models.hf_convert import convert_hf_dir, find_hf_dir
from ..serving.tokenizer import TOKENIZER_SUBDIR
from ..utils import checkpoint as ckpt

TOKENIZER_FILES = ("vocab.json", "merges.txt", "tokenizer.json",
                   "tokenizer_config.json", "special_tokens_map.json",
                   "tokenizer.model")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("model", help="local HF model directory")
    parser.add_argument("out_dir", help="checkpoint directory to write")
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "bfloat16"))
    args = parser.parse_args(argv)
    src = find_hf_dir(args.model)
    if src is None:
        print(f"{args.model!r} is not a local HF model directory (no "
              "config.json; nothing is downloaded)", file=sys.stderr)
        return 1
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    config, params = convert_hf_dir(src, dtype)
    print(f"converted {src}: {config}", flush=True)
    ckpt.save(args.out_dir, params, config)
    print(f"wrote checkpoint to {args.out_dir}")
    found = [f for f in TOKENIZER_FILES
             if os.path.isfile(os.path.join(src, f))]
    if found:
        tok_dir = os.path.join(args.out_dir, TOKENIZER_SUBDIR)
        os.makedirs(tok_dir, exist_ok=True)
        for f in found:
            shutil.copyfile(os.path.join(src, f), os.path.join(tok_dir, f))
        print(f"wrote tokenizer assets {found} to {tok_dir}")
    else:
        print(f"WARNING: no tokenizer assets in {src}; serving falls back "
              "to the byte tokenizer", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
