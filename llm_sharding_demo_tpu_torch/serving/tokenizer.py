"""Tokenizers with no third-party dependency.

Counterpart of ``llm_sharding_demo_tpu/serving/tokenizer.py`` without its
Hugging Face path: a pure-Python GPT-2 byte-level BPE that reads the
standard ``vocab.json`` + ``merges.txt`` pair, read from a checkpoint's
``tokenizer`` directory, and the byte-level fallback (ids 0-255 are raw
bytes). The repository ships no BPE assets, so without a checkpoint that
carries them the server resolves to the byte tokenizer, as the JAX
package does without assets.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import List, Optional, Protocol

log = logging.getLogger(__name__)

# a checkpoint's tokenizer assets live in this subdirectory
TOKENIZER_SUBDIR = "tokenizer"

# stdlib-re approximation of GPT-2's \p{L}/\p{N} split pattern
RE_FALLBACK_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+"
                       r"| ?(?:[^\w\s]|_)+|\s+(?!\S)|\s+")


class Tokenizer(Protocol):
    def encode(self, text: str) -> List[int]: ...
    def decode(self, ids: List[int]) -> str: ...


def _bytes_to_unicode() -> dict:
    """GPT-2's reversible byte -> printable-unicode-char table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _get_pairs(word):
    return {(a, b) for a, b in zip(word, word[1:])}


class BPETokenizer:
    """Pure-Python GPT-2 byte-level BPE over a ``vocab.json`` +
    ``merges.txt`` pair (the split regex uses the stdlib approximation)."""

    def __init__(self, vocab: dict, merges: List[tuple]):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_enc = _bytes_to_unicode()
        self.byte_dec = {v: k for k, v in self.byte_enc.items()}
        self.cache: dict = {}
        self.pat = re.compile(RE_FALLBACK_PATTERN)
        self.unk_id = self.encoder.get("<|endoftext|>", 0)

    @classmethod
    def from_dir(cls, directory: str) -> "BPETokenizer":
        with open(os.path.join(directory, "vocab.json"),
                  encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(os.path.join(directory, "merges.txt"),
                  encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        return cls(vocab, merges)

    def _bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token)
        while len(word) > 1:
            pairs = _get_pairs(word)
            bigram = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if bigram not in self.ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = list(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in self.pat.findall(text):
            sym = "".join(self.byte_enc[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder.get(piece, self.unk_id)
                       for piece in self._bpe(sym))
        return ids

    def decode(self, ids: List[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        data = bytes(self.byte_dec[c] for c in text if c in self.byte_dec)
        return data.decode("utf-8", errors="replace")


class ByteTokenizer:
    """UTF-8 bytes <-> ids 0..255; unknown (>=256) ids decode as U+FFFD."""

    vocab_size = 256

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: List[int]) -> str:
        out = []
        run: List[int] = []  # decode contiguous byte runs together (UTF-8)
        for i in ids:
            if 0 <= i < 256:
                run.append(i)
            else:
                out.append(bytes(run).decode("utf-8", errors="replace"))
                out.append("�")  # visible marker for out-of-range ids
                run = []
        out.append(bytes(run).decode("utf-8", errors="replace"))
        return "".join(out)


def get_tokenizer(model_id: str,
                  checkpoint_dir: Optional[str] = None) -> Tokenizer:
    """The checkpoint's BPE assets (``<ckpt>/tokenizer/vocab.json`` and
    ``merges.txt``, which ``tools.convert_hf`` writes) where they are,
    else the byte-level tokenizer with a warning: its ids do not match a
    GPT-2 BPE vocab."""
    if checkpoint_dir:
        tok_dir = os.path.join(checkpoint_dir, TOKENIZER_SUBDIR)
        if os.path.exists(os.path.join(tok_dir, "vocab.json")):
            try:
                return BPETokenizer.from_dir(tok_dir)
            except Exception as e:  # noqa: BLE001 - falls back, loudly
                log.warning("BPE load from %s failed (%s)", tok_dir, e)
    log.warning("no tokenizer assets for %s; using the byte-level "
                "tokenizer — generations will NOT match the model's BPE "
                "vocab", model_id)
    return ByteTokenizer()
