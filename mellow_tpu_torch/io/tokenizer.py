"""Tokenizer loading with offline fallbacks.

The reference uses the HF SmolLM2 tokenizer with pad_token remapped to '!'
(mellow/wrapper.py:84-85). Tokenization is host-side CPU work outside the
compiled graph, so we keep HF's implementation when its files are available
(hub cache or a local path) and fall back to a self-contained byte-level
tokenizer for fully-offline testing.
"""

from __future__ import annotations

from typing import List


class ByteTokenizer:
    """Deterministic offline fallback: UTF-8 bytes shifted by +2 so ids 0/1
    stay special (0 = '<|endoftext|>' like SmolLM2, 1 = pad '!'). Vocab-
    compatible with the SmolLM2 embedding table size (49152) so the model
    runs; NOT text-compatible with real SmolLM2 tokenization."""

    eos_token = "<|endoftext|>"
    pad_token = "!"
    pad_token_id = 1

    def encode(self, text: str) -> List[int]:
        if text == self.eos_token:
            return [0]
        out = []
        rest = text
        while rest:
            if rest.startswith(self.eos_token):
                out.append(0)
                rest = rest[len(self.eos_token):]
            else:
                out.append(rest[0].encode("utf-8")[0] + 2 if ord(rest[0]) < 128 else 2 + (ord(rest[0]) % 250))
                rest = rest[1:]
        return out

    def decode(self, ids) -> str:
        chars = []
        for i in ids:
            i = int(i)
            if i == 0:
                chars.append(self.eos_token)
            elif i == 1:
                chars.append("!")
            elif 2 <= i < 130:
                chars.append(chr(i - 2))
            else:
                chars.append("?")
        return "".join(chars)

    def encode_padded(self, text: str, max_length: int) -> List[int]:
        ids = self.encode(text)[:max_length]
        return ids + [self.pad_token_id] * (max_length - len(ids))


class HFTokenizer:
    """Thin adapter over a HF tokenizer with the reference's settings
    (pad '!', truncation + pad to text_tokenization_len; wrapper.py:84-85,
    181-195)."""

    def __init__(self, tok):
        self.tok = tok
        tok.add_special_tokens({"pad_token": "!"})

    def encode(self, text: str) -> List[int]:
        return self.tok.encode(text)

    def decode(self, ids) -> str:
        return self.tok.decode(ids)

    def encode_padded(self, text: str, max_length: int) -> List[int]:
        enc = self.tok.encode_plus(
            text=text,
            add_special_tokens=True,
            truncation=True,
            max_length=max_length,
            padding="max_length",
        )
        return list(enc["input_ids"])


def load_tokenizer(name_or_path: str, allow_fallback: bool = True):
    """Resolution order, offline only (unlike the JAX package's copy, this
    one never probes or contacts the hub):
      1. HF AutoTokenizer from local files / the hub cache;
      2. the vendored byte-level BPE (mellow_tpu_torch/io/bpe.py) from the
         directory named by ``MELLOW_TPU_TOKENIZER`` (a standard
         vocab.json + merges.txt export) — real text, no HF runtime;
      3. ByteTokenizer (NOT text-compatible; emits a warning).
    """
    try:
        from transformers import AutoTokenizer

        return HFTokenizer(AutoTokenizer.from_pretrained(name_or_path, local_files_only=True))
    except Exception:
        vendored = _load_vendored_bpe(name_or_path)
        if vendored is not None:
            return vendored
        if not allow_fallback:
            raise
        import warnings

        warnings.warn(
            f"Tokenizer '{name_or_path}' unavailable (offline?); using the "
            "byte-level fallback tokenizer. Text output will not match the "
            "real SmolLM2 tokenizer. Export the real vocabulary once "
            "(tok.save_pretrained(dir)) and set MELLOW_TPU_TOKENIZER=dir."
        )
        return ByteTokenizer()


def _load_vendored_bpe(name_or_path: str):
    """BPETokenizer from ``MELLOW_TPU_TOKENIZER`` or a local directory path
    containing vocab.json + merges.txt; None if neither applies."""
    import os

    for cand in (os.environ.get("MELLOW_TPU_TOKENIZER"), name_or_path):
        if cand and os.path.isfile(os.path.join(cand, "vocab.json")):
            from mellow_tpu_torch.io.bpe import BPETokenizer

            return BPETokenizer.from_dir(cand)
    return None
