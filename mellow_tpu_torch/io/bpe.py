"""Vendored byte-level BPE tokenizer (GPT-2 scheme, the algorithm behind the
SmolLM2 tokenizer the reference loads via HF AutoTokenizer,
mellow/wrapper.py:84-85).

Self-contained reimplementation of the published byte-level BPE algorithm
(Sennrich et al. BPE over a reversible byte->unicode alphabet, as used by
GPT-2/SmolLM2): no network, no HF runtime dependency. Load the real
vocabulary with ``BPETokenizer.from_dir(path)`` where ``path`` contains
``vocab.json`` + ``merges.txt`` (the standard HF export: run
``tok.save_pretrained(dir)`` once wherever the hub is reachable, or point
``MELLOW_TPU_TOKENIZER`` at it). Tokenization is host-side CPU work outside
the compiled graph (SURVEY.md section 2.3).
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

# GPT-2 pre-tokenization pattern (contractions, letter runs, number runs,
# punctuation runs, trailing/other whitespace). Requires the `regex` module
# for \p{L}/\p{N} classes.
_GPT2_PATTERN = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
    r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """The reversible byte -> printable-unicode map of byte-level BPE:
    printable ASCII/Latin-1 map to themselves, the rest shift to 256+."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class BPETokenizer:
    """Byte-level BPE with the HF adapter surface used by the wrapper
    (``encode`` / ``decode`` / ``encode_padded``)."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        *,
        special_tokens: Optional[Sequence[str]] = None,
        eos_token: str = "<|endoftext|>",
        pad_token: str = "!",
        pattern: str = _GPT2_PATTERN,
    ):
        import regex

        self.vocab = dict(vocab)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.pattern = regex.compile(pattern)
        self.eos_token = eos_token
        # The reference remaps pad to the EXISTING '!' token (wrapper.py:85).
        self.pad_token = pad_token
        specials = set(special_tokens or ())
        specials.update(
            t for t in self.vocab
            if t.startswith("<|") and t.endswith("|>")
        )
        self.special_tokens = {t for t in specials if t in self.vocab}
        self._cache: Dict[str, List[str]] = {}
        if eos_token not in self.vocab:
            raise ValueError(f"eos token {eos_token!r} missing from vocab")
        if pad_token not in self.vocab:
            raise ValueError(f"pad token {pad_token!r} missing from vocab")
        self.eos_token_id = self.vocab[eos_token]
        self.pad_token_id = self.vocab[pad_token]

    # -- construction ---------------------------------------------------

    @classmethod
    def from_dir(cls, path: str) -> "BPETokenizer":
        """Load a standard HF tokenizer export: vocab.json + merges.txt,
        with optional special_tokens_map.json for the eos token."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        eos = "<|endoftext|>"
        stm = os.path.join(path, "special_tokens_map.json")
        if os.path.exists(stm):
            with open(stm, encoding="utf-8") as f:
                m = json.load(f)
            e = m.get("eos_token")
            if isinstance(e, dict):
                e = e.get("content")
            if e:
                eos = e
        return cls(vocab, merges, eos_token=eos)

    # -- core BPE -------------------------------------------------------

    def _bpe(self, token: str) -> List[str]:
        """Greedy lowest-rank merge loop over one pre-token (unicode-mapped
        bytes)."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token)
        pairs = _get_pairs(word)
        while pairs:
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            a, b = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(a, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                if j < len(word) - 1 and word[j + 1] == b:
                    new_word.append(a + b)
                    i = j + 2
                else:
                    new_word.append(word[j])
                    i = j + 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        if len(self._cache) < 50_000:
            self._cache[token] = out
        return out

    def _split_specials(self, text: str) -> List[Tuple[str, bool]]:
        """Split text into (chunk, is_special) segments, longest-first."""
        if not self.special_tokens:
            return [(text, False)]
        specials = sorted(self.special_tokens, key=len, reverse=True)
        segments: List[Tuple[str, bool]] = []
        rest = text
        while rest:
            hit, pos = None, len(rest)
            for s in specials:
                p = rest.find(s)
                if p != -1 and (p < pos or (p == pos and hit is None)):
                    hit, pos = s, p
            if hit is None:
                segments.append((rest, False))
                break
            if pos:
                segments.append((rest[:pos], False))
            segments.append((hit, True))
            rest = rest[pos + len(hit):]
        return segments

    # -- public API (HFTokenizer-compatible surface) ---------------------

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for chunk, is_special in self._split_specials(text):
            if is_special:
                ids.append(self.vocab[chunk])
                continue
            for pre in self.pattern.findall(chunk):
                mapped = "".join(
                    self.byte_encoder[b] for b in pre.encode("utf-8")
                )
                for piece in self._bpe(mapped):
                    ids.append(self.vocab[piece])
        return ids

    def decode(self, ids) -> str:
        parts: List[str] = []
        buf: List[str] = []

        def flush():
            if buf:
                data = bytes(self.byte_decoder[c] for c in "".join(buf))
                parts.append(data.decode("utf-8", errors="replace"))
                buf.clear()

        for i in ids:
            tok = self.inv_vocab.get(int(i))
            if tok is None:
                continue
            if tok in self.special_tokens:
                flush()
                parts.append(tok)
            else:
                buf.append(tok)
        flush()
        return "".join(parts)

    def encode_padded(self, text: str, max_length: int) -> List[int]:
        ids = self.encode(text)[:max_length]
        return ids + [self.pad_token_id] * (max_length - len(ids))
