"""ReasonAQA-style data pipeline: the port's copy of
``mellow_tpu/train/data.py``, reading audio through the port's ``io`` and
``native``.

The reference ships no training code; its dataset schema is documented in
README.md:90-114 (list of dicts with taskname/filepath1/filepath2/caption1/
caption2/input/answer/subtype). This loader produces fixed-shape device
batches:

  audio1, audio2 : (B, 320000) float32 (repeat-padded / random-cropped,
                   identical semantics to inference preprocessing,
                   wrapper.py:141-168)
  text_ids       : (B, text_tokenization_len) int32
  answer_ids     : (B, answer_len) int32 (truncated / pad_id-padded)
  answer_mask    : (B, answer_len) float32

Host-side decode/resample uses the C++ runtime when built. Shuffling is
seeded; an epoch is a permutation. Empty ``filepath2`` (all single-audio
tasks) reuses audio 1, matching how the reference's example scripts pass
the same clip twice for single-audio tasks.
"""

from __future__ import annotations

import json
import os
import random as pyrandom
from dataclasses import dataclass
from typing import Iterator, List

import numpy as np

from mellow_tpu_torch.config import MellowConfig


@dataclass
class ReasonAQAExample:
    filepath1: str
    filepath2: str
    input: str
    answer: str
    taskname: str = ""
    subtype: str = ""


def load_json(path: str, audio_root: str = "") -> List[ReasonAQAExample]:
    with open(path) as f:
        rows = json.load(f)
    out = []
    for r in rows:
        out.append(
            ReasonAQAExample(
                filepath1=os.path.join(audio_root, r["filepath1"]),
                filepath2=os.path.join(audio_root, r["filepath2"]) if r.get("filepath2") else "",
                input=r["input"],
                answer=r["answer"],
                taskname=r.get("taskname", ""),
                subtype=r.get("subtype", ""),
            )
        )
    return out


class ReasonAQALoader:
    def __init__(
        self,
        examples: List[ReasonAQAExample],
        tokenizer,
        cfg: MellowConfig,
        batch_size: int,
        answer_len: int = 64,
        seed: int = 0,
        pad_token_id: int = 1,
        drop_remainder: bool = True,
    ):
        self.examples = examples
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.batch_size = batch_size
        self.answer_len = answer_len
        self.seed = seed
        self.pad_token_id = pad_token_id
        self.drop_remainder = drop_remainder
        self._audio_rng = pyrandom.Random(seed)

    def _load_audio(self, path: str) -> np.ndarray:
        from mellow_tpu_torch.io.resample import resample
        from mellow_tpu_torch.io.wav import read_wav
        from mellow_tpu_torch.native import binding as native

        sr_target = self.cfg.frontend.sample_rate
        need = self.cfg.frontend.num_samples
        if native.available():
            seg, full_len, needs_crop = native.load_segment(path, sr_target, need)
            if needs_crop:
                start = self._audio_rng.randrange(full_len - need)
                seg, _, _ = native.load_segment(path, sr_target, need, start)
            return seg
        data, sr = read_wav(path)
        if sr != sr_target:
            data = resample(data, sr, sr_target)
        x = data.reshape(-1)
        if need >= len(x):
            x = np.tile(x, -(-need // len(x)))[:need]
        else:
            start = self._audio_rng.randrange(len(x) - need)
            x = x[start : start + need]
        return x.astype(np.float32)

    def _encode_answer(self, text: str):
        ids = self.tokenizer.encode(text)[: self.answer_len - 1]
        ids = ids + [self.cfg.stop_token_id]  # teach EOS
        mask = [1.0] * len(ids)
        pad = self.answer_len - len(ids)
        return ids + [self.pad_token_id] * pad, mask + [0.0] * pad

    def _make_batch(self, rows: List[ReasonAQAExample]) -> dict:
        a1 = np.stack([self._load_audio(r.filepath1) for r in rows])
        a2 = np.stack(
            [self._load_audio(r.filepath2 or r.filepath1) for r in rows]
        )
        text = np.asarray(
            [
                self.tokenizer.encode_padded(r.input, self.cfg.text_tokenization_len)
                for r in rows
            ],
            np.int32,
        )
        ans, mask = zip(*(self._encode_answer(r.answer) for r in rows))
        return {
            "audio1": a1,
            "audio2": a2,
            "text_ids": text,
            "answer_ids": np.asarray(ans, np.int32),
            "answer_mask": np.asarray(mask, np.float32),
        }

    def epoch(self, epoch_idx: int = 0) -> Iterator[dict]:
        order = np.random.RandomState(self.seed + epoch_idx).permutation(
            len(self.examples)
        )
        B = self.batch_size
        for i in range(0, len(order) - (B - 1 if self.drop_remainder else 0), B):
            rows = [self.examples[j] for j in order[i : i + B]]
            if len(rows) < B and self.drop_remainder:
                break
            yield self._make_batch(rows)


class PrefetchLoader:
    """Background-thread prefetch around any batch iterator factory.

    Host-side decode/resample/tokenize is serial with the TPU step unless
    overlapped; this runs the producer in a daemon thread with a bounded
    queue (native decode and numpy release the GIL, so the overlap is real
    even on one core). The reference has no training pipeline at all; this
    is the TPU-idiomatic equivalent of a DataLoader with workers.

        loader = PrefetchLoader(ReasonAQALoader(...), depth=2)
        for batch in loader.epoch(0): ...
    """

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __getattr__(self, name):  # delegate cfg/batch_size/... to the base
        return getattr(self.loader, name)

    def epoch(self, epoch_idx: int = 0) -> Iterator[dict]:
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        _END = object()

        def produce():
            try:
                for batch in self.loader.epoch(epoch_idx):
                    q.put(batch)
                q.put(_END)
            except BaseException as e:  # surface in the consumer
                q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join()
