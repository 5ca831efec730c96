"""The general traffic generator: a mix's parameters (``traffic/<mix>.json``)
and a configuration -> a pool of seeded batches in host memory, as the
program's host preprocessing hands them to the model: two float32 clips a
request, (B, samples) each, and the prompt's token ids right-padded to the
configuration's text positions, (B, T) int32.

Parameters a mix file gives (``KEYS``; any other key is refused):
  about: a line on who sends such traffic;
  batch: requests a call; greedy: true;
  max_len: tokens a request, one number for every call, or [low, high]:
    the pool's batches then take ``pool_batches`` sizes spread evenly over
    [low, high], in an order drawn from the seed (every seed the same set
    of sizes);
  clip_seconds, sample_rate: the clips' length and rate;
  prompt_tokens_min, prompt_tokens_max: the prompt's real ids, drawn
    uniformly per request (the rest is the pad id);
  pool_batches: distinct batches made before the window and cycled;
  check_requests: requests the correctness check samples after the window;
  trace_calls: steady calls a traced run profiles after the window.

The harness drives the pool with one client in a closed loop, batches
handed back to back. A mix that needs code adds ``traffic/<mix>.py``
beside its file: its ``make_pool`` replaces this one, its ``drive`` the
harness's loop, and its ``KEYS`` adds to the keys allowed.

Each clip is seeded noise at a gain drawn in [0.01, 0.2] plus three tones
(50 Hz to 8 kHz, amplitudes in [0.02, 0.3]), clipped to [-1, 1]; token ids
are uniform over the vocabulary above the stop and pad ids. Every seed gives
the same sizes (the prompt is padded), in other values. The waves are made
on the device in a few large calls and copied to pageable host memory.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

TONES = 3
KEYS = frozenset(("about", "batch", "max_len", "greedy", "clip_seconds", "sample_rate", "prompt_tokens_min",
                  "prompt_tokens_max", "pool_batches", "check_requests", "trace_calls"))


class Batch(NamedTuple):
    wave1: np.ndarray  # (B, samples) float32
    wave2: np.ndarray
    text_ids: np.ndarray  # (B, T) int32
    max_len: int  # tokens each request of the call is served


def max_lens(mix: dict, gen: torch.Generator, device) -> list:
    """Each pool batch's ``max_len``: the mix's one number, or
    ``pool_batches`` sizes spread evenly over [low, high] in an order
    drawn from ``gen``."""
    n, m = mix["pool_batches"], mix["max_len"]
    if isinstance(m, int):
        return [m] * n
    low, high = m
    sizes = [low + round(i * (high - low) / max(n - 1, 1)) for i in range(n)]
    return [sizes[i] for i in torch.randperm(n, generator=gen, device=device).tolist()]


def _clips(n: int, samples: int, rate: int, gen: torch.Generator, device) -> torch.Tensor:
    u = torch.rand((n, 2 + 3 * TONES), generator=gen, device=device, dtype=torch.float64)
    gain = 0.01 + 0.19 * u[:, :1]
    freq = 50.0 + (8000.0 - 50.0) * u[:, 2:2 + TONES]
    amp = 0.02 + 0.28 * u[:, 2 + TONES:2 + 2 * TONES]
    phase = 2 * math.pi * u[:, 2 + 2 * TONES:]
    x = torch.randn((n, samples), generator=gen, device=device, dtype=torch.float32) * gain.float()
    t = torch.arange(samples, device=device, dtype=torch.float64) / rate
    for k in range(TONES):  # (n, samples) at a time, the angle in float64
        ang = (2 * math.pi * freq[:, k:k + 1]) * t[None] + phase[:, k:k + 1]
        x += (amp[:, k:k + 1] * torch.sin(torch.remainder(ang, 2 * math.pi))).float()
    return x.clamp_(-1.0, 1.0)


def make_pool(mix: dict, cfg: dict, seed: int, device) -> list:
    """``mix["pool_batches"]`` batches from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    B, T = mix["batch"], cfg["text_tokenization_len"]
    samples = mix["clip_seconds"] * mix["sample_rate"]
    low, V = max(cfg["stop_token_id"], cfg["pad_token_id"]) + 1, cfg["decoder"]["vocab_size"]
    pool = []
    for max_len in max_lens(mix, gen, device):
        waves = _clips(2 * B, samples, mix["sample_rate"], gen, device).cpu().numpy()
        ids = torch.randint(low, V, (B, T), generator=gen, device=device, dtype=torch.int32)
        n = torch.randint(mix["prompt_tokens_min"], mix["prompt_tokens_max"] + 1, (B, 1), generator=gen,
                          device=device)
        ids = torch.where(torch.arange(T, device=device)[None] < n, ids, cfg["pad_token_id"])
        pool.append(Batch(waves[:B], waves[B:], ids.cpu().numpy(), max_len))
    return pool
