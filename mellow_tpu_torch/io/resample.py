"""Polyphase windowed-sinc resampler, torchaudio-compatible.

The reference resamples with ``torchaudio.transforms.T.Resample`` defaults
(mellow/wrapper.py:146-148): sinc_interp_hann window, lowpass_filter_width 6,
rolloff 0.99. This reimplements the identical filter design from the
published algorithm (bandlimited sinc interpolation, Smith, CCRMA) in numpy,
applied as a strided correlation. Filter construction is cached per
(orig_freq, new_freq) pair after GCD reduction.

The hot batched path also exists in C++ (mellow_tpu_torch/native/src/audio.cc);
this numpy version is the reference implementation and fallback.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np


@functools.lru_cache(maxsize=16)
def _kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
            rolloff: float = 0.99) -> Tuple[np.ndarray, int]:
    """Build the polyphase filter bank.

    Returns (kernels (new_freq, width*2 + orig_freq) float32, width).
    Mirrors torchaudio's `_get_sinc_resample_kernel` (hann variant) math:
    for output phase i, taps at t = (-i/new + k/orig) * base_freq over
    k in [-width, width + orig), windowed by cos^2 (hann) and scaled.
    """
    assert lowpass_filter_width > 0
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)

    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    scale = base_freq / orig_freq
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels = kernels * window * scale
    return kernels.astype(np.float32), width


def resample(waveform: np.ndarray, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6, rolloff: float = 0.99) -> np.ndarray:
    """Resample (channels, time) or (time,) float32 waveform."""
    if orig_freq == new_freq:
        return waveform
    gcd = math.gcd(int(orig_freq), int(new_freq))
    orig, new = orig_freq // gcd, new_freq // gcd

    squeeze = waveform.ndim == 1
    x = np.atleast_2d(np.asarray(waveform, dtype=np.float32))
    C, T = x.shape
    kernels, width = _kernel(orig, new, lowpass_filter_width, rolloff)

    # torchaudio pads (width, width + orig) then runs conv1d(stride=orig);
    # conv1d is cross-correlation, so output[p, f] =
    # sum_k padded[f*orig + k] * kernels[p, k].
    target_len = int(math.ceil(new * T / orig))
    K = kernels.shape[1]  # = 2*width + orig
    xp = np.pad(x, ((0, 0), (width, width + orig)))
    num_frames = (xp.shape[1] - K) // orig + 1  # = T//orig + 1
    starts = np.arange(num_frames) * orig
    frames = xp[:, starts[:, None] + np.arange(K)[None, :]]
    # (C, num_frames, K) x (new, K) -> (C, num_frames, new)
    out = np.einsum("cfk,pk->cfp", frames, kernels, dtype=np.float64)
    out = out.reshape(C, -1)[:, :target_len].astype(np.float32)
    return out[0] if squeeze else out
