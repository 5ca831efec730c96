"""Torch-free RIFF/WAVE reader.

Replaces the reference's torchaudio C++ loader (mellow/wrapper.py:144) for
the common on-disk formats (PCM 8/16/24/32-bit, IEEE float32/64, WAVE_FORMAT_
EXTENSIBLE). Returns (channels, samples) float32 in [-1, 1] with torchaudio's
normalization convention (divide by 2**(bits-1)).

A C++ fast path (mellow_tpu_torch/native) handles decode+resample for the batched
serving data loader; this pure-Python reader is the portable fallback and the
correctness reference for it.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_PCM = 1
_IEEE_FLOAT = 3
_EXTENSIBLE = 0xFFFE


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (data (channels, n_samples) float32, sample_rate)."""
    with open(path, "rb") as f:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")

        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", hdr)
            if cid == b"fmt ":
                fmt = f.read(csize)
            elif cid == b"data":
                data = f.read(csize)
            else:
                f.seek(csize, 1)
            if csize % 2:  # chunks are word-aligned
                f.seek(1, 1)
            if fmt is not None and data is not None:
                break

        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")

        (audio_format, channels, sample_rate, _byte_rate, _block_align,
         bits) = struct.unpack("<HHIIHH", fmt[:16])
        if audio_format == _EXTENSIBLE:
            # SubFormat GUID: first 2 bytes are the real format code.
            audio_format = struct.unpack("<H", fmt[24:26])[0]

        if audio_format == _PCM:
            if bits == 8:
                x = np.frombuffer(data, np.uint8).astype(np.float32)
                x = (x - 128.0) / 128.0
            elif bits == 16:
                x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
            elif bits == 24:
                raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
                ints = (
                    raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16)
                )
                ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
                x = ints.astype(np.float32) / float(1 << 23)
            elif bits == 32:
                x = np.frombuffer(data, "<i4").astype(np.float32) / float(1 << 31)
            else:
                raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
        elif audio_format == _IEEE_FLOAT:
            if bits == 32:
                x = np.frombuffer(data, "<f4").astype(np.float32)
            elif bits == 64:
                x = np.frombuffer(data, "<f8").astype(np.float32)
            else:
                raise ValueError(f"{path}: unsupported float bit depth {bits}")
        else:
            raise ValueError(f"{path}: unsupported WAVE format code {audio_format}")

        n = (len(x) // channels) * channels
        return x[:n].reshape(-1, channels).T.copy(), sample_rate
