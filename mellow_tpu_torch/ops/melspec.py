"""The log-mel CUDA kernel (``csrc/melspec.cu``) bound to PyTorch.

Port of the TPU kernel ``mellow_tpu/ops/pallas_melspec.py``
(``log_mel_spectrogram_pallas``). Its plain version is
``frontend.log_mel_spectrogram``; ``frontend.log_mel_auto`` picks between
them by device. ``LAUNCHES`` counts the kernel's launches, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import torch

from mellow_tpu.config import FrontendConfig
from mellow_tpu_torch.ops import frontend as fe
from mellow_tpu_torch.ops._build import load_library

LAUNCHES = 0

# The shapes the kernel is compiled for (csrc/melspec.cu).
N_FFT = 1024
HOP = 320
N_MELS = 64


def log_mel_cuda(wave: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(B, 320000) float32 contiguous CUDA tensor -> (B, 1001, 64) log-mel,
    one launch of the fused kernel on the current stream. Raises on any
    input the kernel does not take, and on a failed launch."""
    global LAUNCHES
    if not wave.is_cuda:
        raise ValueError(f"log_mel_cuda needs a CUDA tensor, got one on {wave.device}")
    if wave.dtype != torch.float32:
        raise ValueError(f"log_mel_cuda needs float32, got {wave.dtype}")
    if (cfg.n_fft, cfg.hop_length, cfg.n_mels) != (N_FFT, HOP, N_MELS):
        raise ValueError(
            f"kernel is built for n_fft={N_FFT}, hop={HOP}, n_mels={N_MELS}; "
            f"got {cfg.n_fft}, {cfg.hop_length}, {cfg.n_mels}"
        )
    if cfg.top_db is not None:
        raise ValueError("log_mel_cuda does not apply top_db")
    if wave.ndim != 2 or wave.shape[1] != cfg.num_samples or wave.shape[0] < 1:
        raise ValueError(f"expected wave (B, {cfg.num_samples}), got {tuple(wave.shape)}")
    if not wave.is_contiguous():
        raise ValueError("log_mel_cuda needs a contiguous wave")

    lib = load_library()
    basis, fb = fe.device_tables(cfg, wave.device)
    B = wave.shape[0]
    out = torch.empty((B, cfg.num_frames, cfg.n_mels), dtype=torch.float32, device=wave.device)
    with torch.cuda.device(wave.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mellow_log_mel(
            wave.data_ptr(), basis.data_ptr(), fb.data_ptr(), out.data_ptr(),
            B, cfg.num_samples, float(cfg.amin), fe.ref_db(cfg), stream,
        )
    if err != 0:
        raise RuntimeError(f"log-mel kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out
