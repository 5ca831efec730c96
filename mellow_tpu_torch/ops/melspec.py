"""The log-mel CUDA kernel (``csrc/melspec.cu``) bound to PyTorch.

Port of the TPU kernel ``mellow_tpu/ops/pallas_melspec.py``
(``log_mel_spectrogram_pallas``). Its plain version is
``frontend.log_mel_spectrogram``; ``frontend.log_mel_auto`` picks between
them by device. ``LAUNCHES`` counts the kernel's launches, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import torch

from mellow_tpu_torch.config import FrontendConfig
from mellow_tpu_torch.ops import frontend as fe
from mellow_tpu_torch.ops._build import check, load_library, refuse_grad
from mellow_tpu_torch.utils.debug import check_outputs

LAUNCHES = 0
KERNELS_PER_CALL = 1

# The shapes the kernel is compiled for (csrc/melspec.cu).
N_FFT = 1024
HOP = 320
N_MELS = 64


def log_mel_cuda(wave: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(B, T) float32 contiguous CUDA tensor -> (B, 1 + T // 320, 64)
    log-mel (T = 320,000 gives the 1001 frames of a 10 s clip), one launch
    of the fused FFT kernel on the current stream. T is any length of at least
    n_fft // 2 + 1 samples, what the reflect padding needs. Raises on any
    input the kernel does not take, and on a failed launch."""
    global LAUNCHES
    refuse_grad("log_mel_cuda", wave)
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
    if wave.ndim != 2 or wave.shape[1] < N_FFT // 2 + 1 or wave.shape[0] < 1:
        raise ValueError(f"expected wave (B, T) with T >= {N_FFT // 2 + 1}, got {tuple(wave.shape)}")
    if not wave.is_contiguous():
        raise ValueError("log_mel_cuda needs a contiguous wave")

    lib = load_library()
    window, twiddles, bands, band_w = fe.fft_tables(cfg, wave.device)
    B, T = wave.shape
    out = torch.empty((B, 1 + T // HOP, N_MELS), dtype=torch.float32, device=wave.device)
    with torch.cuda.device(wave.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mellow_log_mel(
            wave.data_ptr(), window.data_ptr(), twiddles.data_ptr(), bands.data_ptr(),
            band_w.data_ptr(), band_w.shape[1], out.data_ptr(), B, T, float(cfg.amin),
            fe.ref_db(cfg), stream,
        )
    check(err, "log-mel kernel")
    LAUNCHES += 1
    check_outputs("log_mel_cuda", out)
    return out
