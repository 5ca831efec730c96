"""Log-mel front-end in PyTorch: waveform -> (B, 256, 256) spectrogram image.

Port of ``mellow_tpu/ops/frontend.py``. The constant tables are numpy
copies of the JAX module's (that module imports jax, which the port never
does); ``tests/test_torch_frontend.py`` holds them bit-equal. Framing is
``center=True`` with numpy-style ``reflect`` padding (the edge sample is not
repeated), giving ``1 + T // hop`` frames (1001 at 320,000 samples).

``log_mel_auto`` dispatches by device: a CUDA tensor always goes through the
hand-written kernel (``ops/melspec.py``), a CPU tensor through the plain
version ``log_mel_spectrogram``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from mellow_tpu.config import FrontendConfig


# ---------------------------------------------------------------------------
# constants (numpy, float64 math, cached per config)
# ---------------------------------------------------------------------------

def hann_window(n: int) -> np.ndarray:
    """Periodic ('fftbins') Hann window, as torchlibrosa uses."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float64)


@functools.lru_cache(maxsize=4)
def dft_basis(n_fft: int) -> np.ndarray:
    """Windowed real-DFT basis, (n_fft, 2*n_bins): columns are
    [cos_k ... | -sin_k ...] times the Hann window, so frames @ basis gives
    the [real | imag] parts of the onesided FFT."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    win = hann_window(n_fft)[:, None]
    real = np.cos(ang) * win
    imag = -np.sin(ang) * win
    return np.concatenate([real, imag], axis=1).astype(np.float32)


def hz_to_mel(hz):
    """Slaney mel scale (librosa htk=False): linear below 1 kHz,
    logarithmic above."""
    hz = np.asarray(hz, dtype=np.float64)
    f_sp = 200.0 / 3.0
    mel = hz / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = hz >= min_log_hz
    mel = np.where(log_region, min_log_mel + np.log(np.maximum(hz, 1e-10) / min_log_hz) / logstep, mel)
    return mel


def mel_to_hz(mel):
    mel = np.asarray(mel, dtype=np.float64)
    f_sp = 200.0 / 3.0
    hz = mel * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mel >= min_log_mel
    hz = np.where(log_region, min_log_hz * np.exp(logstep * (mel - min_log_mel)), hz)
    return hz


@functools.lru_cache(maxsize=4)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank, (n_bins, n_mels)
    (librosa.filters.mel(htk=False, norm='slaney'))."""
    n_bins = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))

    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]  # (n_mels+2, n_bins)

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))  # (n_mels, n_bins)

    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)  # (n_bins, n_mels)


def cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """PyTorch's bicubic convolution kernel (a = -0.75)."""
    ax = np.abs(x)
    w = np.where(
        ax <= 1.0,
        (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0,
        np.where(ax < 2.0, a * ax**3 - 5.0 * a * ax**2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )
    return w


@functools.lru_cache(maxsize=4)
def bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) matrix reproducing torch's 1-D cubic interpolation with
    align_corners=True (the 1001 -> 1024 time resize). torch computes the
    source position and the polynomial weights in float32, so this does
    too, step by step (float64 drifts up to ~3e-4 at high frame indices)."""
    W = np.zeros((n_out, n_in), dtype=np.float64)
    scale = (
        np.float32(n_in - 1) / np.float32(n_out - 1) if n_out > 1 else np.float32(0.0)
    )
    A = np.float32(-0.75)
    one, five, eight, four = (np.float32(v) for v in (1.0, 5.0, 8.0, 4.0))

    def cc1(x):  # |x| <= 1 branch, torch cubic_convolution1, fp32
        x = np.float32(x)
        return ((A + np.float32(2.0)) * x - (A + np.float32(3.0))) * x * x + one

    def cc2(x):  # 1 < |x| < 2 branch, torch cubic_convolution2, fp32
        x = np.float32(x)
        return ((A * x - five * A) * x + eight * A) * x - four * A

    for i in range(n_out):
        src = np.float32(np.float32(i) * scale)
        f = int(np.floor(src))
        t = np.float32(src - np.float32(f))
        coeffs = [cc2(t + one), cc1(t), cc1(one - t), cc2(np.float32(2.0) - t)]
        for off, wj in zip((-1, 0, 1, 2), coeffs):
            j = min(max(f + off, 0), n_in - 1)
            W[i, j] += float(wj)
    return W.astype(np.float32)


def ref_db(cfg: FrontendConfig) -> float:
    """The dB offset subtracted after the log (0 at the default ref=1)."""
    return float(10.0 * np.log10(np.maximum(cfg.amin, cfg.ref)))


@functools.lru_cache(maxsize=8)
def device_tables(cfg: FrontendConfig, device: torch.device):
    """The windowed DFT basis (n_fft, 2*n_bins) and the mel filterbank
    (n_bins, n_mels) as row-major float32 tensors on ``device``, made once
    per config and device. (``mel_filterbank`` returns a transposed,
    column-major array; the CUDA kernel indexes both row-major.)"""
    basis = torch.from_numpy(dft_basis(cfg.n_fft)).to(device).contiguous()
    fb = torch.from_numpy(
        mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    ).to(device).contiguous()
    return basis, fb


# ---------------------------------------------------------------------------
# torch ops
# ---------------------------------------------------------------------------

def frame_signal(x: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(B, T) -> (B, 1 + T // hop, n_fft) frames of the reflect-padded wave."""
    pad = cfg.n_fft // 2
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
    return x.unfold(-1, cfg.n_fft, cfg.hop_length)


def power_spectrogram(x: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(B, T) waveform -> (B, n_frames, n_bins) power spectrum |STFT|^2, the
    windowed DFT as one matmul against ``dft_basis``."""
    basis, _ = device_tables(cfg, x.device)
    proj = frame_signal(x, cfg) @ basis  # (B, F, 2*n_bins)
    re, im = proj.chunk(2, dim=-1)
    return re * re + im * im


def logmel(power: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Power spectrum -> log-mel (torchlibrosa LogmelFilterBank:
    10*log10(max(mel, amin)) - ref_db, optional top_db floor)."""
    _, fb = device_tables(cfg, power.device)
    out = 10.0 * torch.log10(torch.clamp(power @ fb, min=cfg.amin)) - ref_db(cfg)
    if cfg.top_db is not None:
        out = torch.maximum(out, out.max() - cfg.top_db)
    return out


def log_mel_spectrogram(wave: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Plain version of the log-mel kernel: (B, 320000) -> (B, 1001, 64)."""
    return logmel(power_spectrogram(wave, cfg), cfg)


def log_mel_auto(wave: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Log-mel dispatched by device: the CUDA kernel for a CUDA tensor (at
    any batch; it raises on shapes it does not take), the plain version
    otherwise."""
    if wave.is_cuda:
        from mellow_tpu_torch.ops.melspec import log_mel_cuda

        return log_mel_cuda(wave, cfg)
    return log_mel_spectrogram(wave, cfg)


def batchnorm_mel(x: torch.Tensor, bn: dict, eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BatchNorm over the mel axis. x: (B, T, n_mels)."""
    return (x - bn["mean"]) * torch.rsqrt(bn["var"] + eps) * bn["scale"] + bn["bias"]


def resize_time_bicubic(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """(B, T, F) -> (B, n_out, F) cubic resize along time (torch
    align_corners=True), as one matmul with ``bicubic_matrix``."""
    W = torch.from_numpy(bicubic_matrix(x.shape[1], n_out)).to(x.device)
    return torch.einsum("ot,btf->bof", W, x)


def fold_time_to_freq(x: torch.Tensor, freq_ratio: int) -> torch.Tensor:
    """(B, T=1024, F=64) -> (B, freq_ratio*F=256, T/freq_ratio=256), rows
    indexed (time chunk, mel), columns the time within the chunk."""
    B, T, F_ = x.shape
    chunk = T // freq_ratio
    x = x.transpose(1, 2).reshape(B, F_, freq_ratio, chunk)
    return x.transpose(1, 2).reshape(B, freq_ratio * F_, chunk)


def frontend_image(
    wave: torch.Tensor,
    fe_cfg: FrontendConfig,
    bn0: dict,
    freq_ratio: int,
    target_frames: int,
) -> torch.Tensor:
    """Eval front-end: waveform -> (B, 256, 256) image for the patch embed."""
    x = log_mel_auto(wave, fe_cfg)  # (B, 1001, 64)
    x = batchnorm_mel(x, bn0)
    x = resize_time_bicubic(x, target_frames)  # (B, 1024, 64)
    return fold_time_to_freq(x, freq_ratio)  # (B, 256, 256)
