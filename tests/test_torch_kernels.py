"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Skipped where there is no CUDA device. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -o addopts="" tests/test_torch_kernels.py

Tolerance: atol 5e-4 dB / rtol 1e-4, what the TPU kernel is held to
(fp32 DFT sums of 1024 terms in another order)."""

import numpy as np
import pytest
import torch

from mellow_tpu.config import FrontendConfig
from mellow_tpu_torch.ops import frontend as fe
from mellow_tpu_torch.ops import melspec

pytestmark = pytest.mark.cuda

CFG = FrontendConfig()


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _wave(b, seed, device):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(b, CFG.num_samples) * 0.1).astype(np.float32)).to(device)


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_log_mel_kernel_matches_plain_version(device, batch):
    wave = _wave(batch, batch, device)
    out = melspec.log_mel_cuda(wave, CFG)
    torch.cuda.synchronize()
    ref = fe.log_mel_spectrogram(wave, CFG)
    assert out.shape == (batch, 1001, 64)
    torch.testing.assert_close(out, ref, atol=5e-4, rtol=1e-4)


def test_log_mel_auto_launches_the_kernel_on_cuda(device):
    wave = _wave(1, 7, device)
    before = melspec.LAUNCHES
    out = fe.log_mel_auto(wave, CFG)
    assert melspec.LAUNCHES == before + 1
    torch.testing.assert_close(out, fe.log_mel_spectrogram(wave, CFG), atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize(
    "make",
    [
        lambda w: w.double(),
        lambda w: w[:, : CFG.num_samples // 2],
        lambda w: torch.cat([w, w], dim=1)[:, ::2],
    ],
    ids=["float64", "short", "strided"],
)
def test_log_mel_kernel_rejects_what_it_does_not_take(device, make):
    with pytest.raises(ValueError):
        melspec.log_mel_cuda(make(_wave(1, 8, device)), CFG)
