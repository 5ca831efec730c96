"""The port's front-end (mellow_tpu_torch.ops.frontend) against the JAX
package's, on seeded numpy inputs.

Tables are held bit-equal; the log-mel within the tolerance the Pallas
kernel is held to (atol 5e-4 dB, rtol 1e-4: fp32 sums of 1024 terms in
another order); the spectrogram image within 1e-4."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mellow_tpu.config import FrontendConfig, HTSATConfig, LlamaConfig
from mellow_tpu.models import htsat as jhtsat
from mellow_tpu.models import llama as jllama
from mellow_tpu.ops import frontend as jfe
from mellow_tpu.ops.pallas_melspec import log_mel_spectrogram_pallas
from mellow_tpu_torch.models import htsat as thtsat
from mellow_tpu_torch.models import llama as tllama
from mellow_tpu_torch.ops import frontend as tfe
from mellow_tpu_torch.ops import melspec

CFG = FrontendConfig()


def _waves(b, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, CFG.num_samples) * 0.1).astype(np.float32)


@pytest.mark.parametrize(
    "name, args",
    [
        ("hann_window", (1024,)),
        ("dft_basis", (1024,)),
        ("hz_to_mel", (np.linspace(0.0, 16000.0, 97),)),
        ("mel_to_hz", (np.linspace(0.0, 60.0, 97),)),
        ("mel_filterbank", (32000, 1024, 64, 50.0, 14000.0)),
        ("cubic_kernel", (np.linspace(-2.5, 2.5, 101),)),
        ("bicubic_matrix", (1001, 1024)),
    ],
)
def test_frontend_tables_bit_equal(name, args):
    ours = getattr(tfe, name)(*args)
    theirs = getattr(jfe, name)(*args)
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("resolution, ws, shift", [(64, 8, 4), (32, 8, 4), (16, 8, 4)])
def test_swin_tables_bit_equal(resolution, ws, shift):
    np.testing.assert_array_equal(
        thtsat.relative_position_index(ws), jhtsat.relative_position_index(ws)
    )
    np.testing.assert_array_equal(
        thtsat.shifted_window_mask(resolution, ws, shift),
        jhtsat.shifted_window_mask(resolution, ws, shift),
    )


def test_rope_tables_bit_equal():
    cfg = LlamaConfig()
    for ours, theirs in zip(tllama.rope_tables(cfg, 421), jllama.rope_tables(cfg, 421)):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


def test_frame_signal_matches_jax():
    wave = _waves(2, 3)[:, :5000]  # any length: 1 + T // hop frames
    ours = tfe.frame_signal(torch.from_numpy(wave), CFG).numpy()
    theirs = np.asarray(jfe.frame_signal(jnp.asarray(wave), CFG))
    assert ours.shape == theirs.shape == (2, 1 + 5000 // CFG.hop_length, CFG.n_fft)
    np.testing.assert_array_equal(ours, theirs)


def test_log_mel_matches_jax_reference():
    wave = _waves(2, 0)
    ours = tfe.log_mel_spectrogram(torch.from_numpy(wave), CFG).numpy()
    theirs = np.asarray(jfe.log_mel_spectrogram(jnp.asarray(wave), CFG))
    assert ours.shape == theirs.shape == (2, 1001, 64)
    np.testing.assert_allclose(ours, theirs, atol=5e-4, rtol=1e-4)


def test_log_mel_matches_pallas_kernel_interpret():
    wave = _waves(1, 1)
    ours = tfe.log_mel_spectrogram(torch.from_numpy(wave), CFG).numpy()
    theirs = np.asarray(log_mel_spectrogram_pallas(jnp.asarray(wave), CFG, interpret=True))
    assert ours.shape == theirs.shape == (1, 1001, 64)
    np.testing.assert_allclose(ours, theirs, atol=5e-4, rtol=1e-4)


def test_frontend_image_matches_jax():
    rng = np.random.RandomState(2)
    wave = _waves(2, 2)
    bn0 = {
        "scale": (1.0 + 0.1 * rng.randn(64)).astype(np.float32),
        "bias": (0.1 * rng.randn(64)).astype(np.float32),
        "mean": (rng.randn(64)).astype(np.float32),
        "var": (rng.rand(64) * 2 + 0.5).astype(np.float32),
    }
    enc = HTSATConfig()
    ours = tfe.frontend_image(
        torch.from_numpy(wave), CFG, {k: torch.from_numpy(v) for k, v in bn0.items()},
        enc.freq_ratio, enc.target_frames,
    ).numpy()
    theirs = np.asarray(jfe.frontend_image(
        jnp.asarray(wave), CFG, {k: jnp.asarray(v) for k, v in bn0.items()},
        enc.freq_ratio, enc.target_frames,
    ))
    assert ours.shape == theirs.shape == (2, 256, 256)
    np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-4)


def test_log_mel_auto_uses_plain_version_on_cpu():
    wave = torch.from_numpy(_waves(1, 4))
    before = melspec.LAUNCHES
    torch.testing.assert_close(
        tfe.log_mel_auto(wave, CFG), tfe.log_mel_spectrogram(wave, CFG), rtol=0, atol=0
    )
    assert melspec.LAUNCHES == before


def test_log_mel_cuda_rejects_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        melspec.log_mel_cuda(torch.zeros(1, CFG.num_samples), CFG)


@pytest.mark.parametrize("name", ["v0", "test_torch_tiny"])
def test_fft_tables_cover_the_filterbank(name):
    """The log-mel kernel's mel bands (``frontend.fft_tables``) at a
    registered configuration's front-end: every nonzero of
    ``mel_filterbank`` lies in its filter's (first, last) bins, and the band
    weights rebuild the filterbank exactly; the window and twiddles are the
    float64 tables rounded once."""
    import tests.torch_port_common  # noqa: F401  (registers the tiny config in the port's registry)
    from mellow_tpu_torch.config import get_config

    cfg = get_config(name).frontend
    fb = tfe.mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    window, twiddles, bands, weights = (t.numpy() for t in tfe.fft_tables(cfg, torch.device("cpu")))
    rebuilt = np.zeros_like(fb)
    for m, (lo, hi) in enumerate(bands):
        nz = np.flatnonzero(fb[:, m])
        assert nz.size and lo == nz[0] and hi == nz[-1]
        rebuilt[lo : hi + 1, m] = weights[m, : hi - lo + 1]
        assert not weights[m, hi - lo + 1 :].any()
    np.testing.assert_array_equal(rebuilt, fb)
    np.testing.assert_array_equal(window, tfe.hann_window(cfg.n_fft).astype(np.float32))
    k = np.arange(cfg.n_fft)
    np.testing.assert_array_equal(twiddles[:, 0] + 1j * twiddles[:, 1],
                                  np.exp(-2j * np.pi * k / cfg.n_fft).astype(np.complex64))
