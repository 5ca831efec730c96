"""The port keeps its own copies of the JAX package's torch-free host code
(``mellow_tpu_torch.config``, ``io``, ``native``, ``utils``) and of its
checkpoint tools (``mellow_tpu_torch.tools``): each copied function is held
bit-equal to the original on the same inputs."""

import dataclasses
import wave

import numpy as np
import pytest
import torch

from mellow_tpu import config as jconfig
from mellow_tpu.io import bpe as jbpe
from mellow_tpu.io import resample as jresample
from mellow_tpu.io import tokenizer as jtokenizer
from mellow_tpu.io import wav as jwav
from mellow_tpu.tools import convert_ckpt as jconvert
from mellow_tpu.tools import export_ckpt as jexport
from mellow_tpu.utils import params_io as jparams_io
from mellow_tpu_torch import config as tconfig
from mellow_tpu_torch.io import bpe as tbpe
from mellow_tpu_torch.io import resample as tresample
from mellow_tpu_torch.io import tokenizer as ttokenizer
from mellow_tpu_torch.io import wav as twav
from mellow_tpu_torch.native import binding as tnative
from mellow_tpu_torch.tools import convert_ckpt as tconvert
from mellow_tpu_torch.tools import export_ckpt as texport
from mellow_tpu_torch.utils import params_io as tparams_io
from tests.test_bpe import SAMPLES, _handcrafted_files
from tests.torch_port_common import TINY, port_params_np


def _write_wav(path, sr, channels, width, seed):
    rng = np.random.RandomState(seed)
    x = np.clip(rng.randn(int(0.3 * sr) * channels) * 0.3, -1, 1)
    scale = 2 ** (8 * width - 1) - 1
    dtype = {1: np.uint8, 2: "<i2", 4: "<i4"}[width]
    pcm = (x * 127 + 128).astype(dtype) if width == 1 else (x * scale).astype(dtype)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return str(path)


@pytest.mark.parametrize("sr, channels, width", [(44100, 1, 2), (48000, 2, 2), (16000, 1, 1), (22050, 2, 4)])
def test_read_wav_bit_equal(tmp_path, sr, channels, width):
    path = _write_wav(tmp_path / "x.wav", sr, channels, width, sr + channels)
    ours, ours_sr = twav.read_wav(path)
    theirs, theirs_sr = jwav.read_wav(path)
    assert ours_sr == theirs_sr == sr
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("orig, new", [(44100, 32000), (48000, 32000), (16000, 32000)])
def test_resample_bit_equal(orig, new):
    x = np.random.RandomState(orig).randn(2, 5000).astype(np.float32)
    ours = tresample.resample(x, orig, new)
    theirs = jresample.resample(x, orig, new)
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


def test_byte_tokenizer_bit_equal():
    ours, theirs = ttokenizer.ByteTokenizer(), jtokenizer.ByteTokenizer()
    for text in SAMPLES + ["caption the audio.", "<|endoftext|>"]:
        assert ours.encode(text) == theirs.encode(text)
        assert ours.encode_padded(text, 12) == theirs.encode_padded(text, 12)
        ids = theirs.encode(text)
        assert ours.decode(ids) == theirs.decode(ids)


def test_bpe_tokenizer_bit_equal(tmp_path):
    d, _, _ = _handcrafted_files(tmp_path)
    ours, theirs = tbpe.BPETokenizer.from_dir(d), jbpe.BPETokenizer.from_dir(d)
    for text in SAMPLES:
        ids = theirs.encode(text)
        assert ours.encode(text) == ids
        assert ours.decode(ids) == theirs.decode(ids)
        assert ours.encode_padded(text, 9) == theirs.encode_padded(text, 9)


def test_load_params_bit_equal(tmp_path):
    rng = np.random.RandomState(0)
    tree = {"a": {"kernel": rng.randn(3, 4).astype(np.float32), "bias": np.zeros(4, np.float32)},
            "stages": [{"w": rng.randn(2).astype(np.float32)}, {"w": rng.randn(5).astype(np.float32)}]}
    path = str(tmp_path / "p.npz")
    jparams_io.save_params(tree, path)
    ours, theirs = tparams_io.load_params(path), jparams_io.load_params(path)
    flat = lambda t: [(k, v) for k, v in sorted(_flatten(t))]  # noqa: E731
    assert [k for k, _ in flat(ours)] == [k for k, _ in flat(theirs)]
    for (_, a), (_, b) in zip(flat(ours), flat(theirs)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("name", ["v0", "v0_s"])
def test_config_copy_equal(name):
    assert dataclasses.asdict(tconfig.get_config(name)) == dataclasses.asdict(jconfig.get_config(name))


def test_native_copy_builds_outside_the_package_and_matches_python(tmp_path):
    path = _write_wav(tmp_path / "n.wav", 44100, 1, 2, 5)
    assert tnative.available()
    assert "build" in tnative._LIB_PATH.split("/") and "mellow_tpu_torch/native" not in tnative._LIB_PATH
    ours, sr = tnative.read_wav(path)
    ref, ref_sr = twav.read_wav(path)
    assert sr == ref_sr
    np.testing.assert_array_equal(ours, ref)


def _assert_trees_equal(ours, theirs):
    a, b = sorted(_flatten(ours)), sorted(_flatten(theirs))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_export_ckpt_copy_equal():
    """``export_mellow`` of seeded params in the JAX package's tree layout:
    the same keys and values as the JAX package's."""
    tree = port_params_np(TINY)
    ours, theirs = texport.export_mellow(tree), jexport.export_mellow(tree)
    assert sorted(ours) == sorted(theirs) and len(ours) > 100
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_convert_ckpt_copy_equal():
    """``convert_mellow`` of the state dict the JAX package's
    ``export_mellow`` makes: the same tree as the JAX package's
    conversion, which is the exported tree."""
    tree = port_params_np(TINY)
    sd = {k: torch.from_numpy(v) for k, v in jexport.export_mellow(tree).items()}
    ours = tconvert.convert_mellow(sd, TINY.decoder.num_layers)
    _assert_trees_equal(ours, jconvert.convert_mellow(sd, TINY.decoder.num_layers))
    _assert_trees_equal(ours, tree)
