"""The port keeps its own copies of the JAX package's torch-free host code
(``mellow_tpu_torch.config``, ``io``, ``native``, ``utils``, ``eval`` and
``train/data``) and of its tools (``mellow_tpu_torch.tools``): each copied
function is held bit-equal to the original on the same inputs."""

import dataclasses
import io
import json
import os
import wave
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from mellow_tpu import config as jconfig
from mellow_tpu import eval as jeval
from mellow_tpu.io import bpe as jbpe
from mellow_tpu.io import resample as jresample
from mellow_tpu.io import tokenizer as jtokenizer
from mellow_tpu.io import wav as jwav
from mellow_tpu.tools import convert_ckpt as jconvert
from mellow_tpu.tools import eval_reasonaqa as jeval_tool
from mellow_tpu.tools import export_ckpt as jexport
from mellow_tpu.train import data as jdata
from mellow_tpu.utils import params_io as jparams_io
from mellow_tpu_torch import config as tconfig
from mellow_tpu_torch import config_yaml as tconfig_yaml
from mellow_tpu_torch import eval as teval
from mellow_tpu_torch.io import bpe as tbpe
from mellow_tpu_torch.io import resample as tresample
from mellow_tpu_torch.io import tokenizer as ttokenizer
from mellow_tpu_torch.io import wav as twav
from mellow_tpu_torch.native import binding as tnative
from mellow_tpu_torch.tools import convert_ckpt as tconvert
from mellow_tpu_torch.tools import eval_reasonaqa as teval_tool
from mellow_tpu_torch.tools import export_ckpt as texport
from mellow_tpu_torch.train import data as tdata
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


def test_v0_yaml_copy_equal_and_loads_as_v0():
    """The port ships its own ``configs/v0.yaml``, byte-equal to the JAX
    package's, and its YAML loader reads it back as ``get_config("v0")``,
    field for field (the name aside)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ours = os.path.join(root, "mellow_tpu_torch", "configs", "v0.yaml")
    with open(ours, "rb") as f, open(os.path.join(root, "mellow_tpu", "configs", "v0.yaml"), "rb") as g:
        assert f.read() == g.read()
    cfg, ref = tconfig_yaml.load_yaml_config(ours, "v0_from_yaml"), tconfig.get_config("v0")
    assert cfg.name == "v0_from_yaml"
    for field in dataclasses.fields(ref):
        if field.name != "name":
            assert getattr(cfg, field.name) == getattr(ref, field.name), field.name


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


PREDS = ["A dog barks twice.", "the car", "yes", "rain falls on a tin roof", "", "B"]
REFS = ["a dog is barking", "The car.", "no", "rain on a metal roof, heavy", "silence", "(b)"]


def test_eval_metrics_copy_equal():
    for p, a in zip(PREDS, REFS):
        assert teval.normalize_text(p) == jeval.normalize_text(p)
        assert teval.exact_match(p, a) == jeval.exact_match(p, a)
        assert teval.token_f1(p, a) == jeval.token_f1(p, a)
    refs = [[r, r + " outside"] for r in REFS]
    assert teval.corpus_bleu(PREDS, refs) == jeval.corpus_bleu(PREDS, refs)
    assert teval.cider_d(PREDS, refs) == jeval.cider_d(PREDS, refs)
    for sub in ("ClothoAQA-binary.json", "AudioCaps.json", "mcq"):
        assert teval.score_group(PREDS, REFS, sub) == jeval.score_group(PREDS, REFS, sub)


def _manifest(tmp_path) -> str:
    a = _write_wav(tmp_path / "a.wav", 44100, 1, 2, 3)
    b = _write_wav(tmp_path / "b.wav", 48000, 2, 2, 4)
    rows = [{"taskname": "clotho", "filepath1": "a.wav", "filepath2": "", "input": "caption the audio.",
             "answer": "a busy street", "subtype": "AudioCaps.json"},
            {"taskname": "aqa", "filepath1": "b.wav", "filepath2": "a.wav", "input": "is it raining?",
             "answer": "yes", "subtype": "ClothoAQA-binary.json"},
            {"filepath1": "a.wav", "input": "what is it?", "answer": "noise"}] * 2
    path = tmp_path / "m.json"
    path.write_text(json.dumps(rows))
    return str(path)


def test_manifest_and_loader_copy_equal(tmp_path):
    """``load_json``, ``load_manifest`` and the loader's batches (the audio
    read through each package's own native library) equal the JAX
    package's."""
    path = _manifest(tmp_path)
    root = str(tmp_path)
    assert teval.load_manifest(path, root) == [teval.EvalExample(**dataclasses.asdict(e))
                                               for e in jeval.load_manifest(path, root)]
    rows_t, rows_j = tdata.load_json(path, root), jdata.load_json(path, root)
    assert [dataclasses.asdict(r) for r in rows_t] == [dataclasses.asdict(r) for r in rows_j]
    cfg_t, cfg_j = tconfig.get_config(TINY.name), TINY
    tok = ttokenizer.ByteTokenizer()
    ours = list(tdata.PrefetchLoader(tdata.ReasonAQALoader(rows_t, tok, cfg_t, 2, answer_len=8, seed=3)).epoch(1))
    theirs = list(jdata.PrefetchLoader(jdata.ReasonAQALoader(rows_j, tok, cfg_j, 2, answer_len=8, seed=3)).epoch(1))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class _EchoWrapper:
    """A wrapper whose answer is its prompt, reversed: the eval tool's logic
    alone, without a model."""

    def generate(self, examples, max_len, stop_token):
        return [e[2][::-1] for e in examples]


def test_eval_reasonaqa_copy_equal(tmp_path, monkeypatch):
    """Both tools' ``main`` over the same manifest and an echo wrapper: the
    same report on stdout and the same ``--out`` JSON."""
    path = _manifest(tmp_path)
    outs = []
    for tool, cli in ((teval_tool, "mellow_tpu_torch.cli"), (jeval_tool, "mellow_tpu.cli")):
        monkeypatch.setattr(cli + ".build_wrapper", lambda *a, **k: _EchoWrapper())
        out = tmp_path / f"{tool.__name__}.json"
        buf = io.StringIO()
        with redirect_stdout(buf):
            tool.main([path, "--audio-root", str(tmp_path), "--batch-size", "4", "--out", str(out)])
        outs.append((buf.getvalue(), json.loads(out.read_text())))
    assert outs[0] == outs[1]
    assert "OVERALL" in outs[0][0]
