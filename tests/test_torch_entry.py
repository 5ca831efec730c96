"""The port's user entry points on the CPU at the tiny configuration:
``cli.build_wrapper``'s random-weight fallback, ``eval.run_eval`` and
``tools/eval_reasonaqa.main`` on a 4-row manifest over the port's wrapper,
and one example script end to end."""

import json

import numpy as np
import pytest
import torch

from mellow_tpu_torch import cli
from mellow_tpu_torch import eval as ev
from mellow_tpu_torch.config import get_config
from mellow_tpu_torch.examples import common as examples_common
from mellow_tpu_torch.examples import serving as serving_example
from mellow_tpu_torch.io.tokenizer import ByteTokenizer
from mellow_tpu_torch.models.mellow import init_params
from mellow_tpu_torch.models.params import flatten, params_from_jax
from mellow_tpu_torch.tools import eval_reasonaqa
from tests.torch_port_common import TINY


@pytest.fixture
def no_weights(monkeypatch):
    for name in ("MELLOW_TPU_PARAMS", "MELLOW_TPU_CKPT"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def wrapper():
    with pytest.MonkeyPatch.context() as mp:
        for name in ("MELLOW_TPU_PARAMS", "MELLOW_TPU_CKPT"):
            mp.delenv(name, raising=False)
        return cli.build_wrapper(TINY.name, "v0", "cpu", use_native_audio=False)


def test_build_wrapper_falls_back_to_random_weights(no_weights, wrapper, capsys):
    """No weights reachable: seed-0 random weights and the byte tokenizer,
    on the device asked for; a ``tokenizer`` given is kept."""
    assert wrapper.device == torch.device("cpu") and isinstance(wrapper.tokenizer, ByteTokenizer)
    want = flatten(params_from_jax(init_params(get_config(TINY.name), 0), "cpu"))
    got = flatten(wrapper.params)
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
    tok = ByteTokenizer()
    again = cli.build_wrapper(TINY.name, "v0", "cpu", tokenizer=tok, use_native_audio=False)
    assert again.tokenizer is tok
    assert "RANDOM weights" in capsys.readouterr().err
    with pytest.raises(ValueError):  # other errors pass through
        cli.build_wrapper(TINY.name, "v9", "cpu")


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval_data")
    a = examples_common.write_demo_wav(str(d / "a.wav"), 1.5, 1, sr=16000)
    b = examples_common.write_demo_wav(str(d / "b.wav"), 2.5, 2, sr=16000)
    rows = [{"taskname": "audiocaps", "filepath1": "a.wav", "filepath2": "", "input": "caption the audio.",
             "answer": "a busy street", "subtype": "AudioCaps.json"},
            {"taskname": "clothoaqa", "filepath1": "b.wav", "filepath2": "a.wav", "input": "is it raining?",
             "answer": "yes", "subtype": "ClothoAQA-binary.json"}] * 2
    path = d / "test.json"
    path.write_text(json.dumps(rows))
    return str(path), str(d)


def test_run_eval_and_the_eval_tool(no_weights, wrapper, manifest, tmp_path, capsys):
    """``run_eval``'s predictions are the wrapper's answers in manifest
    order, scored per subtype; the tool's ``main`` over the same manifest
    (its wrapper built by the same fallback) writes the same predictions."""
    path, root = manifest
    examples = ev.load_manifest(path, root)
    reports, preds = ev.run_eval(wrapper, examples, batch_size=3, max_len=4)
    assert preds == wrapper.generate([[e.audio1, e.audio2, e.prompt] for e in examples], max_len=4)
    assert sorted(reports) == ["AudioCaps.json", "ClothoAQA-binary.json", "OVERALL"]
    assert reports["OVERALL"].n == 4 and "cider_d" in reports["AudioCaps.json"].metrics
    out = tmp_path / "preds.json"
    eval_reasonaqa.main([path, "--audio-root", root, "--config", TINY.name, "--device", "cpu",
                         "--batch-size", "4", "--max-len", "4", "--out", str(out)])
    written = json.loads(out.read_text())
    assert written["predictions"] == preds
    assert written["metrics"]["OVERALL"]["n"] == 4
    assert "OVERALL" in capsys.readouterr().out


def test_serving_example_end_to_end(no_weights, capsys):
    """The serving example with its own demo wavs: four concurrent requests
    through the engine, one answer each."""
    answers = examples_common.main(serving_example.task, "serving", argv=["--config", TINY.name, "--device", "cpu"])
    assert len(answers) == len(serving_example.PROMPTS) and all(isinstance(a, str) for a in answers)
    assert capsys.readouterr().out.count("Q: ") == 4


def test_demo_wav_is_seeded(tmp_path):
    import wave

    def read(p):
        with wave.open(p) as w:
            return np.frombuffer(w.readframes(w.getnframes()), "<i2")

    a = read(examples_common.write_demo_wav(str(tmp_path / "x.wav"), 0.5, 7))
    b = read(examples_common.write_demo_wav(str(tmp_path / "y.wav"), 0.5, 7))
    assert a.size == 22050 and np.array_equal(a, b) and np.abs(a).max() > 1000
