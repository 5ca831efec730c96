"""Checkpoint loading in the port, on the CPU at the tiny configuration
(``tests/torch_port_common.py``): ``MellowWrapper`` reads the reference's
PyTorch state dict (``.pt``/``.ckpt``) through the port's own
``tools/convert_ckpt.py``, from ``params_path``, ``MELLOW_TPU_CKPT`` or
``MELLOW_TPU_PARAMS`` (also a converted ``.npz``), in that order after
``params=``, into parameters bit-equal to ``params_from_jax`` of the JAX
package's conversion; it raises with nothing given. The state dict is the
one the JAX package's ``export_mellow`` makes from seeded params. And the
HF oracle: the port's ``convert_llama`` of a HuggingFace Llama's state dict
decodes the oracle's greedy tokens."""

import numpy as np
import pytest
import torch
import jax

from mellow_tpu.tools import convert_ckpt as jconvert
from mellow_tpu.tools import export_ckpt as jexport
from mellow_tpu_torch.io.tokenizer import ByteTokenizer
from mellow_tpu_torch.models import generate as tgen
from mellow_tpu_torch.models.params import params_from_jax
from mellow_tpu_torch.tools.convert_ckpt import convert_llama
from mellow_tpu_torch.utils.params_io import save_params
from mellow_tpu_torch.wrapper import MellowWrapper as TorchWrapper
from tests.oracles.hf_llama import build_hf_model, reference_greedy_decode
from tests.torch_port_common import TINY, port_params_np

L = TINY.decoder.num_layers


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The exported state dict saved as a .pt (and again with DataParallel's
    ``module.`` prefix), JAX's conversion saved as an .npz, and the
    parameters the wrapper must load."""
    d = tmp_path_factory.mktemp("ckpt")
    sd = {k: torch.from_numpy(v) for k, v in jexport.export_mellow(port_params_np(TINY)).items()}
    paths = {"pt": str(d / "v0.pt"), "module": str(d / "dp.ckpt"), "npz": str(d / "v0.npz")}
    torch.save(sd, paths["pt"])
    torch.save({"module." + k: v for k, v in sd.items()}, paths["module"])
    converted = jconvert.convert_mellow(sd, L)
    save_params(converted, paths["npz"])
    return paths, params_from_jax(converted, "cpu")


def _load(monkeypatch, env=(), **kw):
    for name in ("MELLOW_TPU_PARAMS", "MELLOW_TPU_CKPT"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env:
        monkeypatch.setenv(name, value)
    return TorchWrapper(TINY.name, "v0", "cpu", tokenizer=ByteTokenizer(), use_native_audio=False, **kw).params


@pytest.mark.parametrize("source", ["params_path .pt", "MELLOW_TPU_CKPT .ckpt (module.)", "MELLOW_TPU_PARAMS .npz",
                                    "MELLOW_TPU_PARAMS .pt", "params_path over both variables"])
def test_wrapper_loads_checkpoints(checkpoint, monkeypatch, source):
    paths, want = checkpoint
    kw, env = {}, ()
    if source == "params_path .pt":
        kw = {"params_path": paths["pt"]}
    elif source.startswith("MELLOW_TPU_CKPT"):
        env = (("MELLOW_TPU_CKPT", paths["module"]),)
    elif source == "MELLOW_TPU_PARAMS .npz":
        env = (("MELLOW_TPU_PARAMS", paths["npz"]), ("MELLOW_TPU_CKPT", "/nonexistent.ckpt"))
    elif source == "MELLOW_TPU_PARAMS .pt":
        env = (("MELLOW_TPU_PARAMS", paths["pt"]),)
    else:
        kw = {"params_path": paths["npz"]}
        env = (("MELLOW_TPU_PARAMS", "/nonexistent.npz"), ("MELLOW_TPU_CKPT", "/nonexistent.ckpt"))
    got = _load(monkeypatch, env, **kw)
    assert jax.tree.all(jax.tree.map(torch.equal, got, want))


def test_wrapper_raises_with_no_weights(monkeypatch):
    with pytest.raises(RuntimeError, match="No weights available") as err:
        _load(monkeypatch)
    for way in ("params=", "params_path=", "MELLOW_TPU_PARAMS", "MELLOW_TPU_CKPT"):
        assert way in str(err.value)


def test_convert_llama_decodes_the_hf_oracles_greedy_tokens():
    """The HF oracle's state dict through the port's ``convert_llama``: fp32
    greedy tokens identical to the oracle's full-recompute decode loop."""
    hf = build_hf_model(TINY.decoder, seed=3)
    dec = params_from_jax({"decoder": convert_llama(hf.state_dict(), L)}, "cpu")["decoder"]
    prefix = torch.from_numpy((np.random.RandomState(2).randn(3, 9, TINY.decoder.hidden_size) * 0.1)
                              .astype(np.float32))
    max_len = 16
    want = reference_greedy_decode(hf, prefix, max_len, -1)
    got = tgen.generate(dec, TINY.decoder, prefix, max_len=max_len, stop_token_id=-1)
    assert got.num_steps == want.shape[1] == max_len
    assert torch.equal(got.tokens.long(), want)
