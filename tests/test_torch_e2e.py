"""The port end to end against the JAX package at the tiny configuration:
greedy tokens identical, raw and after the per-row stop trim, with the same
step count; wrapper strings identical; no import of JAX or of the JAX
package anywhere in the port or in chip_smoke.py, and the same parameter
tree as the JAX package's init."""

import ast
import os
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mellow_tpu.config import get_config
from mellow_tpu.io.tokenizer import ByteTokenizer
from mellow_tpu.models import generate as jgen
from mellow_tpu.models import llama as jllama
from mellow_tpu.models import mellow as jmellow
from mellow_tpu.utils.params_io import save_params
from mellow_tpu.wrapper import MellowWrapper as JaxWrapper
from mellow_tpu_torch.models import generate as tgen
from mellow_tpu_torch.models import mellow as tmellow
from mellow_tpu_torch.models.params import params_from_jax
from mellow_tpu_torch.wrapper import MellowWrapper as TorchWrapper
from tests.torch_port_common import TINY, jax_params_np, waves

MAX_LEN = 12


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(3)
    text_ids = rng.randint(2, 500, size=(2, TINY.text_tokenization_len)).astype(np.int32)
    return waves(2, 21), waves(2, 22), text_ids


@pytest.fixture(scope="module")
def token_pair(inputs):
    """Port and JAX greedy tokens, with a stop token taken from the port's
    own row 0 (step 3), so that the stop trim and the done mask act."""
    a1, a2, text_ids = inputs
    tparams = params_from_jax(jax_params_np(), "cpu")
    args = [torch.from_numpy(a) for a in (a1, a2, text_ids)]
    free = tmellow.generate_tokens(tparams, TINY, *args, max_len=MAX_LEN, stop_token_id=-1)
    assert free.num_steps == MAX_LEN
    stop = int(free.tokens[0, 3])
    ours = tmellow.generate_tokens(tparams, TINY, *args, max_len=MAX_LEN, stop_token_id=stop)
    theirs = jmellow.generate_tokens(
        jax.tree.map(jnp.asarray, jax_params_np()), TINY,
        jnp.asarray(a1), jnp.asarray(a2), jnp.asarray(text_ids),
        max_len=MAX_LEN, stop_token_id=stop,
    )
    return free, ours, theirs, stop


def test_greedy_tokens_identical_after_stop_trim(token_pair):
    free, ours, theirs, stop = token_pair
    assert len(set(free.tokens[0].tolist())) > 3 and not torch.equal(free.tokens[0], free.tokens[1])
    # The raw tokens (rows run on past their stop, zeros past num_steps) and
    # the step count are the JAX package's.
    np.testing.assert_array_equal(ours.tokens.numpy(), np.asarray(theirs.tokens))
    assert ours.num_steps == int(theirs.num_steps)
    trimmed = tgen.tokens_to_lists(ours, stop)
    assert trimmed == jgen.tokens_to_lists(theirs, stop)
    assert len(trimmed[0]) <= 3  # row 0 emits the stop token by step 3


def test_generate_stops_when_every_row_is_done(token_pair, inputs):
    """One row whose stop token comes at step 3: the loop ends with the
    flush window that holds it (W = 8 steps), as the JAX package's does."""
    free, *_ = token_pair
    a1, a2, text_ids = inputs
    tparams = params_from_jax(jax_params_np(), "cpu")
    stop = int(free.tokens[0, 3])
    first = free.tokens[0].tolist().index(stop)
    res = tmellow.generate_tokens(
        tparams, TINY, *(torch.from_numpy(a[:1]) for a in (a1, a2, text_ids)),
        max_len=MAX_LEN, stop_token_id=stop,
    )
    W = tgen.effective_window(None, MAX_LEN, 1)
    assert res.num_steps == min(-(-(first + 1) // W) * W, MAX_LEN) < MAX_LEN
    assert res.tokens[0, : res.num_steps].tolist() == free.tokens[0, : res.num_steps].tolist()
    assert (res.tokens[0, res.num_steps :] == 0).all()


def _write_wav(path, seconds, seed, sr=44100):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = 0.3 * np.sin(2 * np.pi * (220 + 200 * seed) * t) + 0.05 * rng.randn(t.size)
    pcm = (np.clip(x, -1, 1) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return str(path)


class _DistinctTokenizer(ByteTokenizer):
    """ByteTokenizer for prompts, but every generated id decodes to its own
    character (ByteTokenizer folds ids >= 130 into '?'), and such a
    character encodes back to its id, so it can serve as the stop token."""

    BASE = 0x4E00

    def decode(self, ids):
        return "".join(chr(self.BASE + int(i)) for i in ids)

    def encode(self, text):
        if len(text) == 1 and ord(text) >= self.BASE:
            return [ord(text) - self.BASE]
        return super().encode(text)


def test_wrapper_strings_identical_to_jax_wrapper(tmp_path):
    short = _write_wav(tmp_path / "short.wav", 7.0, 1)  # repeat-padded to 10 s
    long = _write_wav(tmp_path / "long.wav", 11.0, 2)  # cropped at crop_start
    examples = [[short, long, "caption the audio."], [long, short, "what changed?"]]
    tok = _DistinctTokenizer()
    tw = TorchWrapper(TINY.name, "v0", "cpu", params=jax_params_np(),
                      tokenizer=tok, use_native_audio=False)
    never = chr(tok.BASE + TINY.decoder.vocab_size)  # an id no row can emit
    free = tw.generate(examples, max_len=MAX_LEN, crop_start=0, stop_token=never)
    assert all(len(s) == MAX_LEN for s in free)
    assert len(set(free[0])) > 3 and free[0] != free[1]
    stop = free[0][4]  # the token row 0 emits at step 4: the stop acts
    ours = tw.generate(examples, max_len=MAX_LEN, crop_start=0, stop_token=stop)
    jw = JaxWrapper(TINY.name, "v0", 0, params=jax.tree.map(jnp.asarray, jax_params_np()),
                    tokenizer=tok, use_native_audio=False)
    theirs = jw.generate(examples, max_len=MAX_LEN, crop_start=0, stop_token=stop)
    assert ours == theirs
    assert ours[0] == free[0][: free[0].index(stop)]


def test_wrapper_rejects_unknown_model_and_missing_weights():
    with pytest.raises(ValueError, match="not supported"):
        TorchWrapper("v0", "v99", "cpu", params={})
    with pytest.raises(RuntimeError, match="No weights available"):
        TorchWrapper(TINY.name, "v0", "cpu")


def test_wrapper_loads_params_path_npz(tmp_path):
    path = str(tmp_path / "tiny.npz")
    save_params(jax_params_np(), path)
    tw = TorchWrapper(TINY.name, "v0", "cpu", params_path=path,
                      tokenizer=ByteTokenizer(), use_native_audio=False)
    ref = params_from_jax(jax_params_np(), "cpu")
    assert jax.tree.all(jax.tree.map(torch.equal, tw.params, ref))


def test_wrapper_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchWrapper(TINY.name, "v0", "cuda", params=jax_params_np(), tokenizer=ByteTokenizer())


def test_port_never_imports_jax():
    """Every module of the port imports with jax, jaxlib and the JAX package
    blocked, and chip_smoke.py names none of them in any import."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'mellow_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import mellow_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(mellow_tpu_torch.__path__, 'mellow_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert {'mellow_tpu_torch.ops.window_attention', 'mellow_tpu_torch.models.registry',\n"
        "        'mellow_tpu_torch.models.continuous', 'mellow_tpu_torch.tools.convert_ckpt',\n"
        "        'mellow_tpu_torch.tools.export_ckpt', 'mellow_tpu_torch.server', 'mellow_tpu_torch.cli',\n"
        "        'mellow_tpu_torch.eval', 'mellow_tpu_torch.tools.eval_reasonaqa',\n"
        "        'mellow_tpu_torch.examples.common', 'mellow_tpu_torch.examples.serving',\n"
        "        'mellow_tpu_torch.examples.streaming', 'mellow_tpu_torch.examples.aqa',\n"
        "        'mellow_tpu_torch.train.augment', 'mellow_tpu_torch.train.step',\n"
        "        'mellow_tpu_torch.train.loop', 'mellow_tpu_torch.train.checkpoint',\n"
        "        'mellow_tpu_torch.train.data', 'mellow_tpu_torch.parallel.multihost',\n"
        "        'mellow_tpu_torch.parallel.sharding', 'mellow_tpu_torch.parallel.tensor',\n"
        "        'mellow_tpu_torch.parallel.dryrun', 'mellow_tpu_torch.entry',\n"
        "        'mellow_tpu_torch.utils.profiling', 'mellow_tpu_torch.utils.roofline',\n"
        "        'mellow_tpu_torch.utils.debug', 'mellow_tpu_torch.utils.build_dir'} <= set(names)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'mellow_tpu')\n"
        "       and sys.modules[n] is not None]\n"
        "print(len(names), bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.strip().split(" ", 1)
    assert int(count) >= 20 and bad == "[]"

    smoke = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    with open(smoke) as f:
        tree = ast.parse(f.read())
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.append(node.module)
    assert imported and not [n for n in imported if n.split(".")[0] in ("jax", "jaxlib", "mellow_tpu")]


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(a.shape), tree)


def test_init_params_tree_matches_jax():
    ours = tmellow.init_params(TINY, 0)
    assert _shapes(ours) == _shapes(jax_params_np())
    assert all(a.dtype == np.float32 for a in jax.tree.leaves(ours))
    # Full width: the decoder through jax.eval_shape (the JAX encoder init
    # seeds numpy from a concrete key, so it cannot be traced).
    v0 = get_config("v0")
    ref = jax.eval_shape(lambda k: jllama.init_params(k, v0.decoder), jax.random.PRNGKey(0))
    assert _shapes(tmellow.init_params(v0, 0)["decoder"]) == _shapes(ref)
