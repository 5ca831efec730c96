"""Training in the port without the JAX package's programs
(``mellow_tpu_torch.train``), on the CPU at ``TINY_TRAIN`` of
``tests/torch_port_common.py``: gradient accumulation against one step,
losses that fall, the stochastic paths by structure and statistics, the
data loader's copy, checkpoints and the loop's resume, and the CUDA
wrappers' refusal of inputs that require grad. ``tests/test_torch_train.py``
holds the loss, the gradients and the optimizer against the JAX package."""

import json
import re
import wave

import numpy as np
import pytest
import torch

from mellow_tpu_torch import config as tconfig
from mellow_tpu_torch.io.tokenizer import ByteTokenizer
from mellow_tpu_torch.models import htsat as thtsat
from mellow_tpu_torch.models.params import flatten, params_from_jax, tree_leaves
from mellow_tpu_torch.train import augment, checkpoint, loop
from mellow_tpu_torch.train import step as tstep
from mellow_tpu_torch.train.data import ReasonAQALoader, load_json
from tests.torch_kernel_cases import GRAD_REFUSALS, refuses_grad
from tests.torch_port_common import TINY_TRAIN, train_batch, train_params_np

TCFG = tconfig.get_config(TINY_TRAIN.name)

def _state():
    return tstep.init_train_state(params_from_jax(train_params_np(), "cpu"), tstep.make_optimizer())


def test_train_step_accum_equals_train_step():
    """Micro-batches of equal answer tokens (5 + 5): their averaged gradients
    are the whole batch's, so one accumulated step equals one plain step in
    its metrics and in the optimizer's moments (update 0 has a learning rate
    of 0, so the moments carry the gradients; a first Adam step moves each
    weight by about the learning rate whatever its gradient's size)."""
    b = train_batch()
    b["answer_mask"] = np.array([[1] * 6, [1] * 4 + [0] * 2, [1] * 5 + [0], [1] * 5 + [0]], np.float32)
    opt = tstep.make_optimizer(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    one, m1 = tstep.train_step(_state(), TCFG, opt, b, None)
    two, m2 = tstep.train_step_accum(_state(), TCFG, opt, b, None, accum_steps=2)
    for k in ("loss", "accuracy", "num_answer_tokens", "grad_norm"):
        assert float(m2[k]) == pytest.approx(float(m1[k]), rel=1e-5, abs=1e-6), k
    for moments in ("mu", "nu"):
        for a, c in zip(tree_leaves(getattr(one.opt_state, moments)), tree_leaves(getattr(two.opt_state, moments))):
            torch.testing.assert_close(c, a, rtol=1e-4, atol=1e-5 * a.abs().max().item())
    assert one.step == two.step == 1 and one.opt_state.count == two.opt_state.count == 1


def test_six_steps_lower_the_loss():
    b = train_batch(B=2)
    opt = tstep.make_optimizer(learning_rate=3e-3, warmup_steps=1)
    state, losses = _state(), []
    for i in range(6):
        g = torch.Generator()
        g.manual_seed(i)
        state, m = tstep.train_step(state, TCFG, opt, b, g, mixup=i == 5)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[4] < losses[0], losses
    assert state.step == 6


def _runs(row: np.ndarray) -> list:
    """(start, width) of each run of zeros in a 0/1 row."""
    padded = np.concatenate([[1.0], row, [1.0]])
    edges = np.flatnonzero(np.diff((padded == 0).astype(int)))
    return [(s, e - s) for s, e in zip(edges[0::2], edges[1::2])]


def test_stochastic_paths_by_structure_and_statistics():
    g = torch.Generator()
    g.manual_seed(0)
    # SpecAugment: per row, at most 2 stripes an axis, each narrower than its
    # drop width (two stripes may touch: a run is at most two of them), the
    # time mask constant over the mel axis and vice versa.
    x = torch.ones((64, 100, 64))
    out = augment.spec_augment(x, g).numpy()
    assert set(np.unique(out)) <= {0.0, 1.0} and (out == 0).any()
    for row in out:
        # a time stripe zeroes whole rows of the (T, F) image; a mel stripe whole columns
        t_zero, f_zero = (row == 0).all(axis=1), (row == 0).all(axis=0)
        assert ((row == 0) == (t_zero[:, None] | f_zero[None, :])).all()
        for zero, width in ((t_zero, 64), (f_zero, 8)):
            runs = _runs(np.where(zero, 0.0, 1.0))
            assert len(runs) <= 2 and sum(w for _, w in runs) <= 2 * (width - 1), runs
    # drop-path keeps whole rows at 1 - rate, scaled by 1 / (1 - rate).
    rows = thtsat._drop_path(torch.ones((20000, 3, 2)), 0.3, g)
    kept = rows[:, 0, 0] != 0
    assert torch.allclose(rows[kept], torch.tensor(1 / 0.7)) and torch.all(rows[~kept] == 0)
    assert abs(kept.float().mean().item() - 0.7) < 0.015  # > 4 standard errors
    # the projection's dropout keeps elements at 1 - rate.
    el = thtsat._dropout(torch.ones((200, 100)), 0.5, g)
    assert set(torch.unique(el).tolist()) == {0.0, 2.0}
    assert abs((el != 0).float().mean().item() - 0.5) < 0.015
    # mixup weights: pairs sum to 1, lam ~ Beta(1, 1) = U(0, 1).
    lam = augment.sample_mixup_lambda(g, 4000)
    torch.testing.assert_close(lam[0::2] + lam[1::2], torch.ones(2000), rtol=0, atol=1e-6)
    assert ((lam >= 0) & (lam <= 1)).all() and abs(lam[0::2].mean().item() - 0.5) < 0.03
    xm = torch.randn(4, 5, 3, generator=g)
    torch.testing.assert_close(augment.mixup(xm, lam[:4]), xm[0::2] * lam[0:4:2, None, None]
                               + xm[1::2] * lam[1:4:2, None, None])
    # The encoder's train route: plain in every dtype; the eval route by geometry.
    assert thtsat.kernel_route(96, 4, 8, 64, training=True) == "plain"
    assert thtsat.kernel_route(96, 4, 8, 64) == "swin_block"


def _write_wav(path, seconds: float, seed: int) -> str:
    rng = np.random.RandomState(seed)
    pcm = (np.clip(rng.randn(int(16000 * seconds)) * 0.2, -1, 1) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return str(path)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """Four rows over two wavs this test writes (1.5 s and 2.5 s, repeat
    padded to 10 s), as ``tests/test_train.py``'s data."""
    d = tmp_path_factory.mktemp("train_data")
    a, b = _write_wav(d / "a.wav", 1.5, 1), _write_wav(d / "b.wav", 2.5, 2)
    rows = [{"taskname": "audiocaps", "filepath1": a, "filepath2": "", "input": "caption the audio.",
             "answer": "a busy street", "subtype": "AudioCaps.json"},
            {"taskname": "clothov21", "filepath1": b, "filepath2": a, "input": "explain the difference",
             "answer": "quite different sounds", "subtype": "ACD-1.json"}] * 2
    p = d / "train.json"
    p.write_text(json.dumps(rows))
    return str(p)


def test_loader_copy_shapes_and_stop_tokens(manifest):
    """The copy's batches: shapes, and each answer's stop token at the end
    of its mask (``tests/test_train.py::test_loader_shapes``)."""
    loader = ReasonAQALoader(load_json(manifest), ByteTokenizer(), TCFG, batch_size=2, answer_len=16)
    batches = list(loader.epoch(0))
    assert len(batches) == 2
    b = batches[0]
    assert b["audio1"].shape == b["audio2"].shape == (2, 320000)
    assert b["text_ids"].shape == (2, TCFG.text_tokenization_len)
    assert b["answer_ids"].shape == b["answer_mask"].shape == (2, 16)
    for row, mask in zip(b["answer_ids"], b["answer_mask"]):
        assert row[int(mask.sum()) - 1] == TCFG.stop_token_id


def test_checkpoint_round_trip_and_loop_resume(manifest, tmp_path, capsys):
    """``save`` -> ``restore`` bit for bit; ``latest`` picks the highest step
    (and skips other names); ``loop.train`` saves every step and a second
    call resumes from the last one."""
    state = _state()
    opt = tstep.make_optimizer(learning_rate=1e-3, warmup_steps=0, total_steps=10)
    state, _ = tstep.train_step(state, TCFG, opt, train_batch(), None)
    d = tmp_path / "ckpt"
    path = checkpoint.save(str(d), state)
    back = checkpoint.restore(path, _state())
    assert back.step == state.step == 1 and back.opt_state.count == 1
    for tree_a, tree_b in ((state.params, back.params), (state.opt_state.mu, back.opt_state.mu),
                           (state.opt_state.nu, back.opt_state.nu)):
        for (ka, a), (kb, b) in zip(flatten(tree_a).items(), flatten(tree_b).items()):
            assert ka == kb and a.dtype == b.dtype and torch.equal(a, b), ka
    assert all(t.requires_grad for t in tree_leaves(back.params))
    for name in ("step_10.pt", "step_9.pt", "step_x.pt", "other"):
        (d / name).write_bytes(b"")
    assert checkpoint.latest(str(d)) == str(d / "step_10.pt")
    assert checkpoint.latest(str(tmp_path / "none")) is None

    loader = ReasonAQALoader(load_json(manifest), ByteTokenizer(), TCFG, batch_size=2, answer_len=8)
    params = params_from_jax(train_params_np(), "cpu")
    run = tmp_path / "run"
    first = loop.train(params, TCFG, loader, max_steps=1, ckpt_dir=str(run), ckpt_every=1, log_every=1)
    assert first.step == 1 and checkpoint.latest(str(run)) == str(run / "step_1.pt")
    again = loop.train(params, TCFG, loader, max_steps=2, ckpt_dir=str(run), ckpt_every=1, log_every=1,
                       accum_steps=2)
    out = capsys.readouterr().out
    assert re.search(r"resumed from .*step_1\.pt \(step 1\)", out), out
    assert again.step == 2 and checkpoint.latest(str(run)) == str(run / "step_2.pt")


@pytest.mark.parametrize("name", GRAD_REFUSALS)
def test_kernel_wrappers_refuse_grad_before_anything_else(name):
    """Each CUDA wrapper checks for inputs that require grad first, so the
    refusal shows here on CPU tensors too (``tests/test_torch_kernels.py``
    holds it on the card)."""
    refuses_grad(name, "cpu")
