"""The port's multi-device paths (``mellow_tpu_torch/parallel/``) on six CPU
ranks joined by gloo, at the dry run's tiny configuration
(``parallel.dryrun.DRYRUN``: 6 heads over 3 KV heads, so ``tp=3`` shards the
heads and ``tp=2`` only the MLP and the vocabulary).

One module fixture spawns the six ranks once (``dryrun.spawn``, with a
timeout on the spawn and on every collective). They run the cases at the
meshes (dp, tp) = (6, 1), (3, 2) and (2, 3), then each rank computes one of
the unsharded references, and hand numpy results back; meanwhile this
process runs the JAX package's unsharded ``generate_tokens`` and
``train_step``. Each test asserts on its part:

  * the parameter specs against ``mellow_tpu.parallel.sharding``'s;
  * fp32 greedy tokens (B=5, one padding row) against JAX's, on every mesh,
    and the mesh wrapper's strings against the unsharded port wrapper's;
    int8 weights with an int8 cache, and the GPT-2 family, against the
    unsharded port at (2, 3); sampling streams; ``generate_stream``;
    ``BatchingEngine`` on rank 0 with ``follow`` on the others; and, in a
    second world of two ranks with a short collective timeout, a rank 0
    that stays idle for longer than that timeout before its call and
    before ``stop``;
  * the train step's metrics against JAX's, its gradients and parameters
    against the unsharded port's, accumulation and mixup under DP, and
    ``loop.train`` resumed across meshes;
  * the refusals.

This module imports no JAX at its top: the ranks import it for
``rank_main``, and JAX stays in this process.
"""

import datetime
import hashlib
import os
import time
import wave
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mellow_tpu_torch import parallel
from mellow_tpu_torch.io.tokenizer import ByteTokenizer
from mellow_tpu_torch.models import generate as tgen
from mellow_tpu_torch.models import gpt2 as tgpt2
from mellow_tpu_torch.models import llama as tllama
from mellow_tpu_torch.models import mellow as tmellow
from mellow_tpu_torch.models.params import flatten, params_from_jax, tree_leaves, unflatten
from mellow_tpu_torch.parallel import dryrun, multihost, sharding
from mellow_tpu_torch.train import loop as tloop
from mellow_tpu_torch.train import step as tstep
from mellow_tpu_torch.train.augment import sample_mixup_lambda
from mellow_tpu_torch.wrapper import MellowWrapper

CFG = dryrun.DRYRUN
GPT2_CFG = CFG.replace(
    name="dryrun_tiny_gpt2",
    decoder=tgpt2.GPT2Config(vocab_size=768, hidden_size=96, num_layers=2, num_heads=6, max_position_embeddings=300),
    decoder_family="gpt2", text_decoder="gpt2", sep_token_id=765, stop_token_id=765,
)
WORLD = 6
MESHES = ((6, 1), (3, 2), (2, 3))  # (dp, tp)
MAX_LEN = 12
LR = 1e-3  # the train step's; update 0 runs at rate 0 (warmup_steps=1)
LOOP_LR = 0.1
IDLE_GROUP_S = 4.0  # the idle world's collective timeout
IDLE_S = 6.0  # rank 0's idle time there before its call and before ``stop``
TRAIN_LENS = (6, 5, 3, 4, 2, 6)  # answer tokens a row: every mesh's ranks hold different counts
PROMPTS = ("caption the audio.", "what is different?", "is there speech?", "count the sounds.",
           "describe the second clip.")


class DistinctTokenizer(ByteTokenizer):
    """ByteTokenizer for prompts; every generated id decodes to a character
    of its own, which encodes back to it, so two strings differ where their
    ids do and any id can be the stop token."""

    BASE = 0x4E00

    def decode(self, ids) -> str:
        return "".join(self.eos_token if int(i) == 0 else chr(self.BASE + int(i)) for i in ids)

    def encode(self, text: str):
        if len(text) == 1 and ord(text) >= self.BASE:
            return [ord(text) - self.BASE]
        return super().encode(text)


class OneBatchLoader:
    """A loader of one batch, the same in every epoch (``loop.train`` does not
    skip the batches of the steps a resumed run already took)."""

    def __init__(self, batch):
        self.batch = batch

    def epoch(self, epoch):
        yield self.batch


def _write_wav(path, seconds, seed, sr=32000):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = 0.3 * np.sin(2 * np.pi * (220 + 200 * seed) * t) + 0.05 * rng.randn(t.size)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return str(path)


def _train_batch(B, lens, seed):
    rng = np.random.RandomState(seed)
    T = 6
    return {
        "audio1": (rng.randn(B, 320000) * 0.1).astype(np.float32),
        "audio2": (rng.randn(B, 320000) * 0.1).astype(np.float32),
        "text_ids": rng.randint(2, 700, (B, CFG.text_tokenization_len)).astype(np.int32),
        "answer_ids": rng.randint(2, 700, (B, T)).astype(np.int32),
        "answer_mask": np.array([[1.0] * n + [0.0] * (T - n) for n in lens], np.float32),
    }


def _pad_done(arrays, rows):
    """The 5-row generate inputs padded to ``rows`` rows, and the initial
    done mask whose padding rows start done."""
    B = arrays[0].shape[0]
    padded = [torch.from_numpy(np.concatenate([a, np.zeros((rows - B,) + a.shape[1:], a.dtype)])) for a in arrays]
    return padded, torch.arange(rows) >= B


def _np_tree(tree):
    return {k: v.detach().numpy().copy() for k, v in flatten(tree).items()}


def _digest(t) -> str:
    return hashlib.sha1(t.detach().contiguous().numpy().tobytes()).hexdigest()


class _Record:
    """Wraps a module function to keep each call's result."""

    def __init__(self, module, name, keep):
        self.module, self.name, self.fn, self.keep, self.out = module, name, getattr(module, name), keep, []
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        res = self.fn(*args, **kwargs)
        self.out.append(self.keep(args, kwargs, res))
        return res

    def remove(self):
        setattr(self.module, self.name, self.fn)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _gathered(trees, mesh):
    """Full numpy trees of a mesh's shard trees (collective), kept on rank 0."""
    if mesh is None:
        return [_np_tree(t) for t in trees]
    full = [sharding.gather_params(t, mesh, CFG) for t in trees]
    return [_np_tree(t) for t in full] if dist.get_rank() == 0 else None


def _loop(job, mesh, max_steps, ckpt=False, snapshot_at=None):
    """``loop.train`` on BATCH_6 up to ``max_steps`` (with ``ckpt``, saving a
    checkpoint a step into the job's directory and resuming from it), its
    draws off (they are per data index). Returns each step's metrics and
    gradients (the norm function's input: what the update applies), the
    replicated gradient leaves' digests on this rank, and the parameters and
    moments after step ``snapshot_at`` (gradients and trees gathered)."""
    kept = {}

    def keep(a, k, r):
        if r[0].step == snapshot_at:
            st = tstep.clone_state(r[0])  # the later steps update the state in place
            kept["trees"] = [st.params, st.opt_state.mu, st.opt_state.nu]
        return {key: float(v) for key, v in r[1].items()}

    steps = _Record(tstep, "train_step_accum", keep)
    norms = _Record(tstep, "global_norm" if mesh is None else "sharded_global_norm",
                    lambda a, k, r: [g.detach().clone() for g in a[0]])
    draws, tloop.step_generator = tloop.step_generator, lambda *a: None
    try:
        state = tloop.train(params_from_jax(job["train_tree"], "cpu"), CFG, OneBatchLoader(BATCH_6), num_epochs=4,
                            max_steps=max_steps, learning_rate=LOOP_LR, ckpt_dir=job["ckpt_dir"] if ckpt else None,
                            ckpt_every=1, mesh=mesh, log_every=100)
    finally:
        steps.remove()
        norms.remove()
        tloop.step_generator = draws
    out = {"metrics": steps.out, "step": state.step}
    grads = [unflatten(dict(zip(flatten(state.params).keys(), g)), state.params) for g in norms.out]
    if mesh is not None and grads:
        flags = dict(zip(flatten(state.params).keys(), sharding.sharded_leaves(state.params, mesh, CFG)))
        out["replicated"] = {k: _digest(v) for k, v in flatten(grads[0]).items() if not flags[k]}
    out["grads"] = _gathered(grads, mesh)
    if snapshot_at is not None:
        out["params"], out["mu"], out["nu"] = _gathered(kept["trees"], mesh) or (None, None, None)
    return out


def _mesh_cases(job, dp, tp):
    mesh = sharding.make_mesh(WORLD, tp=tp)
    rank = dist.get_rank()
    out = {"axes": sharding.axis_sizes(mesh), "coordinate": tuple(mesh.get_coordinate()),
           "data_index": sharding.data_index(mesh)}
    tree, arrays = job["tree"], job["arrays"]
    tp_ctx = sharding.decoder_tp(mesh, CFG)

    # The wrapper, its tokens as generate_tokens_sharded gave them.
    wrapper = MellowWrapper(CFG.name, "v0", "cpu", params=tree, tokenizer=DistinctTokenizer(),
                            use_native_audio=False, mesh=mesh)
    rec = _Record(tmellow, "generate_tokens_sharded", lambda a, k, r: (r.tokens.numpy(), r.num_steps))
    try:
        out["strings"] = wrapper.generate(job["examples"], max_len=MAX_LEN, stop_token=job["stop_char"])
    finally:
        rec.remove()
    out["tokens"], out["num_steps"] = rec.out[0]
    out["train"] = _loop(job, mesh, 2, ckpt=(dp, tp) == (2, 3), snapshot_at=2)
    (a1, a2, ids), done = _pad_done(arrays, 6)

    if (dp, tp) == (2, 3):
        q = params_from_jax(tree, "cpu")
        q["decoder"] = tllama.quantize_decoder(q["decoder"], CFG.decoder)
        res = tmellow.generate_tokens_sharded(sharding.shard_params(q, mesh, CFG), CFG, a1, a2, ids, mesh=mesh,
                                              max_len=MAX_LEN, initial_done=done, kv_cache_dtype="int8", tp=tp_ctx)
        out["int8_tokens"] = res.tokens.numpy()
        g = sharding.shard_params(params_from_jax(job["gpt2_tree"], "cpu"), mesh, GPT2_CFG)
        res = tmellow.generate_tokens_sharded(g, GPT2_CFG, a1, a2, ids, mesh=mesh, max_len=MAX_LEN,
                                              initial_done=done, tp=sharding.decoder_tp(mesh, GPT2_CFG))
        out["gpt2_tokens"] = res.tokens.numpy()

        # Sampling below the encoder: the same three prefixes on both data
        # indices, each index's generator.
        prefix = torch.randn(3, CFG.prefix_length, CFG.decoder.hidden_size, generator=torch.Generator().manual_seed(3))
        dec = sharding.shard_params(params_from_jax(tree, "cpu"), mesh, CFG)["decoder"]
        rec = _Record(tgen, "_sample_token", lambda a, k, r: (a[0].clone(), r.clone(), k))
        try:
            tgen.generate(dec, CFG.decoder, prefix, max_len=8, stop_token_id=-1, greedy=False, top_p=0.9,
                          temperature=1.5, rng=sharding.data_generator(mesh, 7, "cpu"), tp=tp_ctx)
        finally:
            rec.remove()
        kept = all(bool(torch.isfinite(tgen.warp_logits(lg.float(), top_p=k["top_p"], temperature=k["temperature"])
                                        ).gather(1, tok[:, None]).all()) for lg, tok, k in rec.out)
        out["sampled"] = {"tokens": torch.stack([tok for _, tok, _ in rec.out], 1).numpy(), "in_kept_set": kept}

        opt = tstep.make_optimizer()
        try:
            state = tstep.init_train_state(sharding.shard_params(params_from_jax(job["train_tree"], "cpu"), mesh, CFG),
                                           opt)
            tstep.train_step(state, CFG, opt, BATCH_6, torch.Generator(), mixup=True, mesh=mesh)
            out["odd_mixup"] = "no error"
        except ValueError as e:
            out["odd_mixup"] = str(e)
        if rank == 0:
            flat = torch.load(os.path.join(job["ckpt_dir"], "step_2.pt"), weights_only=True)
            out["checkpoint"] = {k: v.numpy() for k, v in flat.items() if k.split("/")[0] in ("mu", "nu")}

    if (dp, tp) == (3, 2):
        out["stream"] = list(wrapper.generate_stream(job["examples"], max_len=MAX_LEN, stop_token=job["stop_char"]))
        norms = _Record(tstep, "sharded_global_norm", lambda a, k, r: [g.detach().clone() for g in a[0]])
        opt = tstep.make_optimizer(learning_rate=LOOP_LR)
        try:
            st = tstep.init_train_state(sharding.shard_params(params_from_jax(job["train_tree"], "cpu"), mesh, CFG), opt)
            st, m = tstep.train_step_accum(st, CFG, opt, BATCH_6, None, 2, mesh=mesh)
        finally:
            norms.remove()
        grads = unflatten(dict(zip(flatten(st.params).keys(), norms.out[0])), st.params)
        out["accum"] = {"metrics": {k: float(v) for k, v in m.items()}, "grads": _gathered([grads], mesh)}
        st = tstep.init_train_state(sharding.shard_params(params_from_jax(job["train_tree"], "cpu"), mesh, CFG), opt)
        rng = tloop.step_generator(0, 0, "cpu", sharding.data_index(mesh))
        st, m = tstep.train_step(st, CFG, opt, BATCH_12, rng, mixup=True, mesh=mesh)
        out["mixup"] = {k: float(v) for k, v in m.items()}

    if (dp, tp) == (6, 1):
        out["resumed"] = _loop(job, mesh, 3, ckpt=True)
        try:
            tmellow.generate_tokens_sharded(sharding.shard_params(params_from_jax(tree, "cpu"), mesh, CFG), CFG,
                                            *(torch.from_numpy(a) for a in arrays), mesh=mesh, max_len=MAX_LEN)
            out["ragged"] = "no error"
        except ValueError as e:
            out["ragged"] = str(e)
        from mellow_tpu_torch.serving import BatchingEngine, ContinuousBatchingEngine

        try:
            ContinuousBatchingEngine(wrapper)
            out["continuous"] = "no error"
        except ValueError as e:
            out["continuous"] = str(e)
        if rank == 0:
            engine = BatchingEngine(wrapper, max_batch_size=3, max_wait_ms=2000, dynamic_batch=False)
            calls = _Record(wrapper, "generate", lambda a, k, r: len(a[0]))
            try:
                futures = [engine.submit(*ex, max_len=MAX_LEN) for ex in job["examples"][:3]]
                out["engine"] = [f.result(timeout=60) for f in futures]
            finally:
                engine.shutdown()
                calls.remove()
                parallel.stop(wrapper)
            out["engine_calls"] = calls.out
        else:
            out["followed"] = parallel.follow(wrapper)
    return out


def _references(job, rank):
    """The unsharded port's results, one share a rank."""
    tree = job["tree"]
    out = {}
    (a1, a2, ids), done = _pad_done(job["arrays"], 6)
    if rank == 0:
        out["train"] = _loop(job, None, 3, snapshot_at=2)
    elif rank == 1:
        norms = _Record(tstep, "global_norm", lambda a, k, r: [g.detach().clone() for g in a[0]])
        opt = tstep.make_optimizer(learning_rate=LOOP_LR)
        try:
            st = tstep.init_train_state(params_from_jax(job["train_tree"], "cpu"), opt)
            st, m = tstep.train_step_accum(st, CFG, opt, BATCH_6, None, 2)
        finally:
            norms.remove()
        grads = unflatten(dict(zip(flatten(st.params).keys(), norms.out[0])), st.params)
        out["accum"] = {"metrics": {k: float(v) for k, v in m.items()}, "grads": [_np_tree(grads)]}
        q = params_from_jax(tree, "cpu")
        q["decoder"] = tllama.quantize_decoder(q["decoder"], CFG.decoder)
        out["int8_tokens"] = tmellow.generate_tokens(q, CFG, a1, a2, ids, max_len=MAX_LEN, initial_done=done,
                                                     kv_cache_dtype="int8").tokens.numpy()
    elif rank == 2:
        # Mixup under DP at (3, 2): each data index's 4 rows with its own
        # draws, the loss the token mean over all 12 rows.
        params = tstep.init_train_state(params_from_jax(job["train_tree"], "cpu"), tstep.make_optimizer()).params
        parts = []
        for d in range(3):
            g = tloop.step_generator(0, 0, "cpu", d)
            rows = {k: torch.as_tensor(v[4 * d : 4 * d + 4]) for k, v in BATCH_12.items()}
            lam = sample_mixup_lambda(g, 4)
            loss, m = tmellow.forward_train(params, CFG, rows["audio1"], rows["audio2"], rows["text_ids"],
                                            rows["answer_ids"], rows["answer_mask"], rng=g, mixup_lambda=lam)
            parts.append((loss, m["num_answer_tokens"]))
        n = sum(p[1] for p in parts)
        loss = sum(p[0] * p[1] for p in parts) / n
        grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)
        norm = tstep.global_norm([g for g in grads if g is not None])
        out["mixup"] = {"loss": float(loss), "num_answer_tokens": float(n), "grad_norm": float(norm)}
    elif rank == 3:
        g = params_from_jax(job["gpt2_tree"], "cpu")
        out["gpt2_tokens"] = tmellow.generate_tokens(g, GPT2_CFG, a1, a2, ids, max_len=MAX_LEN,
                                                     initial_done=done).tokens.numpy()
    elif rank == 4:
        w = MellowWrapper(CFG.name, "v0", "cpu", params=tree, tokenizer=DistinctTokenizer(), use_native_audio=False)
        out["strings"] = w.generate(job["examples"], max_len=MAX_LEN, stop_token=job["stop_char"])
    elif rank == 5:
        w = MellowWrapper(CFG.name, "v0", "cpu", params=tree, tokenizer=DistinctTokenizer(), use_native_audio=False)
        out["engine"] = w.generate(job["examples"][:3], max_len=MAX_LEN)
    return out


BATCH_6 = _train_batch(6, TRAIN_LENS, 5)
BATCH_12 = _train_batch(12, TRAIN_LENS + TRAIN_LENS[::-1], 6)


def rank_main(job):
    """One rank: every mesh's cases, then its share of the references. (2, 3)
    comes first: its loop run writes the checkpoints that (6, 1)'s resumes."""
    rank = dist.get_rank()
    out = {"rank": rank, "meshes": {}}
    for dp, tp in MESHES[::-1]:
        out["meshes"][(dp, tp)] = _mesh_cases(job, dp, tp)
    out["reference"] = _references(job, rank)
    return out


def idle_main(job):
    """Two ranks on a (2, 1) mesh whose collectives time out after
    IDLE_GROUP_S: rank 0 idles IDLE_S, answers three requests, idles again
    and stops; rank 1 follows, its waits for rank 0 in one-second chunks."""
    parallel.WAIT_CHUNK = datetime.timedelta(seconds=1)
    wrapper = MellowWrapper(CFG.name, "v0", "cpu", params=job["tree"], tokenizer=DistinctTokenizer(),
                            use_native_audio=False, mesh=sharding.make_mesh(2, tp=1))
    if dist.get_rank() != 0:
        return {"followed": parallel.follow(wrapper)}
    time.sleep(IDLE_S)
    out = {"answers": wrapper.generate(job["examples"][:3], max_len=MAX_LEN)}
    time.sleep(IDLE_S)
    parallel.stop(wrapper)
    return out


# ---------------------------------------------------------------------------
# this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from mellow_tpu.models import mellow as jmellow
    from mellow_tpu.train import step as jstep
    from tests.torch_port_common import DRYRUN_JAX, port_params_np

    tmp = tmp_path_factory.mktemp("parallel")
    tree = jax.tree.map(np.copy, port_params_np(CFG, 0))
    gpt2_tree = port_params_np(GPT2_CFG, 1)
    train_tree = port_params_np(CFG, 2, scaled=False)
    a, b = _write_wav(tmp / "a.wav", 7.0, 1), _write_wav(tmp / "b.wav", 9.5, 2)
    examples = [[a, b, PROMPTS[0]], [b, a, PROMPTS[1]], [a, a, PROMPTS[2]], [b, b, PROMPTS[3]], [b, a, PROMPTS[4]]]
    # The idle world starts first: its start-up overlaps this process's set-up.
    idle = dryrun.spawn(2, "tests.test_torch_parallel:idle_main", {"tree": tree, "examples": examples},
                        timeout=300.0, group_timeout=IDLE_GROUP_S)
    try:
        w = MellowWrapper(CFG.name, "v0", "cpu", params=tree, tokenizer=DistinctTokenizer(), use_native_audio=False)
        arrays = (w.preprocess_audio([e[0] for e in examples], True),
                  w.preprocess_audio([e[1] for e in examples], True), w.preprocess_text([e[2] for e in examples]))
        # The stop token: row 0's fourth token of a free run, so that row 0
        # stops early and the data ranks leave their loops at different windows.
        free = tmellow.generate_tokens(w.params, CFG, *(torch.from_numpy(x[:1]) for x in arrays), max_len=4,
                                       stop_token_id=-1)
        stop = int(free.tokens[0, 3])
        job = {"tree": tree, "gpt2_tree": gpt2_tree, "train_tree": train_tree, "arrays": arrays,
               "stop_char": DistinctTokenizer().decode([stop]), "examples": examples, "ckpt_dir": str(tmp / "ckpt")}
        ranks = dryrun.spawn(WORLD, "tests.test_torch_parallel:rank_main", job, timeout=300.0, group_timeout=60.0)
        try:
            def jax_train():
                opt = jstep.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=100)
                state = jstep.init_train_state(jax.tree.map(jnp.asarray, train_tree), opt)
                _, jm = jstep.train_step(state, DRYRUN_JAX, opt, {k: jnp.asarray(v) for k, v in BATCH_6.items()},
                                         None)
                return {k: float(v) for k, v in jm.items()}

            # The two compiles overlap in threads.
            with ThreadPoolExecutor(1) as pool:
                train = pool.submit(jax_train)
                jt = jmellow.generate_tokens(jax.tree.map(jnp.asarray, tree), DRYRUN_JAX,
                                             *(jnp.asarray(x) for x in arrays), max_len=MAX_LEN, stop_token_id=stop)
                jax_out = {"tokens": np.asarray(jt.tokens), "num_steps": int(jt.num_steps), "train": train.result()}
            results = ranks.wait()
        finally:
            ranks.close()
        idled = idle.wait()
    finally:
        idle.close()
    return {"jax": jax_out, "ranks": results, "idle": idled, "stop": stop, "train_tree": train_tree,
            "reference": {k: v for r in results for k, v in r["reference"].items()}}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def test_param_specs_match_jax():
    """The port's spec tree is JAX's (``mellow_param_specs``) with the layers'
    leading L axis dropped, at tp 1, 2 and 3, for the float and the int8
    decoder; GPT-2 and the encoder replicated."""
    import jax
    from types import SimpleNamespace

    from mellow_tpu.models import llama as jllama
    from mellow_tpu.parallel import sharding as jsharding

    tree = tmellow.init_params(CFG, 0)
    for int8 in (False, True):
        jtree, ptree = tree, params_from_jax(tree, "cpu")
        if int8:
            # The int8 tree's structure is all the specs read: traced, not run.
            jtree = {**tree, "decoder": jax.eval_shape(lambda d: jllama.quantize_decoder(d, CFG.decoder),
                                                       tree["decoder"])}
            ptree["decoder"] = tllama.quantize_decoder(ptree["decoder"], CFG.decoder)
        for tp in (1, 2, 3):
            mesh = SimpleNamespace(shape={"data": WORLD // tp, "model": tp})
            want = jax.tree_util.tree_flatten_with_path(
                jsharding.mellow_param_specs(jtree, mesh), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
            got = _specs_flat(sharding.mellow_param_specs(ptree, mesh, CFG.decoder.num_kv_heads))
            seen = 0
            for path, spec in want:
                keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
                spec = tuple(spec)
                if keys[:2] == ["decoder", "layers"]:
                    spec = spec[1:]
                    for i in range(CFG.decoder.num_layers):
                        name = "/".join(map(str, keys[:2] + [i] + keys[2:]))
                        assert got[name] == spec, (int8, tp, name)
                        seen += 1
                else:
                    assert got["/".join(map(str, keys))] == spec, (int8, tp, keys)
                    seen += 1
            assert seen == len(tree_leaves(ptree))
    assert sharding.mellow_param_specs(ptree, SimpleNamespace(shape={"model": 3}))["decoder"]["layers"][0]["wq"]["q"] \
        == (None, "model")
    g = params_from_jax(tmellow.init_params(GPT2_CFG, 0), "cpu")
    specs = sharding.mellow_param_specs(g, SimpleNamespace(shape={"model": 3}))
    assert all(s == () for s in _specs_flat(specs).values())


def _specs_flat(specs, prefix=""):
    """{path: spec} of a spec tree, its tuples the leaves."""
    if isinstance(specs, dict):
        return {k: v for key, sub in specs.items() for k, v in _specs_flat(sub, f"{prefix}{key}/").items()}
    if isinstance(specs, list):
        return {k: v for i, sub in enumerate(specs) for k, v in _specs_flat(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: specs}


def test_initialize_single_process():
    """With nothing given and nothing in the environment, ``initialize``
    joins nothing and reports a world of one; this process is primary."""
    assert not any(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))
    info = multihost.initialize()
    assert info == {"process_index": 0, "process_count": 1, "local_devices": 1, "global_devices": 1}
    assert not dist.is_initialized() and multihost.is_primary()
    with pytest.raises(RuntimeError, match="initialize"):
        sharding.make_mesh()


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_shapes(runs, mesh):
    dp, tp = mesh
    for r in runs["ranks"]:
        got = r["meshes"][mesh]
        assert got["axes"] == {"data": dp, "model": tp}
        assert got["coordinate"] == (r["rank"] // tp, r["rank"] % tp) and got["data_index"] == r["rank"] // tp


@pytest.mark.parametrize("mesh", MESHES)
def test_greedy_tokens_equal_jax(runs, mesh):
    """The mesh wrapper's fp32 greedy tokens at B=5 (one padding row) equal
    JAX's unsharded ``generate_tokens`` on every rank, after the stop trim,
    with JAX's step count; row 0 stops early, so data ranks leave their
    loops apart. Its strings equal the unsharded port wrapper's."""
    jt, stop = runs["jax"], runs["stop"]
    want = tgen.tokens_to_lists(tgen.GenerateResult(torch.from_numpy(jt["tokens"].copy()), jt["num_steps"]), stop)
    assert len(want[0]) <= 3 and max(map(len, want)) > 3
    strings = runs["reference"]["strings"]
    assert len(set(strings)) == 5 and strings == [DistinctTokenizer().decode(w) for w in want]
    for r in runs["ranks"]:
        got = r["meshes"][mesh]
        assert got["num_steps"] == jt["num_steps"]
        res = tgen.GenerateResult(torch.from_numpy(got["tokens"][:5]), got["num_steps"])
        assert tgen.tokens_to_lists(res, stop) == want
        assert got["strings"] == strings


@pytest.mark.parametrize("case", ["int8_tokens", "gpt2_tokens"])
def test_int8_and_gpt2_equal_unsharded(runs, case):
    """int8 weights with an int8 cache (the cache's scales maxed over the
    model group's KV heads), and the replicated GPT-2 family, at (2, 3)."""
    want = runs["reference"][case]
    for r in runs["ranks"]:
        np.testing.assert_array_equal(r["meshes"][(2, 3)][case][:5], want[:5])


def test_sampling_streams(runs):
    """At (2, 3), below the encoder, with the same rows on both data
    indices: every rank of a model group draws the same tokens, the data
    indices draw otherwise, and every draw is in its step's kept set."""
    by_index = {}
    for r in runs["ranks"]:
        s = r["meshes"][(2, 3)]["sampled"]
        assert s["in_kept_set"] and s["tokens"].shape == (3, 8)
        by_index.setdefault(r["rank"] // 3, []).append(s["tokens"])
    for toks in by_index.values():
        assert all(np.array_equal(t, toks[0]) for t in toks)
    assert not np.array_equal(by_index[0][0], by_index[1][0])


def test_stream_ends_with_generate(runs):
    for r in runs["ranks"]:
        got = r["meshes"][(3, 2)]
        assert len(got["stream"]) == 2 and got["stream"][-1] == got["strings"]


def test_engine_with_followers(runs):
    """``BatchingEngine`` on rank 0 answers 3 requests as the unsharded
    wrapper does; the other ranks' ``follow`` serve its one call and stop."""
    r0 = runs["ranks"][0]["meshes"][(6, 1)]
    assert r0["engine"] == runs["reference"]["engine"] and r0["engine_calls"] == [3]
    assert [r["meshes"][(6, 1)]["followed"] for r in runs["ranks"][1:]] == [1] * 5


def test_follower_outlasts_the_group_timeout(runs):
    """A rank 0 idle for longer than the group's collective timeout, before
    its call and before ``stop``: the follower waits on the store, not in a
    collective, so it serves the call (the unsharded wrapper's answers) and
    stops."""
    assert IDLE_S > IDLE_GROUP_S
    assert runs["idle"][0]["answers"] == runs["reference"]["engine"]
    assert runs["idle"][1] == {"followed": 1}


def _close(got, want, tol=1e-5):
    for k, g in want.items():
        assert np.abs(got[k] - g).max() <= tol * max(np.abs(g).max(), 1e-30), k


@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_matches_jax_and_unsharded(runs, mesh):
    """``loop.train``'s first two steps (rng None, 6 rows whose ranks hold
    different token counts): step 1's loss, accuracy, answer tokens and
    grad norm within 1e-5 of JAX's unsharded ``train_step``; every gathered
    gradient leaf of both steps within 1e-5 x max|leaf| of the unsharded
    port's; replicated leaves equal across each model group; the
    parameters after two steps within 1e-2 x lr of AdamW run on the full
    tensors with the mesh's gradients and norms (the optimizer on the local
    shards)."""
    dp, tp = mesh
    jm, ref = runs["jax"]["train"], runs["reference"]["train"]
    for r in runs["ranks"]:
        m = r["meshes"][mesh]["train"]["metrics"][0]
        for k in ("loss", "accuracy", "num_answer_tokens", "grad_norm"):
            assert _rel(m[k], jm[k]) <= 1e-5, (k, m[k], jm[k])
    got = runs["ranks"][0]["meshes"][mesh]["train"]
    assert len(got["grads"]) == 2
    for g, want in zip(got["grads"], ref["grads"]):
        _close(g, want)
    for d in range(dp):
        digests = [runs["ranks"][d * tp + m]["meshes"][mesh]["train"]["replicated"] for m in range(tp)]
        assert len(digests[0]) > 0 and all(x == digests[0] for x in digests)

    opt = tstep.make_optimizer(learning_rate=LOOP_LR)
    params = params_from_jax(runs["train_tree"], "cpu")
    names = list(flatten(params))
    state = opt.init(params)
    for grads, m in zip(got["grads"], got["metrics"]):
        state = opt.apply(params, [torch.from_numpy(grads[k]) for k in names], state,
                          norm=torch.tensor(m["grad_norm"]))
    lr = opt.schedule(1)
    for k, p in flatten(params).items():
        assert np.abs(got["params"][k] - p.numpy()).max() <= 1e-2 * lr, k


def test_accum_and_mixup_under_dp(runs):
    """``train_step_accum(2)`` at (3, 2) against the unsharded port's (its
    metrics within 1e-5, its gradients within 1e-5 x max|leaf|); mixup at
    (3, 2) on 12 rows against each data index's rows and draws run
    unsharded; an odd local batch (3 rows a rank at (2, 3)) raises."""
    ref = runs["reference"]
    for r in runs["ranks"]:
        got = r["meshes"][(3, 2)]
        for k, v in ref["accum"]["metrics"].items():
            assert _rel(got["accum"]["metrics"][k], v) <= 1e-5, k
        for k, v in ref["mixup"].items():
            assert _rel(got["mixup"][k], v) <= 1e-5, k
        assert "odd" in r["meshes"][(2, 3)]["odd_mixup"]
    _close(runs["ranks"][0]["meshes"][(3, 2)]["accum"]["grads"][0], ref["accum"]["grads"][0])


def test_loop_resumes_across_meshes(runs):
    """``loop.train`` saved at (2, 3) after two steps and resumed at (6, 1)
    for a third: the losses of an uninterrupted unsharded run within 1e-5
    (update 0 runs at rate 0, so the third loss reads the parameters of the
    checkpoint), and the checkpoint's moments (the full trees, gathered) the
    unsharded run's after two steps, within 1e-5 x max|leaf| (1e-4 for the
    second moments, squares of the gradients)."""
    ref = runs["reference"]["train"]
    want = [m["loss"] for m in ref["metrics"]]
    assert ref["step"] == 3 and len(want) == 3 and want[2] != want[1]
    for r in runs["ranks"]:
        first, second = r["meshes"][(2, 3)]["train"], r["meshes"][(6, 1)]["resumed"]
        assert first["step"] == 2 and second["step"] == 3
        losses = [m["loss"] for m in first["metrics"] + second["metrics"]]
        assert len(losses) == 3 and all(_rel(a, b) <= 1e-5 for a, b in zip(losses, want)), (losses, want)
    ckpt = runs["ranks"][0]["meshes"][(2, 3)]["checkpoint"]
    for name, tol in (("mu", 1e-5), ("nu", 1e-4)):
        _close({k[len(name) + 1:]: v for k, v in ckpt.items() if k.startswith(name + "/")}, ref[name], tol)


def test_refusals(runs):
    for r in runs["ranks"]:
        got = r["meshes"][(6, 1)]
        assert "not divisible" in got["ragged"]
        assert "single-device" in got["continuous"]
