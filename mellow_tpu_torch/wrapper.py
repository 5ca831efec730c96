"""MellowWrapper for the PyTorch port: the same constructor, ``generate``
and ``generate_stream`` signatures as ``mellow_tpu.wrapper.MellowWrapper``,
plus an explicit ``device`` (a ``torch.device`` or a string, ``"cuda"`` by
default).

Host preprocessing (wav decode, resample, repeat-pad / crop, tokenisation)
is the JAX wrapper's, on the port's own copies of that code
(``mellow_tpu_torch.io`` and ``mellow_tpu_torch.native``). What differs:

  * fp32 parity mode (``compute_dtype`` None or "float32") or bf16 perf
    mode (``compute_dtype="bfloat16"``: every floating weight, the audio
    and the KV cache in bf16, the hand-written decode-attention,
    prefill-block and Swin-block kernels on the card);
  * decoding as the JAX wrapper's: greedy, or ``sample=True`` with
    ``top_p``, ``temperature``, ``top_k`` and ``seed`` (the port draws from
    the same filtered distribution with its own generator, so sampled
    tokens differ from the JAX package's), ``repetition_penalty``,
    ``dynamic_batch`` (cascade compaction) and ``generate_stream``;
  * the int8 options, under either compute dtype: ``weight_dtype="int8"``
    (int8 decoder weights, quantized from the fp32 weights before the cast
    to the compute dtype, as the JAX wrapper does), ``weight_dtype=
    "int8-w8a8"`` (the same, with the W8A8 prefill blocks in bf16) and
    ``generate(..., kv_cache_dtype="int8")`` (an int8 KV cache; in bf16 the
    int8 decode-attention kernel), in any combination; and a float cache
    in another dtype than the compute dtype (``kv_cache_dtype`` "float32",
    "bfloat16" or "float16"). As in the JAX package, fp32 and a cache in
    another float dtype take the plain formulation, not a kernel;
  * both decoder families (``cfg.decoder_family``): SmolLM2 ("llama") and
    GPT-2 ("gpt2"; its prompts get " <|endoftext|>" appended, its bf16
    prefill runs the hand-written prefill-attention kernel, and it takes
    ``weight_dtype="int8"`` but, as in the JAX package, neither
    ``"int8-w8a8"`` (ValueError) nor an int8 KV cache (ValueError); a
    GPT-2 cache in another float dtype decodes as llama's does, on the
    plain formulation;
  * no power-of-two batch buckets: eager PyTorch does not recompile per
    shape, so the batch runs as given;
  * weights come from ``params=`` (the JAX package's tree layout), then
    ``params_path``, then the ``MELLOW_TPU_PARAMS`` and ``MELLOW_TPU_CKPT``
    environment variables: a ``.ckpt``/``.pt`` path is the reference's
    PyTorch state dict, converted by the port's ``tools/convert_ckpt.py``;
    any other path is a converted ``.npz``. There is no hub download;
  * ``mesh`` (``parallel.sharding.make_mesh``, one process per card): the
    parameters are sharded at load and ``generate`` and
    ``generate_stream`` are collective, every rank calling them with the
    same arguments, or rank 0 alone while the others run
    ``parallel.follow(wrapper)``. Rank 0 prepares the batch on the host and
    sends it to every rank; the batch is padded to a multiple of the data
    axis with rows that start done. A pure-DP mesh runs the single-card
    program, kernels included, on each data rank's rows
    (``mellow.generate_tokens_sharded``); a model axis runs the decoder's
    TP forms on the plain formulation, as the JAX package turns its Pallas
    kernels off there. Cascade compaction (``dynamic_batch``) is off under
    a mesh, as in the JAX package. The wrapper runs on ``cuda:LOCAL_RANK``
    (the process's current card).
"""

from __future__ import annotations

import os
import random
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from mellow_tpu_torch import parallel
from mellow_tpu_torch.parallel import sharding
from mellow_tpu_torch.config import MellowConfig, get_config
from mellow_tpu_torch.io.resample import resample
from mellow_tpu_torch.io.tokenizer import load_tokenizer
from mellow_tpu_torch.io.wav import read_wav
from mellow_tpu_torch.native import binding as native_audio
from mellow_tpu_torch.utils import debug, profiling
from mellow_tpu_torch.utils.metrics import GLOBAL as metrics
from mellow_tpu_torch.utils.params_io import load_params
from mellow_tpu_torch.models import generate as gen
from mellow_tpu_torch.models import gpt2, llama
from mellow_tpu_torch.models import mellow as mellow_model
from mellow_tpu_torch.models.params import cast_floating, count_params, params_from_jax
from mellow_tpu_torch.tools.convert_ckpt import convert_mellow, load_state_dict

_MODELS = ("v0", "v0_s")  # the two published checkpoints of the v0 architecture
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class MellowWrapper:
    """Drop-in for ``mellow_tpu.MellowWrapper`` on a PyTorch device."""

    def __init__(
        self,
        config: str = "v0",
        model: str = "v0",
        device="cuda",
        use_cuda: bool = True,  # accepted for API parity; ``device`` decides
        *,
        params_path: Optional[str] = None,
        params: Optional[dict] = None,
        tokenizer=None,
        compute_dtype: Optional[str] = None,
        weight_dtype: Optional[str] = None,
        use_native_audio: Optional[bool] = None,  # None = auto-detect
        mesh=None,
    ):
        if model not in _MODELS:
            raise ValueError(
                f"The model {model} is not supported. The supported versions are {_MODELS}"
            )
        self.cfg: MellowConfig = get_config(config)
        if compute_dtype:
            self.cfg = self.cfg.replace(compute_dtype=compute_dtype)
        if self.cfg.compute_dtype not in _DTYPES:
            raise NotImplementedError(
                f"compute_dtype={self.cfg.compute_dtype!r} is not ported; use one of {sorted(_DTYPES)}")
        self.dtype = _DTYPES[self.cfg.compute_dtype]
        if weight_dtype not in (None, "int8", "int8-w8a8"):
            raise ValueError(f"unsupported weight_dtype {weight_dtype!r}")
        self._gpt2 = self.cfg.decoder_family == "gpt2"
        if weight_dtype == "int8-w8a8" and self._gpt2:
            raise ValueError("weight_dtype 'int8-w8a8' is llama-family only")
        self._w8a8 = weight_dtype == "int8-w8a8"
        self.mesh = mesh
        self.device = torch.device(device)
        if mesh is not None:
            if (mesh.device_type == "cuda") != (self.device.type == "cuda"):
                raise ValueError(f"a {mesh.device_type} mesh cannot drive a wrapper on {self.device}")
            if self.device.type == "cuda" and self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {self.device} requested but CUDA is not available")
            # No TF32 anywhere: fp32 parity mode is the JAX wrapper's
            # "highest" matmul precision, and bf16 mode's fp32 parts
            # (log-mel, softmaxes) stay full fp32 too.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        tree = self._load_params(params_path, params, self.cfg.decoder.num_layers)
        if weight_dtype is None:
            self.params = params_from_jax(tree, self.device, self.dtype)
        else:
            # Quantize the fp32 weights, then cast every floating leaf (the
            # scales included) to the compute dtype: the JAX wrapper's order.
            p32 = params_from_jax(tree, self.device, torch.float32)
            quantize = gpt2.quantize_gpt2 if self._gpt2 else llama.quantize_decoder
            p32["decoder"] = quantize(p32["decoder"], self.cfg.decoder)
            self.params = cast_floating(p32, self.dtype)
        self._tp = None
        if mesh is not None:
            self.params = sharding.shard_params(self.params, mesh, self.cfg)
            self._tp = sharding.decoder_tp(mesh, self.cfg)
        if use_native_audio is None:
            self._native = native_audio if native_audio.available() else None
        elif use_native_audio:
            if not native_audio.available():
                raise RuntimeError("native audio library is not built")
            self._native = native_audio
        else:
            self._native = None
        self.tokenizer = tokenizer or load_tokenizer("HuggingFaceTB/SmolLM2-135M")
        print(f"model {model}, {config}, parameter count: {count_params(self.params)}")

    @staticmethod
    def _load_params(params_path, params, num_layers: int):
        """The JAX-layout tree from, in order: ``params``, ``params_path``,
        ``MELLOW_TPU_PARAMS``, ``MELLOW_TPU_CKPT``."""
        if params is not None:
            return params
        path = params_path or os.environ.get("MELLOW_TPU_PARAMS")
        if not path:
            ckpt = os.environ.get("MELLOW_TPU_CKPT")
            if not ckpt:
                raise RuntimeError(
                    "No weights available: pass params= (the mellow_tpu parameter tree) or params_path= "
                    "(a .ckpt/.pt state dict or a converted .npz), or set MELLOW_TPU_PARAMS or "
                    "MELLOW_TPU_CKPT (a state dict); the port downloads nothing."
                )
            return convert_mellow(load_state_dict(ckpt), num_layers)
        if path.endswith((".ckpt", ".pt")):
            return convert_mellow(load_state_dict(path), num_layers)
        return load_params(path)

    # ------------------------------------------------------------------
    # preprocessing (host side, as mellow_tpu.wrapper)
    # ------------------------------------------------------------------

    def load_audio_into_array(
        self, audio_path: str, audio_duration: int, do_resample: bool = True,
        crop_start: Optional[int] = None,
    ) -> np.ndarray:
        target_sr = self.cfg.frontend.sample_rate
        need = audio_duration * target_sr
        if self._native is not None:
            seg, full_len, needs_crop = self._native.load_segment(
                audio_path, target_sr, need, -1, do_resample
            )
            if not needs_crop:
                return seg
            start = random.randrange(full_len - need) if crop_start is None else crop_start
            seg, _, _ = self._native.load_segment(audio_path, target_sr, need, start, do_resample)
            return seg
        data, sr = read_wav(audio_path)
        if do_resample and sr != target_sr:
            data = resample(data, sr, target_sr)
        x = data.reshape(-1)  # channels concatenated, as the reference
        if need >= x.shape[0]:
            x = np.tile(x, int(np.ceil(need / x.shape[0])))[:need]
        else:
            start = random.randrange(x.shape[0] - need) if crop_start is None else crop_start
            x = x[start : start + need]
        return x.astype(np.float32)

    def preprocess_audio(self, audio_files: Sequence[str], do_resample: bool, crop_start=None) -> np.ndarray:
        """``crop_start``: None = an independent random crop per file; an int
        pins every file; a sequence pins each file."""
        if crop_start is None or isinstance(crop_start, int):
            starts = [crop_start] * len(audio_files)
        else:
            if len(crop_start) != len(audio_files):
                raise ValueError("crop_start sequence must match the number of files")
            starts = list(crop_start)
        segs = [
            self.load_audio_into_array(f, self.cfg.frontend.segment_seconds, do_resample, s)
            for f, s in zip(audio_files, starts)
        ]
        return np.stack(segs, axis=0)  # (B, 320000)

    def preprocess_text(self, prompts: Sequence[str]) -> np.ndarray:
        if self._gpt2:
            # The reference appends the eos string for gpt-family decoders.
            prompts = [p + " <|endoftext|>" for p in prompts]
        rows = [self.tokenizer.encode_padded(p, self.cfg.text_tokenization_len) for p in prompts]
        return np.asarray(rows, dtype=np.int32)

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------

    def generate(
        self,
        examples: Sequence[Sequence[str]],
        max_len: int = 300,
        top_p: float = 0.8,
        temperature: float = 1.0,
        stop_token: str = "<|endoftext|>",
        audio_resample: bool = True,
        *,
        sample: bool = False,
        seed: int = 0,
        crop_start: Optional[int] = None,
        kv_cache_dtype: Optional[str] = None,
        top_k: int = 0,  # sampling only (0 = off)
        repetition_penalty: float = 1.0,  # HF/CTRL convention; 1.0 = off
        dynamic_batch: bool = False,  # cascade compaction: finished rows stop
        # costing decode steps (generate.generate_cascade)
    ) -> List[str]:
        """Text for each [audio1, audio2, prompt] example: greedy, or with
        ``sample=True`` a draw from the top-k / top-p / temperature filtered
        softmax seeded by ``seed``."""
        cache = self.cache_dtype(kv_cache_dtype)
        if self.mesh is not None:
            kw = dict(max_len=max_len, top_p=top_p, temperature=temperature, stop_token=stop_token,
                      sample=sample, seed=seed, kv_cache_dtype=cache, top_k=top_k,
                      repetition_penalty=repetition_penalty)
            return self._mesh_call("generate", examples, audio_resample, crop_start, kw)
        audio1, audio2, text_ids = self._host_inputs(examples, audio_resample, crop_start)

        with profiling.trace(), debug.checking(), metrics.timer("generate"):
            gen_fn = mellow_model.generate_tokens_dynamic if dynamic_batch else mellow_model.generate_tokens
            result = gen_fn(
                self.params, self.cfg, *self._device_inputs(audio1, audio2, text_ids),
                max_len=max_len, greedy=not sample, top_p=top_p, temperature=temperature,
                rng=self._rng(seed), kv_cache_dtype=cache,
                stop_token_id=self._stop_token_id(stop_token), top_k=top_k,
                repetition_penalty=repetition_penalty, w8a8=self._w8a8,
            )
            texts = self._detokenize(result, stop_token)
        metrics.count("tokens", len(examples) * result.num_steps)
        metrics.count("clips", 2 * len(examples))
        metrics.count("generate_calls", 1)
        return texts

    def generate_stream(
        self,
        examples: Sequence[Sequence[str]],
        max_len: int = 300,
        top_p: float = 0.8,
        temperature: float = 1.0,
        stop_token: str = "<|endoftext|>",
        audio_resample: bool = True,
        *,
        sample: bool = False,
        seed: int = 0,
        crop_start: Optional[int] = None,
        kv_cache_dtype: Optional[str] = None,
        top_k: int = 0,
        repetition_penalty: float = 1.0,
    ) -> Iterator[List[str]]:
        """Streaming ``generate``: yields the batch's texts so far after every
        flush window, each already trimmed at the stop token, and ends with
        the complete texts (``generate``'s: the same tokens, one host fetch
        a window)."""
        cache = self.cache_dtype(kv_cache_dtype)
        if self.mesh is not None:
            kw = dict(max_len=max_len, top_p=top_p, temperature=temperature, stop_token=stop_token,
                      sample=sample, seed=seed, kv_cache_dtype=cache, top_k=top_k,
                      repetition_penalty=repetition_penalty)
            yield from self._mesh_call("generate_stream", examples, audio_resample, crop_start, kw)
            return
        host = self._host_inputs(examples, audio_resample, crop_start)
        with debug.checking():
            a1, a2, ids = self._device_inputs(*host)
            prefix = mellow_model.encode_and_prefix(self.params, self.cfg, a1, a2, ids)
        for result in debug.checked(gen.generate_stream(
            self.params["decoder"], self.cfg.decoder, prefix,
            max_len=max_len, stop_token_id=self._stop_token_id(stop_token), greedy=not sample,
            top_p=top_p, temperature=temperature, rng=self._rng(seed),
            kv_cache_dtype=cache, family=self.cfg.decoder_family, top_k=top_k,
            repetition_penalty=repetition_penalty, prompt_tokens=ids,
            prompt_mask=ids != self.cfg.pad_token_id, w8a8=self._w8a8,
        )):
            yield self._detokenize(result, stop_token)

    def cache_dtype(self, kv_cache_dtype: Optional[str]) -> Optional[str]:
        """The decoder's ``kv_cache_dtype`` for a request's (the JAX
        wrapper's ``kv_cache_dtype or str(dtype)``): None for the compute
        dtype, else "int8" or another float dtype. Raises on a dtype the
        port does not take."""
        if kv_cache_dtype in (None, self.cfg.compute_dtype):
            return None
        if kv_cache_dtype not in gen.CACHE_DTYPES:
            raise NotImplementedError(
                f"kv_cache_dtype={kv_cache_dtype!r} is not ported; use one of {sorted(gen.CACHE_DTYPES)}")
        return kv_cache_dtype

    def _host_inputs(self, examples, audio_resample: bool, crop_start):
        """The batch's waves and prompt ids as numpy arrays."""
        audio1 = self.preprocess_audio([e[0] for e in examples], audio_resample, crop_start)
        audio2 = self.preprocess_audio([e[1] for e in examples], audio_resample, crop_start)
        return audio1, audio2, self.preprocess_text([e[2] for e in examples])

    # ------------------------------------------------------------------
    # under a mesh
    # ------------------------------------------------------------------

    def _mesh_call(self, kind: str, examples, audio_resample: bool, crop_start, kw: dict):
        """One collective ``generate`` (a list of texts) or
        ``generate_stream`` (an iterator of them): rank 0 prepares the batch
        on the host and broadcasts it with the options, every rank runs
        ``_mesh_run`` on rank 0's call (``parallel.follow`` is the same on a
        rank that did not call)."""
        msg = None
        if dist.get_rank() == 0:
            msg = (kind, self._host_inputs(examples, audio_resample, crop_start), kw)
        return self._mesh_run(parallel.exchange(msg))

    def _mesh_run(self, msg):
        kind, (audio1, audio2, text_ids), kw = msg
        B = audio1.shape[0]
        dp = sharding.axis_sizes(self.mesh)["data"]
        pad = -B % dp
        if pad:  # rows that start done, so they neither extend the loop nor change a real row
            audio1, audio2, text_ids = (np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
                                        for x in (audio1, audio2, text_ids))
        done = torch.arange(B + pad, device=self.device) >= B
        a1, a2, ids = self._device_inputs(audio1, audio2, text_ids)
        stop_token = kw["stop_token"]
        opts = dict(max_len=kw["max_len"], greedy=not kw["sample"], top_p=kw["top_p"],
                    temperature=kw["temperature"], kv_cache_dtype=kw["kv_cache_dtype"],
                    stop_token_id=self._stop_token_id(stop_token), top_k=kw["top_k"],
                    repetition_penalty=kw["repetition_penalty"])
        if kind == "generate_stream":
            return self._mesh_stream(a1, a2, ids, done, B, kw["seed"], stop_token, opts)
        with profiling.trace(), debug.checking(), metrics.timer("generate"):
            result = mellow_model.generate_tokens_sharded(
                self.params, self.cfg, a1, a2, ids, mesh=self.mesh, seed=kw["seed"], initial_done=done,
                w8a8=self._w8a8, tp=self._tp, **opts)
            texts = self._detokenize(result, stop_token)[:B]
        metrics.count("tokens", B * result.num_steps)
        metrics.count("clips", 2 * B)
        metrics.count("generate_calls", 1)
        return texts

    def _mesh_stream(self, a1, a2, ids, done, B: int, seed: int, stop_token: str, opts: dict):
        """``generate_stream`` on this rank's rows, every yield all the rows'
        texts. Closed early, it still runs the windows that the other ranks
        run, so no rank waits in a collective."""
        rows = sharding.data_rows(self.mesh, a1.shape[0])
        with debug.checking():
            prefix = mellow_model.encode_and_prefix(self.params, self.cfg, a1[rows], a2[rows], ids[rows],
                                                    tp=self._tp)
        it = debug.checked(gen.generate_stream(
            self.params["decoder"], self.cfg.decoder, prefix, rng=sharding.data_generator(self.mesh, seed, self.device),
            initial_done=done[rows], family=self.cfg.decoder_family, prompt_tokens=ids[rows],
            prompt_mask=ids[rows] != self.cfg.pad_token_id, w8a8=self._w8a8, tp=self._tp,
            data_group=sharding.data_group(self.mesh), **opts))
        try:
            for result in it:
                yield self._detokenize(result, stop_token)[:B]
        finally:
            for _ in it:
                pass

    def _device_inputs(self, audio1, audio2, text_ids):
        return (torch.from_numpy(audio1).to(device=self.device, dtype=self.dtype),
                torch.from_numpy(audio2).to(device=self.device, dtype=self.dtype),
                torch.from_numpy(text_ids).to(self.device))

    def _rng(self, seed: int) -> torch.Generator:
        """The sampler's generator on the wrapper's device, seeded."""
        rng = torch.Generator(device=self.device)
        rng.manual_seed(seed)
        return rng

    def _stop_token_id(self, stop_token: str) -> int:
        """The stop token's first id, as the reference derives it, or the
        configuration's."""
        stop_ids = self.tokenizer.encode(stop_token)
        return int(stop_ids[0]) if stop_ids else self.cfg.stop_token_id

    def _detokenize(self, result: gen.GenerateResult, stop_token: str) -> List[str]:
        tokens = result.tokens.cpu().numpy()[:, : result.num_steps]
        return [self.tokenizer.decode(row.tolist()).split(stop_token)[0] for row in tokens]

