"""MellowWrapper for the PyTorch port: the same constructor and ``generate``
signature as ``mellow_tpu.wrapper.MellowWrapper``, plus an explicit
``device`` (a ``torch.device`` or a string, ``"cuda"`` by default).

Host preprocessing (wav decode, resample, repeat-pad / crop, tokenisation)
is the JAX wrapper's, on the shared jax-free ``mellow_tpu.io`` and
``mellow_tpu.native`` code. What differs:

  * fp32 greedy only: ``sample=True``, a non-fp32 ``kv_cache_dtype`` or
    ``compute_dtype``, ``weight_dtype``, ``mesh``, ``dynamic_batch`` and
    ``repetition_penalty != 1`` raise;
  * no power-of-two batch buckets: eager PyTorch does not recompile per
    shape, so the batch runs as given;
  * weights come from ``params=`` (the JAX package's tree layout) or from a
    ``params_path`` .npz; there is no hub download.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence

import numpy as np
import torch

from mellow_tpu.config import MellowConfig, get_config
from mellow_tpu.io.resample import resample
from mellow_tpu.io.tokenizer import load_tokenizer
from mellow_tpu.io.wav import read_wav
from mellow_tpu.native import binding as native_audio
from mellow_tpu.utils.metrics import GLOBAL as metrics
from mellow_tpu.utils.params_io import load_params
from mellow_tpu_torch.models import mellow as mellow_model
from mellow_tpu_torch.models.params import count_params, params_from_jax

_MODELS = ("v0", "v0_s")  # the two published checkpoints of the v0 architecture


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
        if self.cfg.compute_dtype != "float32":
            raise NotImplementedError("the port runs compute_dtype='float32' only")
        if self.cfg.decoder_family != "llama":
            raise NotImplementedError("the port runs the llama decoder family only")
        if weight_dtype is not None:
            raise NotImplementedError("weight_dtype (int8 weights) is not ported")
        if mesh is not None:
            raise NotImplementedError("mesh (multi-device inference) is not ported")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {self.device} requested but CUDA is not available")
            # fp32 parity mode: no TF32 anywhere (the JAX wrapper's
            # "highest" matmul precision).
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        self.params = params_from_jax(self._load_params(params_path, params), self.device)
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
    def _load_params(params_path, params):
        if params is not None:
            return params
        if params_path is None:
            raise RuntimeError(
                "No weights available: pass params= (the mellow_tpu parameter "
                "tree) or params_path= (a converted .npz)."
            )
        return load_params(params_path)

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
        top_k: int = 0,
        repetition_penalty: float = 1.0,
        dynamic_batch: bool = False,
    ) -> List[str]:
        """Text for each [audio1, audio2, prompt] example, greedy. ``top_p``,
        ``temperature``, ``top_k`` and ``seed`` do not change a greedy
        answer and are accepted for API parity."""
        if sample:
            raise NotImplementedError("sample=True (nucleus sampling) is not ported")
        if kv_cache_dtype not in (None, "float32"):
            raise NotImplementedError(f"kv_cache_dtype={kv_cache_dtype!r} is not ported")
        if repetition_penalty != 1.0:
            raise NotImplementedError("repetition_penalty is not ported")
        if dynamic_batch:
            raise NotImplementedError("dynamic_batch (cascade compaction) is not ported")

        audio1 = self.preprocess_audio([e[0] for e in examples], audio_resample, crop_start)
        audio2 = self.preprocess_audio([e[1] for e in examples], audio_resample, crop_start)
        text_ids = self.preprocess_text([e[2] for e in examples])
        stop_ids = self.tokenizer.encode(stop_token)
        stop_token_id = int(stop_ids[0]) if stop_ids else self.cfg.stop_token_id

        with metrics.timer("generate"):
            result = mellow_model.generate_tokens(
                self.params, self.cfg,
                torch.from_numpy(audio1).to(self.device),
                torch.from_numpy(audio2).to(self.device),
                torch.from_numpy(text_ids).to(self.device),
                max_len=max_len, stop_token_id=stop_token_id,
            )
            tokens = result.tokens.cpu().numpy()[:, : result.num_steps]
            texts = [self.tokenizer.decode(row.tolist()).split(stop_token)[0] for row in tokens]
        metrics.count("tokens", len(examples) * result.num_steps)
        metrics.count("clips", 2 * len(examples))
        metrics.count("generate_calls", 1)
        return texts
