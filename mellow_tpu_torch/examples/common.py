"""Shared scaffolding of the port's examples: arguments, demo audio, the
wrapper (``mellow_tpu_torch.cli.build_wrapper``: weights from
``MELLOW_TPU_PARAMS`` / ``MELLOW_TPU_CKPT``, else random weights and the
byte tokenizer) and a print of each answer."""

from __future__ import annotations

import argparse
import os
import tempfile
import wave

import numpy as np


def write_demo_wav(path: str, seconds: float, seed: int, sr: int = 44100) -> str:
    """A seeded mono PCM16 wav: two tones and noise, so the example needs no
    audio file."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f1, f2 = rng.uniform(200, 2000, 2)
    x = 0.3 * np.sin(2 * np.pi * f1 * t) + 0.2 * np.sin(2 * np.pi * f2 * t) + 0.05 * rng.standard_normal(t.size)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return path


def main(task, description: str, model: str = "v0", argv=None):
    """Parse the example's arguments, build the wrapper and call ``task(
    wrapper, audio1, audio2)``; without audio paths, on two demo wavs
    written to a temporary directory."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("audio", nargs="*", help="two wav paths (default: demo wavs)")
    ap.add_argument("--config", default="v0")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compute-dtype", default=None, choices=[None, "float32", "bfloat16"])
    args = ap.parse_args(argv)
    if args.audio and len(args.audio) != 2:
        ap.error("give two audio paths, or none for the demo wavs")
    from mellow_tpu_torch.cli import build_wrapper

    wrapper = build_wrapper(args.config, model, args.device, compute_dtype=args.compute_dtype)
    with tempfile.TemporaryDirectory() as d:
        a1, a2 = args.audio or (write_demo_wav(os.path.join(d, "a.wav"), 7.0, 1),
                                write_demo_wav(os.path.join(d, "b.wav"), 9.5, 2))
        return task(wrapper, a1, a2)


def run(wrapper, examples, max_len=300, top_p=0.8, temperature=1.0):
    """Generate for ``examples`` ([audio1, audio2, prompt] each), print each
    answer and the metrics."""
    from mellow_tpu_torch.utils.metrics import GLOBAL as metrics

    preds = wrapper.generate(examples, max_len=max_len, top_p=top_p, temperature=temperature)
    for (_, _, prompt), pred in zip(examples, preds):
        print(f"prompt: {prompt!r}\n  -> {pred!r}")
    metrics.dump()
    return preds
