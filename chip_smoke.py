#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mellow_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, in order; any failure raises, so the exit code is non-zero and no
result line is printed:

1. the card's name and power limit (``nvidia-smi``); no CUDA device fails;
2. build the CUDA kernels from ``mellow_tpu_torch/csrc`` (into ``build/``);
3. kernel phase: each kernel against its plain PyTorch version on the card,
   at the main path's shapes, with CUDA-event timings of both;
4. slice phase: ``MellowWrapper(config="v0", model="v0", device="cuda")`` at
   full v0 width with random weights from a seed answers requests one at a
   time, as a batch, and through ``mellow_tpu.serving.BatchingEngine``; the
   kernels' launch counts show the path went through them; a repeated
   request gives identical text; the encoder prefix and the prefill logits
   agree with the same computation on the CPU (plain versions).

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np
import torch

from mellow_tpu.config import get_config
from mellow_tpu.io.tokenizer import ByteTokenizer
from mellow_tpu.serving import BatchingEngine
from mellow_tpu.utils.metrics import GLOBAL as metrics
from mellow_tpu_torch import MellowWrapper
from mellow_tpu_torch.models import llama
from mellow_tpu_torch.models.mellow import encode_and_prefix, init_params
from mellow_tpu_torch.models.params import params_from_jax
from mellow_tpu_torch.ops import _build, melspec
from mellow_tpu_torch.ops import frontend as fe

SEED = 0
MAX_LEN = 32
# What the TPU kernel is held to (tests/test_pallas_melspec.py): fp32 DFT
# sums of 1024 terms in another order.
KERNEL_TOL = {"atol": 5e-4, "rtol": 1e-4}
# CUDA against CPU through the whole fp32 encoder and 30 decoder layers:
# the same math with sums in another order.
SLICE_TOL = {"atol": 2e-3, "rtol": 1e-3}


def _median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _write_wav(path: str, seconds: float, seed: int, sr: int = 44100) -> str:
    """Seeded mono PCM16 clip: two tones and noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = (0.3 * np.sin(2 * np.pi * (220.0 + 110.0 * seed) * t)
         + 0.1 * np.sin(2 * np.pi * 3100.0 * t) + 0.05 * rng.standard_normal(t.size))
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return path


def kernel_phase(cfg) -> dict:
    rng = np.random.default_rng(SEED)
    row = {"name": "log_mel", "route": "cuda", "source": "mellow_tpu_torch/csrc/melspec.cu",
           "replaces": "mellow_tpu/ops/pallas_melspec.py:84"}
    errs = []
    for batch in (1, 2):
        wave_ = torch.from_numpy(
            (rng.standard_normal((batch, cfg.num_samples)) * 0.1).astype(np.float32)).cuda()
        out = melspec.log_mel_cuda(wave_, cfg)
        torch.cuda.synchronize()
        ref = fe.log_mel_spectrogram(wave_, cfg)
        if out.shape != (batch, cfg.num_frames, cfg.n_mels) or not torch.isfinite(out).all():
            raise RuntimeError(f"log_mel kernel output bad at B={batch}: {tuple(out.shape)}")
        err = (out - ref).abs().max().item()
        errs.append(err)
        torch.testing.assert_close(out, ref, **KERNEL_TOL)
        # Alternate plain, kernel, kernel, plain on the same card.
        plain = [_median_ms(lambda: fe.log_mel_spectrogram(wave_, cfg))]
        kern = [_median_ms(lambda: melspec.log_mel_cuda(wave_, cfg)) for _ in range(2)]
        plain.append(_median_ms(lambda: fe.log_mel_spectrogram(wave_, cfg)))
        ms, plain_ms = statistics.mean(kern), statistics.mean(plain)
        print(f"log_mel B={batch}: max_abs_err {err:.3e} (atol {KERNEL_TOL['atol']}, "
              f"rtol {KERNEL_TOL['rtol']}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(median of 20 CUDA-event runs, 2 rounds each)")
        suffix = "" if batch == 1 else f"_b{batch}"
        row["ms" + suffix], row["plain_ms" + suffix] = ms, plain_ms
    row["max_abs_err"] = max(errs)
    return row


def slice_phase(cfg) -> int:
    """Drive the port's main path; return the kernel launches it made."""
    t0 = time.perf_counter()
    params = init_params(cfg, SEED)
    wrapper = MellowWrapper(config="v0", model="v0", device="cuda", params=params,
                            tokenizer=ByteTokenizer())
    print(f"weights made and loaded in {time.perf_counter() - t0:.2f} s")

    with tempfile.TemporaryDirectory() as tmp:
        a = _write_wav(os.path.join(tmp, "a.wav"), 7.0, 1)  # repeat-padded
        b = _write_wav(os.path.join(tmp, "b.wav"), 9.5, 2)
        requests = [[a, b, "caption the audio."],
                    [b, a, "what is different between the two clips?"],
                    [a, a, "is there speech?"]]

        def counters():
            return {k: metrics.counters.get(k, 0.0) for k in ("generate_calls", "clips", "tokens")}

        def timed(examples):
            before = counters()
            t = time.perf_counter()
            texts = wrapper.generate(examples, max_len=MAX_LEN)
            dt = time.perf_counter() - t
            n = counters()["tokens"] - before["tokens"]
            print(json.dumps({"rows": len(examples), "latency_s": dt, "tokens": n,
                              "tokens_per_s": n / dt, "texts": texts}))
            return texts

        melspec.LAUNCHES = 0
        start = counters()
        singles = [timed([ex])[0] for ex in requests]
        batch = timed(requests[:2])
        print(f"batch of 2 equals the single answers: {batch == singles[:2]}")
        if timed([requests[0]])[0] != singles[0]:
            raise RuntimeError("a repeated request gave a different answer")

        engine = BatchingEngine(wrapper, dynamic_batch=False)
        try:
            t = time.perf_counter()
            futures = [engine.submit(*ex, max_len=MAX_LEN) for ex in requests[:2]]
            served = [f.result(timeout=600) for f in futures]
            print(json.dumps({"engine_requests": len(served),
                              "latency_s": time.perf_counter() - t, "texts": served}))
        finally:
            engine.shutdown()
        launches = melspec.LAUNCHES
        end = counters()
        calls = end["generate_calls"] - start["generate_calls"]
        clips = end["clips"] - start["clips"]
        rows = clips // 2
        print(f"slice: {rows:.0f} rows in {calls:.0f} generate calls, "
              f"{end['tokens'] - start['tokens']:.0f} tokens, {launches} log_mel launches")
        if rows < 5:
            raise RuntimeError(f"only {rows} requests answered")
        if launches != 2 * calls:
            raise RuntimeError(f"log_mel launched {launches} times for {calls} calls "
                               "(each call encodes its two clip batches once)")

        # The main path's numbers against the same computation on the CPU,
        # where every kernel is its plain version.
        audio1 = wrapper.preprocess_audio([a], True)
        audio2 = wrapper.preprocess_audio([b], True)
        text = wrapper.preprocess_text([requests[0][2]])
    cpu_params = params_from_jax(params, "cpu")
    outs = {}
    for device, p in (("cuda", wrapper.params), ("cpu", cpu_params)):
        args = [torch.from_numpy(x).to(device) for x in (audio1, audio2, text)]
        with torch.no_grad():
            prefix = encode_and_prefix(p, cfg, *args)
            cache = llama.KVCache.create(cfg.decoder, 1, prefix.shape[1], device)
            hidden = llama.prefill(p["decoder"], cfg.decoder, prefix, cache)
            logits = llama.logits_from_hidden(p["decoder"], cfg.decoder, hidden)
        outs[device] = (prefix.cpu(), logits.cpu())
    for name, got, ref in zip(("prefix", "logits"), outs["cuda"], outs["cpu"]):
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"{name}: bad output {tuple(got.shape)}")
        print(f"{name} {tuple(got.shape)}: CUDA vs CPU max_abs_err "
              f"{(got - ref).abs().max().item():.3e}")
        torch.testing.assert_close(got, ref, **SLICE_TOL)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t = time.perf_counter()
    _build.load_library()
    print(f"kernels built and loaded in {time.perf_counter() - t:.2f} s")
    log = os.path.join(_build.BUILD_DIR, "nvcc.log")
    if os.path.exists(log):
        with open(log) as f:
            for line in f:
                if "registers" in line or "smem" in line:
                    print("ptxas:", line.strip())

    cfg = get_config("v0")
    row = kernel_phase(cfg.frontend)
    row["launches"] = slice_phase(cfg)
    print(json.dumps({"kernels": [row]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
