#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mellow_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card
    python3 chip_smoke.py --ab TAG [--tree DIR] [--out OUT]   # #1, #4-#9 readings of DIR's package
    python3 chip_smoke.py --ab compare [--out OUT]            # outputs and targets, parent vs change

Phases, in order; any failure raises, so the exit code is non-zero and no
result line is printed:

1. the card's name and power limit (``nvidia-smi``); no CUDA device fails;
2. build the CUDA kernels from ``mellow_tpu_torch/csrc`` (one nvcc per
   source, in parallel, into ``build/``);
3. kernel phase: each kernel against its plain PyTorch version on the card,
   at the main path's full v0 shapes (B=1 and B=4; every Swin stage that
   takes the kernel; decode attention at the prefix length and 31 positions
   past it; the int8 decode attention there with 1 extra row and with a
   whole flush window of them), for the prefill attention (#10) the GPT-2
   prefill's (S=389, H=KV=12, hd=64), for the Swin block also HTSAT-large's
   stage 1 (hd=64) and for the window attention (#9) HTSAT-large's stage 2
   (C=512, H=8, W-MSA and SW-MSA), with the tolerance printed, device-time
   medians of the kernel and of the plain version (each call queued behind
   a spin kernel, so the host's launch overhead is not counted), the least
   time the card could take (``bound_ms``) and, where one PyTorch call
   computes the same function, that call's time (``library_ms``); the
   decode attention (#2), the prefill attention (#10) and the window
   attention (#9) are timed against their library call in turns over 5
   rounds, with the median and range, in device time and also with the
   host's launch overhead (how this script timed every kernel before it
   timed device time); #2 and #3 also run with continuous batching's
   ragged per-row starts at 4 and 8 rows (#2 beside SDPA with the start
   mask), where starts of 0 must give the output without ``start`` bit for
   bit; the int8 decode attention (#3) is also timed at a
   cluster of 1 block, and its outputs at clusters of 1, 8, 16 and the
   default size are held within one bf16 ulp of each other; the attention
   blocks (#4, #4 ``kv_quant``, #5), the MLP blocks (#6, #7) and the Swin
   block (#8, at every stage) print each launch's device time and count
   (torch.profiler over 40 calls), and #1, #4, #6, #7 and #8 are also held
   against and timed in turns beside the same function composed of library
   calls (``composed_log_mel``, ``composed_attn_block``,
   ``composed_mlp_block``, ``composed_mlp_block_w8a8``,
   ``composed_swin_block``), yardsticks that are not the table's library
   call;
4. fp32 path: ``MellowWrapper(config="v0", device="cuda")`` at full v0 width
   with random weights from a seed answers requests one at a time, as a
   batch, and through the port's ``BatchingEngine``; every ``generate``
   call's kernel launches are checked (log-mel only); a batch of 2 answers
   as the single requests do;
5. bf16 path: the same requests at ``compute_dtype="bfloat16"``, every
   call's launches of each kernel checked against what the path must make;
   each request's first greedy token equals fp32's; at a batch of 2 the
   bf16 prefix, prefill logits and one decode step's logits are held
   against the fp32 CUDA path (and fp32 CUDA against the CPU); the greedy
   token agreement with fp32 is printed;
6. int8 path: the same requests at ``weight_dtype="int8-w8a8"`` with
   ``kv_cache_dtype="int8"`` (the W8A8 prefill blocks and the int8 decode
   attention, at the default flush window of 8 steps), every call's
   launches checked; then one request at
   ``weight_dtype="int8"`` with an int8 cache (the bf16 blocks in their
   ``kv_quant`` mode), its launches checked; at a batch of 2 the int8
   path's prefix must equal bf16's and its prefill logits and one decode
   step's logits are held against the bf16 CUDA path; the greedy token
   agreement with bf16 is printed;
7. GPT-2 paths: the GPT-2-small decoder (12 layers, 768 wide, 12 heads,
   vocab 50257) behind the full HTSAT (``d_proj=768``), the configuration
   ``gpt2_config`` registers in code, in fp32, in bf16 (the prefill
   attention kernel in every layer) and with int8 weights under bf16
   (``weight_dtype="int8"``, one request); every call's launches checked;
   at a batch of 2 the fp32 CUDA prefix and logits are held against the
   CPU, bf16 against fp32 CUDA and the int8 weights against bf16 (the same
   prefix, bit for bit); the token agreement is printed; one bf16 request
   with an fp32 KV cache (``hold_gpt2_float_cache``) has the bf16 cache's
   first token and the bf16 path's launches;
8. HTSAT-large paths: ``v0_htsat_large`` (``htsat_large_config``, v0's
   decoder behind HTSAT-large, registered in code) in fp32 and bf16, three
   requests and a batch of 2 each, every call's launches checked (bf16:
   the Swin block kernel in stage 1, the window-attention kernel in stage
   2); each bf16 request's first greedy token equals fp32's; at a batch of
   2 fp32 CUDA is held against the CPU and bf16 against fp32 CUDA; then one
   bf16 call each of ``htsat_embedding_long`` (15 s), the infer mode (3 s)
   and the full ``htsat_embedding`` (10 s), launches checked and the
   embedding held against the fp32 call;
9. decoding (``decoding_phase``): ``sample=True`` on the bf16 and int8
   paths at a batch of 2, with ``top_k=1`` (every draw at its row's largest
   logit; the answers greedy's but where a tie at the largest logit
   explains the first difference) and at top_p 0.8 (every draw in its
   step's kept set; one seed repeats its answers); greedy with
   ``repetition_penalty=1.3`` in fp32, whose logits and seen masks at three
   steps give the same kept set on the card as on the CPU; the sampler in
   each mode and one whole flush window of sampled, penalised decoding
   under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync);
   ``generate_stream`` on the bf16 and int8 paths (its last yield
   ``generate``'s); ``generate_tokens_dynamic`` at B=4, ``min_batch=1``,
   on the fp32, bf16, int8 and GPT-2 bf16 paths with a stop token that
   compacts the batch after the first window (the rows before it equal to
   the static path's, the agreement after it and the compactions printed);
   every call's launches checked; each decode-step product at M = 4 against
   M = 2 (``products_by_batch``); the sampler's device time a step at B=1
   and B=4, and a sampled B=1 request's latency against a greedy one (one
   request a round);
10. continuous batching (``continuous_phase``): ``ContinuousScheduler`` on
   v0 at full width in fp32, bf16 and bf16 with an int8 cache, ten
   requests of 4-48 tokens through 4 slots and a 64-step window on
   prefixes encoded from the smoke's wavs (two rolls and a reset), every
   request finished with its budget and each kernel's launches checked (#4
   and #6, or #4 ``kv_quant`` and #6, once a layer per admission; #2 or #3
   with ``start`` once a layer per decode step); each row against its solo
   ``generate`` (fp32 equal, or first different at a near-tie of the solo
   logits; bf16 and int8 agreement printed); the device time of a window's
   decode step, of each admission and of each roll; then
   ``ContinuousBatchingEngine`` on the bf16 path with per-request knobs
   (greedy and sampled requests, one missing wav that fails alone), and
   the v0 weights through ``export_mellow`` into a .pt and back through
   ``MellowWrapper(params_path=...)``, bit for bit and with the same greedy
   answer;
11. training (``training_phase``): v0 at full width in fp32 from the seed-0
   weights, the port's ``ReasonAQALoader`` over a 4-row manifest of the
   smoke's wavs (B=4, 16 answer tokens a row), six ``train_step``s on one
   batch (finite, falling losses), a mixup step, ``train_step_accum(2)``
   and remat against the plain step from one state (the loss within 1e-5
   relative, each parameter within 1e-2 x the learning rate), the
   checkpoint round trip bit for bit and ``loop.train`` resuming from it;
   every forward pass launches the log-mel kernel twice and no other
   kernel, while a bf16 request of the same phase launches the Swin-block
   kernel; one bf16 ``forward_train`` and backward (finite, its loss's
   distance from fp32's printed); a step's device time (torch.profiler),
   host time, answer tokens/s and peak memory;
12. entry points (``entry_phase``): ``cli.build_wrapper("v0")`` with no
   weights reachable (the seed-0 random weights on the card); a bf16 v0
   ``MellowServer`` on loopback: three concurrent ``/generate`` POSTs
   coalesced into one batch, answers equal to ``wrapper.generate``'s and
   ``/metrics`` showing one generate call of six clips, one SSE stream
   whose text equals the one-shot answer; ``run_eval`` on a 4-row
   manifest, its report printed;
13. the mesh path (``parallel_phase``) in a one-rank NCCL group (one card
   holds no more): ``make_mesh()`` as (1, 1); the bf16 v0 wrapper on that
   mesh (``mellow.generate_tokens_sharded``, every kernel of the bf16
   path) answering the bf16 path's requests as the plain bf16 wrapper
   did, each call launching what ``expected_launches`` says, its launches
   recorded as the path ``mesh_dp``; one full-width v0 decoder layer in
   ``parallel/tensor.py``'s TP forms at tp=1, forward and backward bit for
   bit the plain layer's; ``loop.train(mesh=)`` two fp32 steps (B=4)
   against the unsharded loop's (losses within 1e-6 relative), rank 0's
   checkpoint the unsharded one's size;
14. the utilities (``utils_phase``): ``entry.entry()``'s ``fn`` at full v0
   width in bf16 (finite logits within the bf16 logits limit of the same
   forward in fp32, launching #1 twice and #8 20 times and nothing else,
   recorded as the path ``entry_forward``; its device time); one bf16 B=1
   request at ``max_len=8`` inside ``profiling.trace(dir)`` (one Chrome
   trace whose kernel events hold each bf16 kernel's launches less at most
   one; none from a request outside it); ``debug.enable_debug()`` on the
   bf16 wrapper with a stage-1 qkv weight at 1e38 (the request raises from
   ``swin_block_cuda``; with the tripwire off it returns with the bf16
   path's launches); a wheel of this tree, unpacked and run in a fresh
   interpreter outside the repository (the ten kernels built into a
   temporary ``XDG_CACHE_HOME``, #1 against its plain version, the native
   audio library built there), started at the slice phase's start so that
   its build overlaps the paths, and waited for here;
15. timings of the paths by stage (host preprocessing, log-mel, encoder,
   prefill, decode step as the slope of two lengths, with each llama
   mode's streaming bound ``roofline.decode_step_bytes`` over the HBM rate
   printed beside it, whole request), and
   torch.profiler over one warm B=1 request of each path (device time,
   kernel launches, the device's idle share, and the device time and
   launches of the log-mel, the decode attention, the prefill attention
   core, #4/#5's projections and quantizers, and #6's, #7's and #8's
   launches in the request).

``--ab TAG [--tree DIR]`` runs none of that: it reads #1, #4, #4
``kv_quant``, #5, #6, #7, #8 and #9 of DIR's package (an earlier commit unpacked under
``build/``, or this checkout) for an A/B in one call (``ab_run``);
``--ab compare`` prints the outputs' distance and each target of
``AB_TARGETS`` and ``AB_PROFILE_TARGETS`` as met or not (``ab_compare``).

The launch counts are set to 0 just before each path is driven and read
just after; each phase prints its seconds. The last line is ``{"ok": true, "device": {...}}``; the line
before it is the card's name and power limit; before that, the
``{"kernels": [...]}`` line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import wave

# ``--tree DIR`` (the A/B mode below): import DIR's package, e.g. an
# unpacked earlier commit, instead of this checkout's.
if __name__ == "__main__" and "--tree" in sys.argv:
    sys.path.insert(0, os.path.abspath(sys.argv[sys.argv.index("--tree") + 1]))

import numpy as np
import torch
import torch.nn.functional as F

from mellow_tpu_torch import MellowWrapper
from mellow_tpu_torch.config import HTSATConfig, get_config, register_config
from mellow_tpu_torch.io.tokenizer import ByteTokenizer
from mellow_tpu_torch.models import generate as gen
from mellow_tpu_torch.models import gpt2, htsat, llama
from mellow_tpu_torch.models.htsat import relative_position_index, shifted_window_mask
from mellow_tpu_torch.models import mellow as mellow_model
from mellow_tpu_torch.models.mellow import encode_and_prefix, init_params
from mellow_tpu_torch.models.params import params_from_jax
from mellow_tpu_torch.ops import _build, melspec
from mellow_tpu_torch.ops import attn_block as ab
from mellow_tpu_torch.ops import attn_block_w8a8 as aw
from mellow_tpu_torch.ops import decode_attention as da
from mellow_tpu_torch.ops import decode_attention_int8 as di
from mellow_tpu_torch.ops import flash_gqa_prefill as fp
from mellow_tpu_torch.ops import frontend as fe
from mellow_tpu_torch.ops import mlp_block as mb
from mellow_tpu_torch.ops import mlp_block_w8a8 as mw
from mellow_tpu_torch.ops import swin_block as sb
from mellow_tpu_torch.ops import window_attention as wa
from mellow_tpu_torch.ops.int8 import rms_norm_f32, rowquant
from mellow_tpu_torch.serving import BatchingEngine
from mellow_tpu_torch.utils import debug, profiling, roofline
from mellow_tpu_torch.utils.metrics import GLOBAL as metrics
from mellow_tpu_torch.utils.roofline import PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_HBM_BYTES, PEAK_INT8_OPS

SEED = 0
MAX_LEN = 32
# What the log-mel TPU kernel is held to (tests/test_pallas_melspec.py):
# fp32 DFT sums of 1024 terms in another order.
KERNEL_TOL = {"atol": 5e-4, "rtol": 1e-4}
# bf16 kernels against their plain versions on the same inputs: both round
# at the same points, the sums run in another order, so an output may land
# on the neighbouring bf16 value (2^-8 relative) and rounded intermediates
# carry that on: 2e-2 x max|plain|.
BF16_KERNEL_TOL = 2e-2
# fp32 CUDA against the CPU through the whole encoder and 30 decoder
# layers: the same math with sums in another order.
SLICE_TOL = {"atol": 2e-3, "rtol": 1e-3}
# bf16 perf mode against fp32 parity mode on the card, relative to the fp32
# output's largest magnitude: 12 encoder blocks and 30 (llama) or 12 (GPT-2)
# decoder layers of bf16 rounding (2^-8 relative per rounding).
# Limits 2-3x above what the card read for both families (PERF.md):
# prefix, prefill logits, one decode step's logits.
BF16_TOL = (2.5e-2, 3.5e-2, 3.5e-2)
# GPT-2's int8 weights (bf16 cache) against its bf16 path on the card, as
# INT8_TOL: prefill and one decode step's logits. Limits 2.4-2.6x above what
# the card read (PERF.md).
GPT2_INT8_TOL = (7.5e-2, 7.5e-2)
# The int8 path (W8A8 weights, int8 cache) against the bf16 path on the
# card, relative to bf16's largest magnitude: prefill logits and one decode
# step's logits (30 layers of per-row int8 activations, int8 weights and an
# int8 cache). Limits 2.5x above what the card read (PERF.md).
INT8_TOL = (7.5e-2, 6e-2)
# int8 kernels' int8 k/v rows against their plain versions: one level; the
# scales within one bf16 ulp of the row's max (2^-7 relative).
INT8_LEVELS = 1
SCALE_RTOL = 2.0 ** -7
# name -> (module, its launch counter, its kernels-per-call constant, source,
# the TPU kernel it replaces)
KERNELS = {
    "log_mel": (melspec, "LAUNCHES", "KERNELS_PER_CALL", "mellow_tpu_torch/csrc/melspec.cu",
                "mellow_tpu/ops/pallas_melspec.py:84"),
    "decode_attention": (da, "LAUNCHES", "KERNELS_PER_CALL", "mellow_tpu_torch/csrc/decode_attention.cu",
                         "mellow_tpu/ops/pallas_decode_attention.py:238"),
    "attn_block": (ab, "LAUNCHES", "KERNELS_PER_CALL", "mellow_tpu_torch/csrc/attn_block.cu",
                   "mellow_tpu/ops/pallas_attn_block.py:239"),
    "mlp_block": (mb, "LAUNCHES", "KERNELS_PER_CALL", "mellow_tpu_torch/csrc/mlp_block.cu",
                  "mellow_tpu/ops/pallas_mlp_block.py:92"),
    "swin_block": (sb, "LAUNCHES", "KERNELS_PER_CALL", "mellow_tpu_torch/csrc/swin_block.cu",
                   "mellow_tpu/ops/pallas_swin_block.py:179"),
    # The same function as flash_gqa_decode's int8 branch (:164-223).
    "decode_attention_int8": (di, "LAUNCHES", "KERNELS_PER_CALL",
                              "mellow_tpu_torch/csrc/decode_attention_int8.cu",
                              "mellow_tpu/ops/pallas_decode_attention.py:511"),
    # fused_attn_block's kv_quant mode (_emit_quantized_kv, :139).
    "attn_block_kv_quant": (ab, "LAUNCHES_KV_QUANT", "KERNELS_PER_CALL_KV_QUANT",
                            "mellow_tpu_torch/csrc/attn_block.cu", "mellow_tpu/ops/pallas_attn_block.py:239"),
    "attn_block_w8a8": (aw, "LAUNCHES", "KERNELS_PER_CALL", "mellow_tpu_torch/csrc/attn_block_w8a8.cu",
                        "mellow_tpu/ops/pallas_attn_block.py:435"),
    "mlp_block_w8a8": (mw, "LAUNCHES", "KERNELS_PER_CALL", "mellow_tpu_torch/csrc/mlp_block_w8a8.cu",
                       "mellow_tpu/ops/pallas_mlp_block.py:141"),
    "flash_gqa_prefill": (fp, "LAUNCHES", "KERNELS_PER_CALL", "mellow_tpu_torch/csrc/flash_gqa_prefill.cu",
                          "mellow_tpu/ops/pallas_attention.py:138"),
    "window_attention": (wa, "LAUNCHES", "KERNELS_PER_CALL", "mellow_tpu_torch/csrc/window_attention.cu",
                         "mellow_tpu/ops/pallas_window_attention.py:76"),
}
GPT2_CONFIG = "gpt2_small"
LARGE_CONFIG = "v0_htsat_large"
# The generate paths the smoke drives: config, wrapper options, generate
# options.
PATHS = {
    "fp32": ("v0", {}, {}),
    "bf16": ("v0", {"compute_dtype": "bfloat16"}, {}),
    "int8": ("v0", {"compute_dtype": "bfloat16", "weight_dtype": "int8-w8a8"}, {"kv_cache_dtype": "int8"}),
    "int8_weights": ("v0", {"compute_dtype": "bfloat16", "weight_dtype": "int8"}, {"kv_cache_dtype": "int8"}),
    "gpt2_fp32": (GPT2_CONFIG, {}, {}),
    "gpt2_bf16": (GPT2_CONFIG, {"compute_dtype": "bfloat16"}, {}),
    "gpt2_int8_weights": (GPT2_CONFIG, {"compute_dtype": "bfloat16", "weight_dtype": "int8"}, {}),
    "large_fp32": (LARGE_CONFIG, {}, {}),
    "large_bf16": (LARGE_CONFIG, {"compute_dtype": "bfloat16"}, {}),
}


def gpt2_config():
    """The reference's GPT-2 option at full width: GPT-2 small behind the v0
    encoder, projected to 768, with GPT-2's end-of-text id as separator and
    stop token. The values ``config_yaml.load_yaml_config`` gives for a
    YAML with ``text_decoder: gpt2`` and ``d_proj: 768``; built in code,
    since the card's host may lack PyYAML."""
    return get_config("v0").replace(
        name=GPT2_CONFIG, decoder=gpt2.GPT2Config(), d_proj=768, decoder_family="gpt2",
        text_decoder="gpt2", sep_token_id=50256, stop_token_id=50256,
    ).validate()


def htsat_large_config():
    """v0 (the SmolLM2-135M-shape decoder, d_proj 576, the 389-token prefix)
    behind HTSAT-large, the largest HTSAT of LAION-CLAP's
    ``create_htsat_model`` (src/laion_clap/clap_module/htsat.py): embed 256,
    depths 2-2-12-2, heads 4-8-16-32, window 8, 2048 features. In bf16 its
    stage 1 takes the Swin block kernel (hd = 64) and its stage 2 the
    window-attention kernel, by the JAX package's gates. Built in code: the
    JAX registry has no such entry."""
    return get_config("v0").replace(
        name=LARGE_CONFIG,
        encoder=HTSATConfig(embed_dim=256, depths=(2, 2, 12, 2), num_heads=(4, 8, 16, 32), window_size=8,
                            out_emb=2048),
    ).validate()


_CYCLES_PER_MS = []


def _spin_cycles_per_ms() -> float:
    """The card's clock as ``torch.cuda._sleep`` counts it, measured once."""
    if not _CYCLES_PER_MS:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        _CYCLES_PER_MS.append(20_000_000 / start.elapsed_time(end))
    return _CYCLES_PER_MS[0]


def _median_ms(fn, reps: int = 20, warmup: int = 3, host: bool = False) -> float:
    """Median time of one call of ``fn`` over ``reps`` calls, by CUDA events
    around the call on an idle card. By default it is device time: each
    timed call is queued behind a spin kernel (``torch.cuda._sleep``) three
    times as long as the host took to issue the call, so the events bracket
    the device's work only. ``host=True`` leaves the spin out, as this
    script once timed every kernel: the events then also bracket the host's launch overhead (a
    wrapper's Python checks and ctypes call, PyTorch's dispatch), which an
    eager decode loop pays on every call."""
    issue = []
    for _ in range(warmup):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        issue.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    spin = 0 if host else int(_spin_cycles_per_ms() * max(0.2, 3e3 * max(issue)))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _alternate(plain, kernel) -> tuple:
    """Kernel and plain medians on the same card in the order plain, kernel,
    kernel, plain; returns the means of the two rounds (kernel, plain)."""
    p = [_median_ms(plain)]
    k = [_median_ms(kernel) for _ in range(2)]
    p.append(_median_ms(plain))
    return statistics.mean(k), statistics.mean(p)


def _paired(kernel, library, rounds: int = 5) -> dict:
    """The kernel against one library call computing the same function, in
    turns: ``rounds`` rounds, the kernel first in even rounds and the
    library call first in odd ones, each call timed in a round by both of
    ``_median_ms``'s measures (medians of 20 launches): device time
    (``ms``, ``library_ms``) and events around the call with the host's
    launch overhead (``host_ms``, ``library_host_ms``). Returns the medians
    over the rounds, their ranges and every round."""
    t = {key: [] for key in ("ms", "library_ms", "host_ms", "library_host_ms")}
    for i in range(rounds):
        pairs = (("", kernel), ("library_", library))
        for prefix, fn in (pairs if i % 2 == 0 else pairs[::-1]):
            t[prefix + "ms"].append(_median_ms(fn))
            t[prefix + "host_ms"].append(_median_ms(fn, host=True))
    out = {key: statistics.median(v) for key, v in t.items()}
    out.update({f"{key}_range": [min(v), max(v)] for key, v in t.items()})
    out.update({f"{key}_rounds": v for key, v in t.items()})
    return out


def _bound(n_bytes: float, flops: float, peak: float) -> tuple:
    """The least time for the work, max(bytes / HBM rate, ops / peak), in
    ms, and which of the two it is."""
    t_bytes, t_ops = n_bytes / PEAK_HBM_BYTES, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _host_ms(fn, reps: int = 3) -> float:
    """Median host-clock time of work that ends in a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def stage_split(fn, calls: int = 40, tries: int = 8) -> dict:
    """The device time and launches of each CUDA kernel one call of ``fn``
    runs, from torch.profiler over ``calls`` warm calls: {kernel symbol:
    [launches a call, ms a call]}. The tracer drops kernels launched just
    after it starts, so each window begins with a warm-up step of
    ``calls`` calls whose events are discarded; a window whose counts are
    still not whole launches a call is taken again, up to ``tries`` times;
    then it raises."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        split = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                n, ms = split.get(e.name, (0, 0.0))
                split[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
        if split and all(n % calls == 0 for n, _ in split.values()):
            break
    else:
        raise RuntimeError(f"stage_split: in {tries} windows of {calls} calls the tracer saw "
                           + ("no kernel" if not split else f"counts that are not whole launches a call: "
                              f"{ {name: n for name, (n, _) in split.items()} }"))
    return {name: [n // calls, ms / calls] for name, (n, ms) in sorted(split.items(), key=lambda kv: -kv[1][1])}


def split_or_none(fn):
    """``stage_split``, or None where the tracer never saw whole launches a
    call (a reading this run could not take, printed as such)."""
    try:
        return stage_split(fn)
    except RuntimeError as e:
        print(f"per-launch split not measured: {e}")
        return None


def _print_split(label, split) -> None:
    if split is None:
        return
    total = sum(ms for _, ms in split.values())
    print(f"{label}: {total:.4f} ms of kernels a call (torch.profiler over 40 calls)")
    for name, (n, ms) in split.items():
        print(f"  {label} {ms:.4f} ms {n:g} launches  {name[:100]}")


def _rms_norm(x, ln, eps: float):
    D = x.shape[-1]
    if hasattr(F, "rms_norm"):
        return F.rms_norm(x, (D,), ln, eps)
    return (x.float() * torch.rsqrt(x.float().pow(2).mean(-1, keepdim=True) + eps) * ln.float()).to(x.dtype)


def composed_attn_block(x, ln, wqkv, wo, cos, sin, H: int, KV: int, hd: int, eps: float):
    """#4's function composed of library calls: RMSNorm, one matmul on the
    concatenated [wq | wk | wv], RoPE, SDPA ``is_causal`` with
    ``enable_gqa``, a matmul and the residual. A yardstick timed beside
    the hand-written chain; the port never calls it."""
    B, S, D = x.shape
    q, k, v = torch.matmul(_rms_norm(x, ln, eps), wqkv).split((H * hd, KV * hd, KV * hd), dim=-1)
    c, s_ = cos[None, None], sin[None, None]

    def rope(t):
        t1, t2 = t.chunk(2, dim=-1)
        return t * c + torch.cat((-t2, t1), dim=-1) * s_

    q, k, v = (t.unflatten(-1, (-1, hd)).transpose(1, 2) for t in (q, k, v))
    o = F.scaled_dot_product_attention(rope(q), rope(k), v, is_causal=True, enable_gqa=True)
    return x + torch.matmul(o.transpose(1, 2).reshape(B, S, H * hd), wo)


def composed_mlp_block(x, ln, wgu, w_down, eps: float):
    """#6's function composed of library calls: RMSNorm, one matmul on the
    concatenated [w_gate | w_up], silu times up, a matmul and the residual.
    A yardstick timed beside the hand-written chain; the port never calls
    it."""
    g, u = torch.matmul(_rms_norm(x, ln, eps), wgu).chunk(2, dim=-1)
    return x + torch.matmul(F.silu(g) * u, w_down)


def composed_mlp_block_w8a8(x, ln, wg, sg, wu, su, wd, sd, eps: float):
    """#7's function composed of library calls: the plain quantizers
    (``ops/int8.py``) around three ``torch._int_mm`` products (exact int32
    sums), the scales, silu and the residual. A yardstick timed beside the
    hand-written kernels; the port never calls it."""
    h8, hs = rowquant(rms_norm_f32(x, ln, eps))
    h8, hs = h8.reshape(-1, x.shape[-1]), hs.reshape(-1, 1)
    gate = F.silu(torch._int_mm(h8, wg).float() * hs * sg.float())
    up = torch._int_mm(h8, wu).float() * hs * su.float()
    p8, ps = rowquant(gate * up)
    y = (torch._int_mm(p8, wd).float() * ps * sd.float()).reshape(x.shape)
    return (x.float() + y.to(x.dtype).float()).to(x.dtype)


def composed_log_mel(wave, cfg, window, fb):
    """#1's function composed of library calls: ``torch.stft`` (centred,
    reflect padding, the periodic Hann window, onesided), the power, the
    mel projection, the clamp and the log. A yardstick timed beside the
    hand-written kernel; the port never calls it."""
    spec = torch.stft(wave, cfg.n_fft, cfg.hop_length, window=window, center=True, pad_mode="reflect",
                      onesided=True, return_complex=True)
    power = spec.real.square() + spec.imag.square()
    return 10.0 * torch.log10(torch.clamp(power.transpose(1, 2) @ fb, min=cfg.amin)) - fe.ref_db(cfg)


def composed_swin_block(x, p, bias, mask, H: int, eps: float = 1e-5):
    """#8's function composed of library calls: LayerNorm, the qkv linear,
    SDPA over the 8 x 8 windows with the bias (and the shift mask) as its
    additive mask, the proj linear and the residual, LayerNorm, fc1,
    tanh-GELU, fc2 and the residual. A yardstick timed beside the
    hand-written chain; the port never calls it."""
    B, R, _, C = x.shape
    nWw, hd = R // 8, C // H

    def lin(t, name):
        return torch.addmm(p[name]["bias"], t.reshape(-1, t.shape[-1]), p[name]["kernel"])

    def ln(t, name):
        return F.layer_norm(t, (C,), p[name]["scale"], p[name]["bias"], eps)

    qkv = lin(ln(x, "norm1"), "qkv").reshape(B, nWw, 8, nWw, 8, 3, H, hd)
    q, k, v = qkv.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, B * nWw * nWw, H, 64, hd)
    add = bias[None] if mask is None else bias[None] + mask.repeat(B, 1, 1)[:, None]
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=add.to(x.dtype))
    o = o.reshape(B, nWw, nWw, H, 8, 8, hd).permute(0, 1, 4, 2, 5, 3, 6).reshape(B * R * R, C)
    x1 = x.reshape(-1, C) + lin(o, "proj")
    hid = F.gelu(lin(ln(x1, "norm2"), "fc1"), approximate="tanh")
    return (x1 + lin(hid, "fc2")).reshape(B, R, R, C)


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


class DistinctTokenizer(ByteTokenizer):
    """ByteTokenizer for prompts, but every generated id decodes to a
    character of its own, so two answers compare token by token."""

    BASE = 0x4E00

    def decode(self, ids):
        return "".join(chr(self.BASE + int(i)) for i in ids)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).cuda().bfloat16()


def _check_bf16(name, out, ref) -> float:
    if out.shape != ref.shape or not torch.isfinite(out.float()).all():
        raise RuntimeError(f"{name}: bad kernel output {tuple(out.shape)}")
    err = (out.float() - ref.float()).abs().max().item()
    lim = BF16_KERNEL_TOL * ref.float().abs().max().item()
    if err > lim:
        raise RuntimeError(f"{name}: max_abs_err {err:.3e} > {lim:.3e}")
    return err


def _case(name, shape, err, tol, ms, plain_ms, bound, library_ms=None, paired=None) -> dict:
    """One shape's readings. With ``paired`` (``_paired``'s result), the
    kernel's time and the library's are the paired medians, printed with
    their ranges."""
    bound_ms, bound_by = bound
    extra = {}
    if paired is not None:
        ms, library_ms = paired["ms"], paired["library_ms"]
        extra = {k: v for k, v in paired.items() if k not in ("ms", "library_ms")}
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"{name} {shape}: max_abs_err {err:.3e} ({tol}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), library {lib} (device-time medians of 20)")
    if paired is not None:
        rounds = len(paired["ms_rounds"])
        for label, key in (("device time", "ms"), ("with the host's launch overhead", "host_ms")):
            k, lk = paired[key], paired["library_" + key]
            kr, lr = paired[key + "_range"], paired["library_" + key + "_range"]
            print(f"{name} {shape}: kernel vs library, {label}, paired over {rounds} rounds: "
                  f"{k:.4f} ms ({kr[0]:.4f}-{kr[1]:.4f}) vs {lk:.4f} ms ({lr[0]:.4f}-{lr[1]:.4f}), "
                  f"ratio {k / lk:.3f}")
    return {"shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms, **extra}


def _composed(name, shape, out, composed, chain, check=None) -> dict:
    """Not the table's library call (no one PyTorch call computes the
    block): the same function composed of library calls, held against the
    kernel's output within the kernel tolerance (``check``; the bf16 one by
    default) and timed beside the hand-written chain in turns."""
    (check or _check_bf16)(f"{name} vs the composed library chain", out, composed())
    chain_ms, composed_ms = _alternate(composed, chain)
    print(f"{name} {shape}: hand-written chain {chain_ms:.4f} ms, composed library chain "
          f"{composed_ms:.4f} ms, ratio {chain_ms / composed_ms:.3f} (device time)")
    return {"composed_library_ms": composed_ms, "chain_ms_beside_it": chain_ms}


def _row(name, cases) -> dict:
    """The kernel's line: the numbers of its first case (the shape of a B=1
    request), the largest error over all cases, and every case."""
    *_, source, replaces = KERNELS[name]
    first = cases[0]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"], "cases": cases}


def bench_log_mel(cfg) -> dict:
    rng = np.random.default_rng(SEED)
    cases = []
    for batch in (1, 4):
        wave_ = torch.from_numpy(
            (rng.standard_normal((batch, cfg.num_samples)) * 0.1).astype(np.float32)).cuda()
        out = melspec.log_mel_cuda(wave_, cfg)
        torch.cuda.synchronize()
        ref = fe.log_mel_spectrogram(wave_, cfg)
        if out.shape != (batch, cfg.num_frames, cfg.n_mels) or not torch.isfinite(out).all():
            raise RuntimeError(f"log_mel kernel output bad at B={batch}: {tuple(out.shape)}")
        torch.testing.assert_close(out, ref, **KERNEL_TOL)
        ms, plain_ms = _alternate(lambda: fe.log_mel_spectrogram(wave_, cfg),
                                  lambda: melspec.log_mel_cuda(wave_, cfg))
        # What a log-mel needs, not what this kernel does: per frame the
        # window, a real FFT (~2.5 n log2 n), the power, the mel projection
        # and the log; the wave in and the mel out. No DFT table counts.
        n_bins = cfg.n_fft // 2 + 1
        flops = batch * cfg.num_frames * (cfg.n_fft + 2.5 * cfg.n_fft * np.log2(cfg.n_fft) + 3 * n_bins
                                          + 2 * n_bins * cfg.n_mels + cfg.n_mels)
        bound = _bound(_nbytes(wave_, out), flops, PEAK_FP32_FLOPS)
        window = torch.from_numpy(fe.hann_window(cfg.n_fft).astype(np.float32)).cuda()
        fb = fe.device_tables(cfg, wave_.device)[1]
        extra = _composed("log_mel", f"B={batch}", out, lambda: composed_log_mel(wave_, cfg, window, fb),
                          lambda: melspec.log_mel_cuda(wave_, cfg),
                          check=lambda label, got, want: torch.testing.assert_close(got, want, **KERNEL_TOL))
        cases.append({**_case("log_mel", f"B={batch}", (out - ref).abs().max().item(),
                              f"atol {KERNEL_TOL['atol']}, rtol {KERNEL_TOL['rtol']}", ms, plain_ms, bound), **extra})
    return _row("log_mel", cases)


def bench_decode_attention(dec, prefix_len: int) -> dict:
    rng = np.random.default_rng(SEED + 1)
    H, KV, hd = dec.num_heads, dec.num_kv_heads, dec.head_dim
    s_max = prefix_len + MAX_LEN
    cases = []
    for batch, n in ((1, prefix_len), (1, prefix_len + 31), (4, prefix_len), (4, prefix_len + 31)):
        q = _bf16(rng, batch, H, hd)
        k = _bf16(rng, batch, s_max, KV, hd)
        v = _bf16(rng, batch, s_max, KV, hd)
        out = da.decode_attention_cuda(q, k, v, n)
        torch.cuda.synchronize()
        err = _check_bf16("decode_attention", out, da.decode_attention_plain(q, k, v, n))
        ms, plain_ms = _alternate(lambda: da.decode_attention_plain(q, k, v, n),
                                  lambda: da.decode_attention_cuda(q, k, v, n))
        # The one PyTorch call for the same function, on the same cache views,
        # timed against the kernel in turns.
        qs, ks, vs = q[:, :, None], k[:, :n].transpose(1, 2), v[:, :n].transpose(1, 2)
        _check_bf16("decode_attention vs SDPA", out,
                    F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True)[:, :, 0])
        paired = _paired(lambda: da.decode_attention_cuda(q, k, v, n),
                         lambda: F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True))
        n_bytes = _nbytes(q, out) + 2 * batch * n * KV * hd * k.element_size()
        bound = _bound(n_bytes, 4 * batch * H * n * hd, PEAK_BF16_FLOPS)
        cases.append({**_case("decode_attention", f"B={batch} n={n}", err, f"{BF16_KERNEL_TOL} x max|plain|",
                              ms, plain_ms, bound, paired=paired), "cluster_blocks": da.cluster_blocks(n)})
    # Continuous batching's ragged rows: a per-row start at 4 and 8 slots.
    n = prefix_len + 31
    for batch in (4, 8):
        q = _bf16(rng, batch, H, hd)
        k = _bf16(rng, batch, s_max, KV, hd)
        v = _bf16(rng, batch, s_max, KV, hd)
        start = ragged_starts(batch, n)
        out = da.decode_attention_cuda(q, k, v, n, start)
        torch.cuda.synchronize()
        err = _check_bf16("decode_attention with start", out, da.decode_attention_plain(q, k, v, n, start))
        same = torch.equal(da.decode_attention_cuda(q, k, v, n, torch.zeros_like(start)),
                           da.decode_attention_cuda(q, k, v, n))
        if not same:
            raise RuntimeError("decode_attention: starts of 0 moved the output of the kernel without start")
        ms, plain_ms = _alternate(lambda: da.decode_attention_plain(q, k, v, n, start),
                                  lambda: da.decode_attention_cuda(q, k, v, n, start))
        qs, ks, vs = q[:, :, None], k[:, :n].transpose(1, 2), v[:, :n].transpose(1, 2)
        mask = ~da.start_mask(start, n)
        _check_bf16("decode_attention with start vs SDPA", out,
                    F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)[:, :, 0])
        library_ms = _median_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True))
        # The positions this run's starts leave, not all n.
        live = int((n - start).sum().item())
        bound = _bound(_nbytes(q, out, start) + 2 * live * KV * hd * k.element_size(), 4 * H * live * hd,
                       PEAK_BF16_FLOPS)
        cases.append({**_case("decode_attention", f"B={batch} n={n} start", err, f"{BF16_KERNEL_TOL} x max|plain|",
                              ms, plain_ms, bound, library_ms), "starts": start.tolist(),
                      "start_zero_bit_equal": same})
    return _row("decode_attention", cases)


def ragged_starts(batch: int, n: int) -> torch.Tensor:
    """(batch,) int32 first positions as continuous batching makes them:
    0, n - 1 (the step's own position alone), one that empties the
    cluster's first two blocks and one in its last block, in turn."""
    pool = (0, n - 1, 2 * da.POSITIONS_PER_BLOCK + 5, n - 30)
    return torch.tensor([pool[b % len(pool)] for b in range(batch)], dtype=torch.int32, device="cuda")


def _decoder_layer(rng, dec) -> dict:
    D, I, H, KV, hd = dec.hidden_size, dec.intermediate_size, dec.num_heads, dec.num_kv_heads, dec.head_dim
    return {"ln_attn": 1 + _bf16(rng, D, scale=0.1), "ln_mlp": 1 + _bf16(rng, D, scale=0.1),
            "wq": _bf16(rng, D, H * hd, scale=0.05), "wk": _bf16(rng, D, KV * hd, scale=0.05),
            "wv": _bf16(rng, D, KV * hd, scale=0.05), "wo": _bf16(rng, H * hd, D, scale=0.05),
            "w_gate": _bf16(rng, D, I, scale=0.05), "w_up": _bf16(rng, D, I, scale=0.05),
            "w_down": _bf16(rng, I, D, scale=0.05)}


def bench_attn_block(dec, S: int) -> dict:
    rng = np.random.default_rng(SEED + 2)
    lp = _decoder_layer(rng, dec)
    D, H, KV, hd = dec.hidden_size, dec.num_heads, dec.num_kv_heads, dec.head_dim
    cos, sin = llama.rope_device_tables(dec, S, torch.bfloat16, "cuda")
    kw = dict(num_heads=H, num_kv_heads=KV, head_dim=hd, eps=dec.rms_norm_eps)
    w = [lp[k] for k in ("ln_attn", "wq", "wk", "wv", "wo")]
    cases = []
    for batch in (1, 4):
        x = _bf16(rng, batch, S, D, scale=0.5)
        got = ab.attn_block_cuda(x, *w, cos, sin, **kw)
        torch.cuda.synchronize()
        ref = ab.attn_block_plain(x, *w, cos, sin, **kw)
        err = max(_check_bf16(f"attn_block output {i}", g, r) for i, (g, r) in enumerate(zip(got, ref)))
        ms, plain_ms = _alternate(lambda: ab.attn_block_plain(x, *w, cos, sin, **kw),
                                  lambda: ab.attn_block_cuda(x, *w, cos, sin, **kw))
        M = batch * S
        # Projections, o-proj, and the causal triangle of QK^T and PV.
        flops = (2 * M * D * (H + 2 * KV) * hd + 2 * M * H * hd * D
                 + 2 * 2 * batch * H * hd * (S * (S + 1) // 2))
        bound = _bound(_nbytes(x, *w, cos, sin, *got), flops, PEAK_BF16_FLOPS)
        split = split_or_none(lambda: ab.attn_block_cuda(x, *w, cos, sin, **kw))
        _print_split(f"attn_block B={batch} S={S} stages", split)
        wqkv = torch.cat([lp["wq"], lp["wk"], lp["wv"]], dim=1)
        comp = lambda: composed_attn_block(x, lp["ln_attn"], wqkv, lp["wo"], cos, sin, H, KV, hd,  # noqa: E731
                                           dec.rms_norm_eps)
        extra = _composed("attn_block", f"B={batch} S={S}", got[0], comp,
                          lambda: ab.attn_block_cuda(x, *w, cos, sin, **kw))
        cases.append({**_case("attn_block", f"B={batch} S={S}", err, f"{BF16_KERNEL_TOL} x max|plain|",
                              ms, plain_ms, bound), "stages": split, **extra})
    return _row("attn_block", cases)


def bench_mlp_block(dec, S: int) -> dict:
    rng = np.random.default_rng(SEED + 3)
    lp = _decoder_layer(rng, dec)
    D, I = dec.hidden_size, dec.intermediate_size
    w = [lp[k] for k in ("ln_mlp", "w_gate", "w_up", "w_down")]
    eps = dec.rms_norm_eps
    cases = []
    for batch in (1, 4):
        x = _bf16(rng, batch, S, D, scale=0.5)
        out = mb.mlp_block_cuda(x, *w, eps=eps)
        torch.cuda.synchronize()
        err = _check_bf16("mlp_block", out, mb.mlp_block_plain(x, *w, eps=eps))
        ms, plain_ms = _alternate(lambda: mb.mlp_block_plain(x, *w, eps=eps),
                                  lambda: mb.mlp_block_cuda(x, *w, eps=eps))
        bound = _bound(_nbytes(x, *w, out), 2 * batch * S * D * I * 3, PEAK_BF16_FLOPS)
        split = split_or_none(lambda: mb.mlp_block_cuda(x, *w, eps=eps))
        _print_split(f"mlp_block B={batch} S={S} stages", split)
        wgu = torch.cat([lp["w_gate"], lp["w_up"]], dim=1)
        comp = lambda: composed_mlp_block(x, lp["ln_mlp"], wgu, lp["w_down"], eps)  # noqa: E731
        extra = _composed("mlp_block", f"B={batch} S={S}", out, comp, lambda: mb.mlp_block_cuda(x, *w, eps=eps))
        cases.append({**_case("mlp_block", f"B={batch} S={S}", err, f"{BF16_KERNEL_TOL} x max|plain|",
                              ms, plain_ms, bound), "stages": split, **extra})
    return _row("mlp_block", cases)


def _swin_params(rng, C, H, ws):
    """Random bf16 block weights and the bf16 relative-position table."""

    def lin(i, o):
        return {"kernel": _bf16(rng, i, o, scale=0.05), "bias": _bf16(rng, o, scale=0.02)}

    def ln():
        return {"scale": 1 + _bf16(rng, C, scale=0.1), "bias": _bf16(rng, C, scale=0.02)}

    p = {"norm1": ln(), "qkv": lin(C, 3 * C), "proj": lin(C, C), "norm2": ln(),
         "fc1": lin(C, 4 * C), "fc2": lin(4 * C, C)}
    return p, _bf16(rng, (2 * ws - 1) ** 2, H, scale=0.5)


def _bias(table, ws, H):
    """The (H, N, N) fp32 bias gathered from a (2ws-1)^2 x H table."""
    N = ws * ws
    idx = torch.from_numpy(relative_position_index(ws).reshape(-1)).cuda()
    return table[idx].reshape(N, N, H).permute(2, 0, 1).float().contiguous()


def _stages(enc, route):
    """(stage index, resolution, width, heads) of each stage of ``enc``
    whose bf16 blocks take ``route``."""
    res, C = enc.grid_size, enc.embed_dim
    for si, H in enumerate(enc.num_heads):
        if htsat.kernel_route(C, H, enc.window_size, res) == route:
            yield si, res, C, H
        res, C = res // 2, C * 2


def bench_swin_block(encs) -> dict:
    """Every stage that takes the kernel, of each (label, encoder) in
    ``encs``: v0's stages 1-3 (hd = 24), HTSAT-large's stage 1 (hd = 64)."""
    rng = np.random.default_rng(SEED + 4)
    cases = []
    for label, enc in encs:
        ws, N = enc.window_size, enc.window_size ** 2
        for si, res, C, H in _stages(enc, "swin_block"):
            p, table = _swin_params(rng, C, H, ws)
            bias = _bias(table, ws, H)
            mask = torch.from_numpy(shifted_window_mask(res, ws, ws // 2)).cuda()
            # The weights, the bias as its bf16 table, not the expanded fp32
            # copy; the shifted-window mask follows from the grid geometry alone.
            weights = [p[a][b] for a, b in sb.WEIGHT_KEYS] + [table]
            kw = dict(num_heads=H, window_size=ws)
            for batch in (1, 4):
                x = _bf16(rng, batch, res, res, C, scale=0.5)
                out = sb.swin_block_cuda(x, p, bias, mask, **kw)
                torch.cuda.synchronize()
                err = _check_bf16("swin_block", out, sb.swin_block_plain(x, p, bias, mask, **kw))
                ms, plain_ms = _alternate(lambda: sb.swin_block_plain(x, p, bias, mask, **kw),
                                          lambda: sb.swin_block_cuda(x, p, bias, mask, **kw))
                M = batch * res * res
                # qkv, proj, fc1, fc2 (12 C^2 per token) and the window QK^T and PV.
                flops = 2 * M * C * 12 * C + 2 * 2 * M * N * C
                bound = _bound(_nbytes(x, *weights, out), flops, PEAK_BF16_FLOPS)
                shape = f"{label} stage {si + 1} B={batch} R={res} C={C} H={H} hd={C // H} SW-MSA"
                split = split_or_none(lambda: sb.swin_block_cuda(x, p, bias, mask, **kw))
                _print_split(f"swin_block {shape} stages", split)
                extra = _composed("swin_block", shape, out, lambda: composed_swin_block(x, p, bias, mask, H),
                                  lambda: sb.swin_block_cuda(x, p, bias, mask, **kw))
                cases.append({**_case("swin_block", shape, err, f"{BF16_KERNEL_TOL} x max|plain|", ms, plain_ms,
                                      bound), "stages": split, **extra})
    return _row("swin_block", cases)


def bench_window_attention(enc) -> dict:
    """HTSAT-large's stage 2 (R=32, C=512, H=8, hd=64): B=1 and B=4, W-MSA
    and SW-MSA; SDPA with the bias (and mask) as its additive mask is the
    library call."""
    rng = np.random.default_rng(SEED + 10)
    ws, N = enc.window_size, enc.window_size ** 2
    cases = []
    for si, res, C, H in _stages(enc, "window_attention"):
        table = _bf16(rng, (2 * ws - 1) ** 2, H, scale=0.5)
        bias = _bias(table, ws, H)
        nW = (res // ws) ** 2
        for batch in (1, 4):
            for shifted in (False, True):
                qkv = _bf16(rng, batch * nW, N, 3 * C, scale=0.5)
                mask = torch.from_numpy(shifted_window_mask(res, ws, ws // 2)).cuda() if shifted else None
                kw = dict(num_heads=H)
                out = wa.window_attention_cuda(qkv, bias, mask, **kw)
                torch.cuda.synchronize()
                err = _check_bf16("window_attention", out, wa.window_attention_plain(qkv, bias, mask, **kw))
                ms, plain_ms = _alternate(lambda: wa.window_attention_plain(qkv, bias, mask, **kw),
                                          lambda: wa.window_attention_cuda(qkv, bias, mask, **kw))
                # The one PyTorch call for the same function: (Bn, H, N, hd)
                # views of the qkv and the bias plus mask as an additive mask
                # in the query's dtype (its error is printed, not held: the
                # mask is rounded to bf16 there).
                q, k, v = qkv.reshape(batch * nW, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
                add = bias[None] if mask is None else bias[None] + mask.repeat(batch, 1, 1)[:, None]
                add = add.to(qkv.dtype)
                sdpa = F.scaled_dot_product_attention(q, k, v, attn_mask=add).transpose(1, 2).reshape(out.shape)
                sdpa_err = (sdpa.float() - out.float()).abs().max().item()
                print(f"window_attention vs SDPA: max_abs_err {sdpa_err:.3e} "
                      f"({sdpa_err / out.float().abs().max().item():.4f} x max|kernel|; not held)")
                paired = _paired(lambda: wa.window_attention_cuda(qkv, bias, mask, **kw),
                                 lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=add))
                # qkv read once, the output written once, the bias as its bf16
                # table; QK^T and PV over every window.
                bound = _bound(_nbytes(qkv, out, table), 4 * batch * nW * N * N * C, PEAK_BF16_FLOPS)
                cases.append(_case("window_attention", f"HTSAT-large stage {si + 1} B={batch} R={res} C={C} H={H} "
                                   f"hd={C // H} {'SW-MSA' if shifted else 'W-MSA'}", err,
                                   f"{BF16_KERNEL_TOL} x max|plain|", ms, plain_ms, bound, paired=paired))
    return _row("window_attention", cases)


def _int8_weight(rng, *shape, scale=0.05):
    """int8 (in, out) values and bf16 per-column scales, as the wrapper makes
    them (quantize the fp32 weight, cast the scale)."""
    w = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).cuda()
    q = llama.quantize_weight(w)
    return q["q"], q["scale"].bfloat16()


def _check_int8_kv(name, got, want) -> dict:
    """int8 k/v rows within INT8_LEVELS of the plain version's, the scales
    within SCALE_RTOL; returns the readings."""
    levels = max((g.int() - w.int()).abs().max().item() for g, w in zip(got[:2], want[:2]))
    rel = max(((g - w).abs() / w.abs()).max().item() for g, w in zip(got[2:], want[2:]))
    if any(g.dtype != torch.int8 or g.shape != w.shape for g, w in zip(got[:2], want[:2])):
        raise RuntimeError(f"{name}: bad int8 k/v outputs")
    if levels > INT8_LEVELS or rel > SCALE_RTOL:
        raise RuntimeError(f"{name}: int8 k/v {levels} levels, scales {rel:.3e} relative off the plain one")
    return {"kv_int8_max_level_diff": levels, "kv_scale_max_rel_err": rel}


def max_ulp(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between two bf16 tensors in units in the last
    place (bit patterns mapped to ordered integers; +0 and -0 coincide)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max().item())


def bench_decode_attention_int8(dec, prefix_len: int) -> dict:
    """v0's shapes at E = 1 and E = 8, B = 1 and B = 4; at each the kernel
    also at a cluster of 1 block (timed) and of 8 and 16 (held within one
    bf16 ulp of the others)."""
    rng = np.random.default_rng(SEED + 5)
    H, KV, hd = dec.num_heads, dec.num_kv_heads, dec.head_dim
    s_max = prefix_len + MAX_LEN
    cases = []
    W = gen.effective_window(None, MAX_LEN, 1)
    # E = 1 (a window's first step) and E = W (its last), both as slices of
    # the window's (B, W, KV, hd) buffer, as the decode step hands them over.
    for batch, n, E in ((1, prefix_len, 1), (1, prefix_len + 31, 1), (4, prefix_len, 1), (4, prefix_len + 31, 1),
                        (1, prefix_len, W), (1, prefix_len + 31, W), (4, prefix_len, W), (4, prefix_len + 31, W)):
        q = _bf16(rng, batch, H, hd)
        k8, ks = llama.quantize_kv(_bf16(rng, batch, s_max, KV * hd, scale=0.5))
        v8, vs = llama.quantize_kv(_bf16(rng, batch, s_max, KV * hd))
        k8, v8 = k8.reshape(batch, s_max, KV, hd), v8.reshape(batch, s_max, KV, hd)
        cur = (_bf16(rng, batch, W, KV, hd, scale=0.5)[:, :E], _bf16(rng, batch, W, KV, hd)[:, :E])
        args = (q, k8, v8, ks, vs, n, *cur)
        out = di.decode_attention_int8_cuda(*args)
        torch.cuda.synchronize()
        err = _check_bf16("decode_attention_int8", out, di.decode_attention_int8_plain(*args))
        ms, plain_ms = _alternate(lambda: di.decode_attention_int8_plain(*args),
                                  lambda: di.decode_attention_int8_cuda(*args))
        # Cluster sizes: only the order of the fp32 sum d follows the split.
        by_blocks = {b: di.decode_attention_int8_cuda(*args, blocks=b) for b in (1, 8, 16)}
        torch.cuda.synchronize()
        ulp = max(max_ulp(x, y) for x in (out, *by_blocks.values()) for y in by_blocks.values())
        if ulp > 1:
            raise RuntimeError(f"decode_attention_int8 B={batch} n={n} E={E}: clusters of "
                               f"{di.cluster_blocks(n)}, 1, 8 and 16 blocks differ by {ulp} bf16 ulp")
        one_ms = statistics.mean(_median_ms(lambda: di.decode_attention_int8_cuda(*args, blocks=1))
                                 for _ in range(2))
        print(f"decode_attention_int8 B={batch} n={n} E={E}: {di.cluster_blocks(n)} blocks a cluster "
              f"{ms:.4f} ms, 1 block {one_ms:.4f} ms; clusters of {di.cluster_blocks(n)}, 1, 8, 16 "
              f"within {ulp} bf16 ulp")
        # q, the extra rows and the output in bf16; n positions of int8 k
        # and v and their fp32 scales. No PyTorch call takes an int8 cache.
        n_bytes = _nbytes(q, out, *cur) + 2 * batch * n * (KV * hd + 4)
        bound = _bound(n_bytes, 4 * batch * H * (n + E) * hd, PEAK_INT8_OPS)
        cases.append({**_case("decode_attention_int8", f"B={batch} n={n} E={E}", err,
                              f"{BF16_KERNEL_TOL} x max|plain|", ms, plain_ms, bound),
                      "cluster_blocks": di.cluster_blocks(n), "ms_one_block": one_ms,
                      "max_ulp_across_clusters": ulp})
    # Continuous batching's ragged rows: a per-row start at 4 and 8 slots,
    # with one extra row and a whole flush window of them.
    n = prefix_len + 31
    for batch, E in ((4, 1), (4, W), (8, 1), (8, W)):
        q = _bf16(rng, batch, H, hd)
        k8, ks = llama.quantize_kv(_bf16(rng, batch, s_max, KV * hd, scale=0.5))
        v8, vs = llama.quantize_kv(_bf16(rng, batch, s_max, KV * hd))
        k8, v8 = k8.reshape(batch, s_max, KV, hd), v8.reshape(batch, s_max, KV, hd)
        cur = (_bf16(rng, batch, W, KV, hd, scale=0.5)[:, :E], _bf16(rng, batch, W, KV, hd)[:, :E])
        start = ragged_starts(batch, n)
        args = (q, k8, v8, ks, vs, n, *cur)
        out = di.decode_attention_int8_cuda(*args, start)
        torch.cuda.synchronize()
        err = _check_bf16("decode_attention_int8 with start", out, di.decode_attention_int8_plain(*args, start))
        same = torch.equal(di.decode_attention_int8_cuda(*args, torch.zeros_like(start)),
                           di.decode_attention_int8_cuda(*args))
        if not same:
            raise RuntimeError("decode_attention_int8: starts of 0 moved the output of the kernel without start")
        ms, plain_ms = _alternate(lambda: di.decode_attention_int8_plain(*args, start),
                                  lambda: di.decode_attention_int8_cuda(*args, start))
        live = int((n - start).sum().item())
        bound = _bound(_nbytes(q, out, start, *cur) + 2 * live * (KV * hd + 4), 4 * H * (live + batch * E) * hd,
                       PEAK_INT8_OPS)
        cases.append({**_case("decode_attention_int8", f"B={batch} n={n} E={E} start", err,
                              f"{BF16_KERNEL_TOL} x max|plain|", ms, plain_ms, bound),
                      "starts": start.tolist(), "start_zero_bit_equal": same})
    return _row("decode_attention_int8", cases)


def _attn_flops(batch, S, D, H, KV, hd):
    """(projection operations, attention operations) of one attention block:
    the q/k/v and o products, and the causal triangle of QK^T and PV."""
    M = batch * S
    return (2 * M * D * (H + 2 * KV) * hd + 2 * M * H * hd * D,
            2 * 2 * batch * H * hd * (S * (S + 1) // 2))


def bench_attn_block_kv_quant(dec, S: int) -> dict:
    rng = np.random.default_rng(SEED + 6)
    lp = _decoder_layer(rng, dec)
    D, H, KV, hd = dec.hidden_size, dec.num_heads, dec.num_kv_heads, dec.head_dim
    cos, sin = llama.rope_device_tables(dec, S, torch.bfloat16, "cuda")
    kw = dict(num_heads=H, num_kv_heads=KV, head_dim=hd, eps=dec.rms_norm_eps, kv_quant=True)
    w = [lp[k] for k in ("ln_attn", "wq", "wk", "wv", "wo")]
    cases = []
    for batch in (1, 4):
        x = _bf16(rng, batch, S, D, scale=0.5)
        got = ab.attn_block_cuda(x, *w, cos, sin, **kw)
        torch.cuda.synchronize()
        ref = ab.attn_block_plain(x, *w, cos, sin, **kw)
        err = _check_bf16("attn_block kv_quant output", got[0], ref[0])
        kv = _check_int8_kv("attn_block kv_quant", got[1:], ref[1:])
        ms, plain_ms = _alternate(lambda: ab.attn_block_plain(x, *w, cos, sin, **kw),
                                  lambda: ab.attn_block_cuda(x, *w, cos, sin, **kw))
        bound = _bound(_nbytes(x, *w, cos, sin, *got), sum(_attn_flops(batch, S, D, H, KV, hd)), PEAK_BF16_FLOPS)
        split = split_or_none(lambda: ab.attn_block_cuda(x, *w, cos, sin, **kw))
        _print_split(f"attn_block_kv_quant B={batch} S={S} stages", split)
        cases.append({**_case("attn_block_kv_quant", f"B={batch} S={S}", err,
                              f"{BF16_KERNEL_TOL} x max|plain|; int8 k/v {INT8_LEVELS} level, "
                              f"scales {SCALE_RTOL:.2e} rel", ms, plain_ms, bound), **kv, "stages": split})
    return _row("attn_block_kv_quant", cases)


def bench_attn_block_w8a8(dec, S: int) -> dict:
    rng = np.random.default_rng(SEED + 7)
    D, H, KV, hd = dec.hidden_size, dec.num_heads, dec.num_kv_heads, dec.head_dim
    ln = 1 + _bf16(rng, D, scale=0.1)
    w = [t for shape in ((D, H * hd), (D, KV * hd), (D, KV * hd), (H * hd, D))
         for t in _int8_weight(rng, *shape)]
    cos, sin = llama.rope_device_tables(dec, S, torch.bfloat16, "cuda")
    kw = dict(num_heads=H, num_kv_heads=KV, head_dim=hd, eps=dec.rms_norm_eps, kv_quant=True)
    cases = []
    for batch in (1, 4):
        x = _bf16(rng, batch, S, D, scale=0.5)
        got = aw.attn_block_w8a8_cuda(x, ln, *w, cos, sin, **kw)
        torch.cuda.synchronize()
        ref = aw.attn_block_w8a8_plain(x, ln, *w, cos, sin, **kw)
        err = _check_bf16("attn_block_w8a8 output", got[0], ref[0])
        kv = _check_int8_kv("attn_block_w8a8", got[1:], ref[1:])
        ms, plain_ms = _alternate(lambda: aw.attn_block_w8a8_plain(x, ln, *w, cos, sin, **kw),
                                  lambda: aw.attn_block_w8a8_cuda(x, ln, *w, cos, sin, **kw))
        # The projections at the int8 peak, the attention core at bf16's.
        proj, attn = _attn_flops(batch, S, D, H, KV, hd)
        t_ops = proj / PEAK_INT8_OPS + attn / PEAK_BF16_FLOPS
        bound = _bound(_nbytes(x, ln, *w, cos, sin, *got), t_ops * PEAK_BF16_FLOPS, PEAK_BF16_FLOPS)
        split = split_or_none(lambda: aw.attn_block_w8a8_cuda(x, ln, *w, cos, sin, **kw))
        _print_split(f"attn_block_w8a8 B={batch} S={S} stages", split)
        cases.append({**_case("attn_block_w8a8", f"B={batch} S={S} kv_quant", err,
                              f"{BF16_KERNEL_TOL} x max|plain|; int8 k/v {INT8_LEVELS} level, "
                              f"scales {SCALE_RTOL:.2e} rel", ms, plain_ms, bound), **kv, "stages": split})
    return _row("attn_block_w8a8", cases)


def bench_mlp_block_w8a8(dec, S: int) -> dict:
    rng = np.random.default_rng(SEED + 8)
    D, I = dec.hidden_size, dec.intermediate_size
    ln = 1 + _bf16(rng, D, scale=0.1)
    w = [t for shape in ((D, I), (D, I), (I, D)) for t in _int8_weight(rng, *shape)]
    eps = dec.rms_norm_eps
    cases = []
    for batch in (1, 4):
        x = _bf16(rng, batch, S, D, scale=0.5)
        out = mw.mlp_block_w8a8_cuda(x, ln, *w, eps=eps)
        torch.cuda.synchronize()
        err = _check_bf16("mlp_block_w8a8", out, mw.mlp_block_w8a8_plain(x, ln, *w, eps=eps))
        ms, plain_ms = _alternate(lambda: mw.mlp_block_w8a8_plain(x, ln, *w, eps=eps),
                                  lambda: mw.mlp_block_w8a8_cuda(x, ln, *w, eps=eps))
        bound = _bound(_nbytes(x, ln, *w, out), 2 * batch * S * D * I * 3, PEAK_INT8_OPS)
        split = split_or_none(lambda: mw.mlp_block_w8a8_cuda(x, ln, *w, eps=eps))
        _print_split(f"mlp_block_w8a8 B={batch} S={S} stages", split)
        extra = _composed("mlp_block_w8a8", f"B={batch} S={S}", out,
                          lambda: composed_mlp_block_w8a8(x, ln, *w, eps=eps),
                          lambda: mw.mlp_block_w8a8_cuda(x, ln, *w, eps=eps))
        cases.append({**_case("mlp_block_w8a8", f"B={batch} S={S}", err, f"{BF16_KERNEL_TOL} x max|plain|",
                              ms, plain_ms, bound), "stages": split, **extra})
    return _row("mlp_block_w8a8", cases)


def bench_flash_gqa_prefill(dec, S: int) -> dict:
    rng = np.random.default_rng(SEED + 9)
    D, H, hd = dec.hidden_size, dec.num_heads, dec.head_dim
    kw = dict(num_heads=H, num_kv_heads=H, head_dim=hd)
    cases = []
    for batch in (1, 4):
        # The three column slices of one qkv product, as the GPT-2 prefill
        # hands them over.
        q, k, v = _bf16(rng, batch, S, 3 * D).split(D, dim=-1)
        out = fp.flash_gqa_prefill_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        err = _check_bf16("flash_gqa_prefill", out, fp.flash_gqa_prefill_plain(q, k, v, **kw))
        ms, plain_ms = _alternate(lambda: fp.flash_gqa_prefill_plain(q, k, v, **kw),
                                  lambda: fp.flash_gqa_prefill_cuda(q, k, v, **kw))
        # The one PyTorch call for the same function, on (B, H, S, hd) views
        # of the same slices.
        heads = [t.unflatten(-1, (H, hd)).transpose(1, 2) for t in (q, k, v)]
        _check_bf16("flash_gqa_prefill vs SDPA", out,
                    F.scaled_dot_product_attention(*heads, is_causal=True).transpose(1, 2).reshape(batch, S, D))
        paired = _paired(lambda: fp.flash_gqa_prefill_cuda(q, k, v, **kw),
                         lambda: F.scaled_dot_product_attention(*heads, is_causal=True))
        # q, k, v read once, o written once; the causal triangle of QK^T and PV.
        bound = _bound(_nbytes(q, k, v, out), 2 * 2 * batch * H * hd * (S * (S + 1) // 2), PEAK_BF16_FLOPS)
        cases.append(_case("flash_gqa_prefill", f"B={batch} S={S} H=KV={H} hd={hd}", err,
                           f"{BF16_KERNEL_TOL} x max|plain|", ms, plain_ms, bound, paired=paired))
    return _row("flash_gqa_prefill", cases)


def kernel_phase(cfg, gpt2_cfg, large_cfg) -> list:
    P = cfg.prefix_length
    return [bench_log_mel(cfg.frontend), bench_decode_attention(cfg.decoder, P),
            bench_attn_block(cfg.decoder, P), bench_mlp_block(cfg.decoder, P),
            bench_swin_block((("v0", cfg.encoder), ("HTSAT-large", large_cfg.encoder))),
            bench_decode_attention_int8(cfg.decoder, P),
            bench_attn_block_kv_quant(cfg.decoder, P), bench_attn_block_w8a8(cfg.decoder, P),
            bench_mlp_block_w8a8(cfg.decoder, P), bench_flash_gqa_prefill(gpt2_cfg.decoder, gpt2_cfg.prefix_length),
            bench_window_attention(large_cfg.encoder)]


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------

def zero_counts() -> None:
    for mod, counter, *_ in KERNELS.values():
        setattr(mod, counter, 0)


def read_counts() -> dict:
    return {name: getattr(mod, counter) for name, (mod, counter, *_) in KERNELS.items()}


class CallRecorder:
    """Wraps ``wrapper.generate`` to keep, per call, its rows, its decode
    steps (from the wrapper's token counter) and each kernel's launches.
    Calls run one at a time (the engine's dispatcher is one thread)."""

    def __init__(self, wrapper):
        self.calls = []
        self.wrapper = wrapper
        self.generate = wrapper.generate
        self._lock = threading.Lock()
        wrapper.generate = self

    def __call__(self, examples, *args, **kwargs):
        with self._lock:
            before, tokens = read_counts(), metrics.counters.get("tokens", 0.0)
            texts = self.generate(examples, *args, **kwargs)
            after = read_counts()
            steps = (metrics.counters.get("tokens", 0.0) - tokens) / len(examples)
            self.calls.append({"rows": len(examples), "steps": int(round(steps)),
                               "launches": {k: after[k] - before[k] for k in after}})
            return texts

    def remove(self):
        self.wrapper.generate = self.generate


def _mode(path: str) -> str:
    """fp32, bf16, int8 (W8A8 weights) or int8_weights, from the path's
    wrapper options."""
    ctor = PATHS[path][1]
    if ctor.get("compute_dtype") != "bfloat16":
        return "fp32"
    return {"int8-w8a8": "int8", "int8": "int8_weights"}.get(ctor.get("weight_dtype"), "bf16")


def encoder_launches(enc, clip_batches: int) -> dict:
    """What ``clip_batches`` bf16 encoder calls launch: log-mel once each,
    and per Swin block the kernel of its stage's route (the Swin block
    kernel, the window-attention kernel or none)."""
    want = {name: 0 for name in KERNELS}
    want["log_mel"] = clip_batches
    res, C = enc.grid_size, enc.embed_dim
    for si, depth in enumerate(enc.depths):
        route = htsat.kernel_route(C, enc.num_heads[si], enc.window_size, res)
        if route != "plain":
            want[route] += clip_batches * depth
        res, C = res // 2, C * 2
    return want


def decode_steps(steps: int, max_len: int = MAX_LEN) -> int:
    """The decode steps of a generate call whose ``num_steps`` is
    ``steps``: one per token of its flush windows, but none after the token
    at ``max_len - 1`` (``models/generate.py``: the loop ends with the
    window where every row is done, ``num_steps`` a multiple of W, or at
    ``max_len``). A cascade compaction adds none."""
    return steps - 1 if steps == max_len else steps


def expected_launches(cfg, steps: int, path: str, max_len: int = MAX_LEN) -> dict:
    """What one generate call of ``path`` (``cfg`` its config) that ran
    ``steps`` steps of ``max_len`` must launch: log-mel once per clip batch;
    beyond fp32 also, per clip batch, the kernel of each Swin block's route
    (v0: the Swin block kernel in stages 1-3; HTSAT-large: it in stage 1 and
    the window-attention kernel in stage 2) and, for llama, each prefill
    block once per layer and a decode attention once per layer per decode
    step (``decode_steps``): the bf16 kernels on the bf16 paths; the W8A8 blocks
    and the int8 decode attention on the int8 path; the bf16 blocks in
    their kv_quant mode (attention) and as they are (MLP) with the int8
    decode attention on the int8-weights path. GPT-2 in bf16 (int8 weights
    or not) runs the prefill attention once per layer, and its decode step
    no kernel."""
    mode = _mode(path)
    if mode == "fp32":
        return {name: 2 if name == "log_mel" else 0 for name in KERNELS}
    want = encoder_launches(cfg.encoder, 2)
    L = cfg.decoder.num_layers
    if cfg.decoder_family == "gpt2":
        want["flash_gqa_prefill"] = L
        return want
    attn, mlp, decode = {"bf16": ("attn_block", "mlp_block", "decode_attention"),
                         "int8": ("attn_block_w8a8", "mlp_block_w8a8", "decode_attention_int8"),
                         "int8_weights": ("attn_block_kv_quant", "mlp_block", "decode_attention_int8")}[mode]
    want[attn] = want[mlp] = L
    want[decode] = L * decode_steps(steps, max_len)
    return want


def check_calls(path: str, cfg, calls) -> None:
    """Each recorded generate call launched what ``expected_launches`` says
    for its steps."""
    for i, call in enumerate(calls):
        want = expected_launches(cfg, call["steps"], path)
        if call["launches"] != want:
            raise RuntimeError(f"{path}: call {i} ({call['rows']} rows, {call['steps']} steps) "
                               f"launched {call['launches']}, expected {want}")


# What drive() sends on a path: the first request alone; the three singles
# and a batch of 2; or those, a repeat and two requests through the engine.
CALLS_ROWS = {"one": 1, "batch": 5, "all": 8}


def drive(wrapper, cfg, requests, path: str, calls: str = "all") -> tuple:
    """Singles, a batch of 2, a repeated request, two requests through the
    engine (as far as ``calls`` says), with every count set to 0 first;
    returns (single answers, launches of the run, generate calls). Every
    call's launches are checked, and so is that the path launched each of
    its kernels."""
    rec = CallRecorder(wrapper)
    gen_kwargs = PATHS[path][2]

    def timed(examples):
        t = time.perf_counter()
        texts = wrapper.generate(examples, max_len=MAX_LEN, **gen_kwargs)
        dt = time.perf_counter() - t
        call = rec.calls[-1]
        n = call["rows"] * call["steps"]
        print(json.dumps({"path": path, "rows": len(examples), "latency_s": dt, "tokens": n,
                          "tokens_per_s": n / dt, "launches": call["launches"]}))
        return texts

    try:
        zero_counts()
        singles = [timed([ex])[0] for ex in (requests if calls != "one" else requests[:1])]
        if calls != "one" and timed(requests[:2]) != singles[:2]:
            raise RuntimeError(f"{path}: a batch of 2 answered otherwise than the single requests")
        if calls == "all":
            if timed([requests[0]])[0] != singles[0]:
                raise RuntimeError(f"{path}: a repeated request gave a different answer")
            engine = BatchingEngine(wrapper, dynamic_batch=False)
            try:
                t = time.perf_counter()
                futures = [engine.submit(*ex, max_len=MAX_LEN, **gen_kwargs) for ex in requests[:2]]
                served = [f.result(timeout=600) for f in futures]
                print(json.dumps({"path": path, "engine_requests": len(served),
                                  "latency_s": time.perf_counter() - t}))
            finally:
                engine.shutdown()
        launches = read_counts()
    finally:
        rec.remove()

    rows = sum(c["rows"] for c in rec.calls)
    if rows < CALLS_ROWS[calls]:
        raise RuntimeError(f"{path}: only {rows} rows answered")
    check_calls(path, cfg, rec.calls)
    missing = [k for k, n in expected_launches(cfg, 2, path).items() if n and not launches[k]]
    if missing:
        raise RuntimeError(f"{path}: kernels never launched on the path: {missing}")
    print(f"{path}: {rows} rows in {len(rec.calls)} generate calls, launches {launches}")
    return singles, launches, len(rec.calls)


def prefix_and_logits(params, cfg, audio1, audio2, text, device, dtype, tokens=None, int8=False):
    """The prefix, the prefill logits and the logits of one decode step at
    the batch of ``text``; the step feeds ``tokens`` (default: the prefill's
    greedy tokens). ``int8``: an int8 cache and the W8A8 prefill blocks
    (llama). Returns (prefix, prefill logits, step logits, tokens)."""
    args = [torch.from_numpy(audio1).to(device, dtype), torch.from_numpy(audio2).to(device, dtype),
            torch.from_numpy(text).to(device)]
    dec, p = cfg.decoder, params["decoder"]
    with torch.no_grad():
        prefix = encode_and_prefix(params, cfg, *args)
        B, P = prefix.shape[:2]
        if cfg.decoder_family == "gpt2":
            cache = gpt2.GPT2Cache.create(dec, B, P + 1, device, dtype)
            logits = gpt2.logits_from_hidden(p, dec, gpt2.prefill(p, dec, prefix, cache))
            tokens = logits.argmax(-1).cpu() if tokens is None else tokens
            hidden = gpt2.decode_step(p, dec, p["wte"][tokens.to(device)], cache, P)
            step = gpt2.logits_from_hidden(p, dec, hidden)
        else:
            cache = llama.KVCache.create(dec, B, P + 1, device, torch.int8 if int8 else dtype)
            logits = llama.logits_from_hidden(p, dec, llama.prefill(p, dec, prefix, cache, w8a8=int8))
            tokens = logits.argmax(-1).cpu() if tokens is None else tokens
            cos, sin = llama.rope_device_tables(dec, P + 1, dtype, device)
            # An int8 cache takes the step's row through a window of one.
            window = llama.FlushWindow(dec, B, 1, P, device, dtype) if int8 else None
            hidden = llama.decode_step(p, dec, p["embed"][tokens.to(device)], cache, P, cos, sin, window)
            step = llama.logits_from_hidden(p, dec, hidden)
    return prefix.float().cpu(), logits.float().cpu(), step.float().cpu(), tokens


def stage_times(wrapper, cfg, request, batch: int, path: str) -> dict:
    """Per-stage times of one path at batch ``batch``: host clock around
    work that ends in a synchronize (medians of 3), the log-mel's device
    time (median of 5), the decode step as the slope between 32 and 64
    generated tokens at a fixed prefix (medians of 3 each) with no stop
    token, so both lengths run in full."""
    dev, dt, dec, p = wrapper.device, wrapper.dtype, cfg.decoder, wrapper.params
    _, ctor, gen_kwargs = PATHS[path]
    int8 = gen_kwargs.get("kv_cache_dtype") == "int8"
    w8a8 = ctor.get("weight_dtype") == "int8-w8a8"
    family = cfg.decoder_family
    examples = [request] * batch
    out = {}
    t = time.perf_counter()
    a1 = wrapper.preprocess_audio([e[0] for e in examples], True, 0)
    a2 = wrapper.preprocess_audio([e[1] for e in examples], True, 0)
    text = wrapper.preprocess_text([e[2] for e in examples])
    out["host_preprocessing_ms"] = (time.perf_counter() - t) * 1e3
    w1, w2 = torch.from_numpy(a1).to(dev, dt), torch.from_numpy(a2).to(dev, dt)
    ids = torch.from_numpy(text).to(dev)
    out["log_mel_ms"] = _median_ms(lambda: (fe.log_mel_auto(w1.float(), cfg.frontend),
                                            fe.log_mel_auto(w2.float(), cfg.frontend)), reps=5, warmup=1)
    with torch.no_grad():
        prefix = encode_and_prefix(p, cfg, w1, w2, ids)
        out["encoder_prefix_ms"] = _host_ms(lambda: encode_and_prefix(p, cfg, w1, w2, ids))
        P = prefix.shape[1]

        def prefill():
            if family == "gpt2":
                gpt2.prefill(p["decoder"], dec, prefix, gpt2.GPT2Cache.create(dec, batch, P, dev, dt))
            else:
                cache = llama.KVCache.create(dec, batch, P, dev, torch.int8 if int8 else dt)
                llama.prefill(p["decoder"], dec, prefix, cache, w8a8=w8a8)

        out["prefill_ms"] = _host_ms(prefill)
        # Three pairs, the two lengths in turn; the slope of the medians, and
        # the spread of the three pairs' own slopes.
        t32, t64 = [], []
        for _ in range(3):
            for n, ts in ((32, t32), (64, t64)):
                ts.append(_host_ms(lambda: gen.generate(p["decoder"], dec, prefix, max_len=n, stop_token_id=-1,
                                                        w8a8=w8a8, family=family, **gen_kwargs),
                                   reps=1))
    out["decode_step_ms"] = (statistics.median(t64) - statistics.median(t32)) / 32
    slopes = [(b - a) / 32 for a, b in zip(t32, t64)]
    out["decode_step_ms_min_max"] = [min(slopes), max(slopes)]
    out["decode_tokens_per_s"] = batch / (out["decode_step_ms"] / 1e3)
    if family == "llama":
        # Streaming every weight and the 64-token run's whole cache once a
        # step at the HBM rate: a yardstick, not a limit.
        compute = str(dt).removeprefix("torch.")
        n_bytes = roofline.decode_step_bytes(dec, batch, P + 64, "int8" if int8 else compute,
                                             "int8" if ctor.get("weight_dtype") else compute)
        bound = out["decode_step_hbm_bound_ms"] = n_bytes / PEAK_HBM_BYTES * 1e3
        print(f"decode step {path} B={batch}: {out['decode_step_ms']:.4f} ms, streaming bound {bound:.4f} ms "
              f"({roofline.pct(bound / out['decode_step_ms'])})")
    out["request_ms"] = _host_ms(lambda: wrapper.generate(examples, max_len=MAX_LEN, crop_start=0,
                                                          **gen_kwargs))
    return out


def _agreement(label, answers, ref_answers) -> bool:
    same = sum(x == y for s, t in zip(answers, ref_answers) for x, y in zip(s, t))
    total = sum(max(len(s), len(t)) for s, t in zip(answers, ref_answers))
    first = [s[:1] == t[:1] for s, t in zip(answers, ref_answers)]
    print(f"greedy token agreement {label} over {len(answers)} requests: {same}/{total}; "
          f"first tokens equal: {first}")
    return all(first)


def _hold(label, names, got, ref, tols) -> None:
    for name, g, r, tol in zip(names, got, ref, tols):
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise RuntimeError(f"{label} {name}: bad output {tuple(g.shape)}")
        err, scale = (g - r).abs().max().item(), r.abs().max().item()
        print(f"{label} {name} {tuple(g.shape)}: max_abs_err {err:.3e} = {err / scale:.4f} x max|ref| "
              f"(limit {tol})")
        if err > tol * scale:
            raise RuntimeError(f"{label} {name} is {err / scale:.4f} x max|ref| off, limit {tol}")


def hold_family(label, cfg, params, trees, int8_name, inputs, int8_cache: bool, int8_tol,
                device="cuda") -> None:
    """One configuration at the batch of ``inputs`` (audio1, audio2, text
    ids): the fp32 path (``trees[0]``) on ``device`` against the same
    weights on the CPU, bf16 (``trees[1]``) against fp32, and, where
    ``trees`` has a third, the int8 path (named ``int8_name``; llama: W8A8
    weights and an int8 cache, ``int8_cache``; GPT-2: int8 weights) against
    bf16, whose prefix it must equal bit for bit: the int8 options change
    only the decoder."""
    names = ("prefix", "prefill logits", "decode-step logits")
    *ref32, tokens = prefix_and_logits(trees[0], cfg, *inputs, device, torch.float32)
    *got16, _ = prefix_and_logits(trees[1], cfg, *inputs, device, torch.bfloat16, tokens)
    *cpu32, _ = prefix_and_logits(params_from_jax(params, "cpu"), cfg, *inputs, "cpu", torch.float32, tokens)
    for name, got, ref in zip(names, ref32, cpu32):
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"{label}fp32 {name}: bad output {tuple(got.shape)}")
        print(f"{label}fp32 {name} {tuple(got.shape)}: CUDA vs CPU max_abs_err {(got - ref).abs().max().item():.3e}")
        torch.testing.assert_close(got, ref, **SLICE_TOL)
    _hold(f"{label}bf16 vs fp32 CUDA", names, got16, ref32, BF16_TOL)
    print(f"{label}prefill argmax bf16 {got16[1].argmax(-1).tolist()}, fp32 {ref32[1].argmax(-1).tolist()}")
    if len(trees) < 3:
        return
    *got8, _ = prefix_and_logits(trees[2], cfg, *inputs, device, torch.bfloat16, tokens, int8=int8_cache)
    if not torch.equal(got8[0], got16[0]):
        raise RuntimeError(f"the {int8_name} path's prefix differs from the bf16 path's")
    _hold(f"{int8_name} vs bf16 CUDA", names[1:], got8[1:], got16[1:], int8_tol)
    print(f"{int8_name} prefill argmax {got8[1].argmax(-1).tolist()}")


def hold_gpt2_float_cache(wrapper, cfg, request) -> dict:
    """One bf16 GPT-2 request with an fp32 KV cache (the JAX package's
    einsum path: rows cast into the cache at the prefill and at each flush
    window's end) against the same request with the bf16 cache: the same
    first token (the cache's rows are bf16 values either way, so the answers
    should agree in full; the agreement is printed), and the launches of
    the GPT-2 bf16 path."""
    ref = wrapper.generate([request], max_len=MAX_LEN)[0]
    zero_counts()
    got = wrapper.generate([request], max_len=MAX_LEN, kv_cache_dtype="float32")[0]
    launches = read_counts()
    want = expected_launches(cfg, MAX_LEN, "gpt2_bf16")
    out = {"answers_equal": got == ref, "tokens_equal": sum(x == y for x, y in zip(got, ref)),
           "tokens": max(len(got), len(ref)), "launches": launches}
    print(json.dumps({"gpt2_fp32_cache_vs_bf16_cache": out}))
    if got[:1] != ref[:1] or launches != want:
        raise RuntimeError(f"gpt2 fp32 cache: first token {got[:1]!r} vs {ref[:1]!r}, launches {launches} "
                           f"vs {want}")
    return out


# The encoder's other entry points at HTSAT-large on the card: name,
# function, seconds of wave (a long clip; a short one for the infer mode;
# 10 s for the full 1025-row form).
ENCODER_ENTRIES = (("htsat_embedding_long", htsat.htsat_embedding_long, 15.0),
                   ("htsat_embedding_infer_mode", htsat.htsat_embedding_infer_mode, 3.0),
                   ("htsat_embedding", htsat.htsat_embedding, 10.0))


def hold_encoder_entries(cfg, params16, params32) -> dict:
    """One bf16 call of each entry point on a seeded B=1 wave at 32 kHz: its
    launches checked (the log-mel once, each Swin block's kernel once: the
    long path's crops run as one batch), its embedding held against the
    fp32 call on the card within the prefix limit of BF16_TOL. Returns each
    call's launches."""
    rng = np.random.default_rng(SEED + 11)
    out = {}
    for name, fn, seconds in ENCODER_ENTRIES:
        wave_ = torch.from_numpy(
            (rng.standard_normal((1, int(seconds * cfg.frontend.sample_rate))) * 0.1).astype(np.float32)).cuda()
        with torch.no_grad():
            zero_counts()
            got = fn(wave_.bfloat16(), params16, cfg.frontend, cfg.encoder)["embedding"]
            torch.cuda.synchronize()
            launches = read_counts()
            ref = fn(wave_, params32, cfg.frontend, cfg.encoder)["embedding"]
        want = encoder_launches(cfg.encoder, 1)
        if launches != want:
            raise RuntimeError(f"{name}: launched {launches}, expected {want}")
        _hold(f"large {name} ({seconds} s) bf16 vs fp32 CUDA", ("embedding",), (got.float().cpu(),),
              (ref.float().cpu(),), BF16_TOL[:1])
        out[name] = launches
    return out


# ---------------------------------------------------------------------------
# decoding phase: sampling, repetition penalty, streaming, cascade
# ---------------------------------------------------------------------------

# The sampled requests' knobs (the wrapper's defaults), the penalty, and the
# knobs the card's kept set is held to the CPU's on.
SAMPLE_KNOBS = {"top_p": 0.8, "temperature": 1.0}
PENALTY = 1.3
WARP_CASES = ({"top_p": 0.8, "top_k": 50, "temperature": 0.7, "repetition_penalty": PENALTY},
              {"top_p": 0.95, "top_k": 0, "temperature": 1.0, "repetition_penalty": PENALTY})


class StepRecorder:
    """Keeps each decode sub-step's logits (fp32), chosen tokens and seen
    mask by wrapping ``generate._sample_token``, which the window body looks
    up at every sub-step."""

    def __enter__(self):
        self.steps, self._sample = [], gen._sample_token

        def record(logits, **kw):
            tok = self._sample(logits, **kw)
            seen = kw.get("seen")
            self.steps.append((logits.float(), tok, None if seen is None else seen.clone()))
            return tok

        gen._sample_token = record
        return self

    def __exit__(self, *exc):
        gen._sample_token = self._sample


class CompactionRecorder:
    """(t, batch before, batch after) of each cascade compaction, by
    wrapping ``generate._compact_state``."""

    def __enter__(self):
        self.seen, self.perms, self._compact = [], [], gen._compact_state

        def record(state, perm):
            self.seen.append((state.t, state.tokens.shape[0], len(perm)))
            self.perms.append(perm.cpu())
            return self._compact(state, perm)

        gen._compact_state = record
        return self

    def __exit__(self, *exc):
        gen._compact_state = self._compact


def _first_difference(a: str, b: str):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def hold_sampling(path, wrapper, cfg, examples, greedy) -> dict:
    """``sample=True`` on one path: with ``top_k=1`` every draw is a token
    at its row's largest logit, and the answers are greedy's, except where a
    row's largest logit is tied (the kept set keeps every tied token: the
    first difference must sit at such a tie); at top_p 0.8 every draw lies
    in the kept set of its step's logits and one seed repeats its answers."""
    kw = PATHS[path][2]
    with StepRecorder() as rec:
        top1 = wrapper.generate(examples, max_len=MAX_LEN, sample=True, top_k=1, seed=0, **kw)
    for logits, tok, _ in rec.steps:
        if not torch.equal(logits.gather(1, tok[:, None])[:, 0], logits.amax(-1)):
            raise RuntimeError(f"{path}: a top_k=1 draw is not at its row's largest logit")
    ties = []
    for r, (a, b) in enumerate(zip(top1, greedy)):
        if a != b:
            j = _first_difference(a, b)
            row = rec.steps[j][0][r]
            ties.append({"row": r, "step": j, "tied_at_max": int((row == row.max()).sum())})
            if ties[-1]["tied_at_max"] < 2:
                raise RuntimeError(f"{path}: top_k=1 left greedy at row {r} step {j} with no tie")
    with StepRecorder() as rec:
        s0 = wrapper.generate(examples, max_len=MAX_LEN, sample=True, seed=0, **SAMPLE_KNOBS, **kw)
    for logits, tok, _ in rec.steps:
        kept = gen.warp_logits(logits, **SAMPLE_KNOBS)
        if not torch.isfinite(kept.gather(1, tok[:, None])).all():
            raise RuntimeError(f"{path}: a top_p=0.8 draw lies outside its kept set")
    again = wrapper.generate(examples, max_len=MAX_LEN, sample=True, seed=0, **SAMPLE_KNOBS, **kw)
    other = wrapper.generate(examples, max_len=MAX_LEN, sample=True, seed=1, **SAMPLE_KNOBS, **kw)
    if again != s0:
        raise RuntimeError(f"{path}: one seed gave two sampled answers")
    same = sum(x == y for a, b in zip(s0, greedy) for x, y in zip(a, b))
    out = {"path": path, "top_k1_equals_greedy": top1 == greedy, "top_k1_ties": ties,
           "top_p_draws_checked": len(rec.steps) * len(examples), "seed_repeats": True,
           "seed_1_differs": other != s0, "top_p_tokens_equal_to_greedy": same,
           "tokens": sum(len(a) for a in greedy)}
    print(json.dumps({"sampling": out}))
    return out


def hold_penalty(wrapper, cfg, examples, greedy) -> dict:
    """Greedy with ``repetition_penalty`` in fp32; at three of its steps the
    sampler's kept set on the card's own logits and seen mask, copied to the
    CPU, equals the CPU's (the same -inf mask, values within 2 fp32 ulps of
    the largest kept logit)."""
    with StepRecorder() as rec:
        pen = wrapper.generate(examples, max_len=MAX_LEN, repetition_penalty=PENALTY)
    worst = 0.0
    for k in (0, len(rec.steps) // 2, len(rec.steps) - 1):
        logits, _, seen = rec.steps[k]
        for knobs in WARP_CASES:
            card = gen.warp_logits(logits, seen=seen, **knobs).cpu()
            cpu = gen.warp_logits(logits.cpu(), seen=seen.cpu(), **knobs)
            kept = torch.isfinite(cpu)
            if not torch.equal(torch.isfinite(card), kept):
                raise RuntimeError(f"penalty step {k} {knobs}: the card's kept set differs from the CPU's")
            err = (card[kept] - cpu[kept]).abs().max().item()
            limit = 2 * torch.finfo(torch.float32).eps * cpu[kept].abs().max().item()
            if err > limit:
                raise RuntimeError(f"penalty step {k} {knobs}: kept logits {err:.3e} apart, limit {limit:.3e}")
            worst = max(worst, err)
    same = sum(x == y for a, b in zip(pen, greedy) for x, y in zip(a, b))
    out = {"path": "fp32", "repetition_penalty": PENALTY, "tokens_equal_to_greedy": same,
           "tokens": sum(len(a) for a in greedy), "kept_sets_equal": 3 * len(WARP_CASES),
           "kept_logits_max_abs_err": worst}
    print(json.dumps({"penalty": out}))
    return out


def hold_no_sync(wrapper, cfg, request) -> dict:
    """With ``torch.cuda.set_sync_debug_mode("error")``, which raises at any
    operation that waits for the card: the sampler in each of its modes,
    and one whole flush window of sampled, penalised decoding."""
    path = "int8" if wrapper._w8a8 else "bf16"
    a1 = wrapper.preprocess_audio([request[0]], True, 0)
    a2 = wrapper.preprocess_audio([request[1]], True, 0)
    w1, w2, ids = wrapper._device_inputs(a1, a2, wrapper.preprocess_text([request[2]]))
    p, dec = wrapper.params, cfg.decoder
    prefix = encode_and_prefix(p, cfg, w1, w2, ids)
    rng = torch.Generator(device=wrapper.device)
    rng.manual_seed(SEED)
    W = gen.effective_window(None, MAX_LEN, 1)
    state = gen._init_state(p["decoder"], dec, prefix, max_len=MAX_LEN, family="llama", W=W, rng=rng,
                            kv_cache_dtype=PATHS[path][2].get("kv_cache_dtype"), initial_done=None,
                            repetition_penalty=PENALTY, prompt_tokens=ids, prompt_mask=ids != cfg.pad_token_id,
                            w8a8=wrapper._w8a8)
    body = gen._window_body(p["decoder"], dec, state, family="llama", max_len=MAX_LEN, stop_token_id=-1,
                            greedy=False, top_k=50, repetition_penalty=PENALTY, W=W, **SAMPLE_KNOBS)
    logits = llama.logits_from_hidden(p["decoder"], dec, state.last_hidden)
    modes = {"greedy": {"greedy": True}, "greedy_penalty": {"greedy": True, "repetition_penalty": PENALTY},
             "sampled": {"greedy": False}, "sampled_top_k_penalty": {"greedy": False, "top_k": 50,
                                                                    "repetition_penalty": PENALTY}}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for m in modes.values():
            gen._sample_token(logits, rng=rng, seen=state.seen, **{**SAMPLE_KNOBS, **m})
        state = body(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out = {"path": path, "sampler_modes": list(modes), "window_steps": state.t}
    print(json.dumps({"no_host_sync": out}))
    return out


def hold_stream(path, wrapper, cfg, examples) -> dict:
    """``generate_stream``'s yields: one a window, each a prefix of the next,
    the last one ``generate``'s answers; its launches checked."""
    kw = PATHS[path][2]
    zero_counts()
    t = time.perf_counter()
    yields = list(wrapper.generate_stream(examples, max_len=MAX_LEN, **kw))
    stream_s = time.perf_counter() - t
    launches = read_counts()
    whole = wrapper.generate(examples, max_len=MAX_LEN, **kw)
    if yields[-1] != whole:
        raise RuntimeError(f"{path}: the stream's last yield differs from generate")
    if not all(a == b[: len(a)] for y, z in zip(yields, yields[1:]) for a, b in zip(y, z)):
        raise RuntimeError(f"{path}: a stream yield is not a prefix of the next")
    W = gen.effective_window(None, MAX_LEN, len(examples))
    want = expected_launches(cfg, min(len(yields) * W, MAX_LEN), path)
    if launches != want:
        raise RuntimeError(f"{path}: the stream launched {launches}, expected {want}")
    out = {"path": path, "yields": len(yields), "window": W, "latency_s": stream_s,
           "last_equals_generate": True, "launches": launches}
    print(json.dumps({"stream": out}))
    return out


def hold_cascade(path, wrapper, cfg, requests) -> dict:
    """``generate_tokens_dynamic`` at B=4 with ``min_batch=1`` against the
    static ``generate_tokens`` on the same rows. The rows are [ra, rb, rc,
    ra] for the three requests, where request a emits in its first window a
    token that b and c do not emit before the second: with that token as
    the stop, rows 0 and 3 finish in the first window and the batch compacts
    to 2 rows after it. (With random weights a row may repeat one token;
    where no request has such a token, rows 1 and 3 start done instead, and
    the batch compacts before the first window.) Before the first compaction
    every row must equal the static path's; after it the live rows' token
    agreement is printed (the products choose their algorithm by M, so the
    bits may move). Every call's launches checked."""
    kw = dict(max_len=MAX_LEN, kv_cache_dtype=PATHS[path][2].get("kv_cache_dtype"), w8a8=wrapper._w8a8)
    W = gen.effective_window(None, MAX_LEN, 4)
    calls = []

    def static(rows):
        examples = [requests[r] for r in rows]
        a1 = wrapper.preprocess_audio([e[0] for e in examples], True, 0)
        a2 = wrapper.preprocess_audio([e[1] for e in examples], True, 0)
        inputs = wrapper._device_inputs(a1, a2, wrapper.preprocess_text([e[2] for e in examples]))
        zero_counts()
        with StepRecorder() as rec:
            res = mellow_model.generate_tokens(wrapper.params, cfg, *inputs, stop_token_id=-1, **kw)
        calls.append({"rows": 4, "steps": res.num_steps, "launches": read_counts()})
        return inputs, res.tokens.cpu(), [logits for logits, _, _ in rec.steps]

    inputs, tokens, ref_logits = static([0, 1, 2, 0])

    def first(row, v):
        hits = torch.nonzero(tokens[row] == v)
        return int(hits[0, 0]) if len(hits) else MAX_LEN

    pick = next(((a, int(v)) for a in range(3) for v in tokens[a, :W]
                 if all(first(r, v) >= W for r in range(3) if r != a)), None)
    initial_done = None
    if pick is None:
        stop, rows = -1, [0, 1, 2, 0]
        initial_done = torch.tensor([False, True, False, True], device=wrapper.device)
    else:
        a, stop = pick
        rows = [a] + [r for r in range(3) if r != a] + [a]
        if rows != [0, 1, 2, 0]:
            inputs, tokens, ref_logits = static(rows)
    zero_counts()
    t = time.perf_counter()
    with CompactionRecorder() as comp, StepRecorder() as rec:
        dyn = mellow_model.generate_tokens_dynamic(wrapper.params, cfg, *inputs, stop_token_id=stop, min_batch=1,
                                                   initial_done=initial_done, **kw)
        got = dyn.tokens.cpu()
    dyn_s = time.perf_counter() - t
    calls.append({"rows": 4, "steps": dyn.num_steps, "launches": read_counts()})
    check_calls(path, cfg, calls)
    if not comp.seen:
        raise RuntimeError(f"{path}: the cascade never compacted")
    t0 = comp.seen[0][0]
    if not torch.equal(got[:, :t0], tokens[:, :t0]):
        raise RuntimeError(f"{path}: the cascade's rows differ from the static path's before the first compaction")
    trimmed = gen.tokens_to_lists(dyn, stop)
    ref = gen.tokens_to_lists(gen.GenerateResult(tokens, dyn.num_steps), stop)
    live = [r for r in range(4) if len(ref[r]) >= t0 and (initial_done is None or not initial_done[r])]
    same = sum(x == y for r in live for x, y in zip(trimmed[r][t0:], ref[r][t0:]))
    total = sum(len(ref[r]) - t0 for r in live)
    # The live rows' logits from the first compaction to the next (or the
    # end) against the static batch's, relative to the largest: whether the
    # bits moved with the batch.
    perm = comp.perms[0][: len(live)]
    t1 = comp.seen[1][0] if len(comp.seen) > 1 else dyn.num_steps
    moved = max(((rec.steps[k][0][: len(live)].cpu() - ref_logits[k][perm].cpu()).abs().max().item()
                 for k in range(t0, min(t1, len(rec.steps)))), default=0.0)
    scale = max(ref_logits[k].abs().max().item() for k in range(t0, min(t1, len(ref_logits)))) if t1 > t0 else 1.0
    out = {"path": path, "rows": rows, "stop_token_id": stop, "initial_done": initial_done is not None,
           "compactions": comp.seen, "num_steps": dyn.num_steps, "rows_equal_before_first_compaction": True,
           "live_rows_after": live, "tokens_equal_after_first_compaction": same,
           "tokens_after_first_compaction": total, "trimmed_rows_equal": [trimmed[r] == ref[r] for r in live],
           "logits_max_abs_diff_after_first_compaction": moved, "logits_max_abs": scale,
           "latency_s": dyn_s, "launches": calls[-1]["launches"]}
    print(json.dumps({"cascade": out}))
    return out


def products_by_batch(path, wrapper, cfg) -> dict:
    """Where a cascade's bits can move: each product of a llama decode step
    (layer 0's projections and MLP, the logits head) on the same seeded rows
    at M = 4 and at M = 2 (rows 1-2); the largest difference of those rows,
    0 where the library computes a row alike at both M."""
    p = wrapper.params["decoder"]
    lp = p["layers"][0]
    head = p.get("lm_head_q", p["embed"].T)
    g = torch.Generator(device=wrapper.device)
    g.manual_seed(SEED)
    out = {}
    for name, w in [(k, lp[k]) for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")] + [("head", head)]:
        k = (w["q"] if isinstance(w, dict) else w).shape[0]
        x = torch.randn(4, k, generator=g, device=wrapper.device).to(wrapper.dtype)
        out[name] = (llama._mm(x, w)[1:3] - llama._mm(x[1:3].contiguous(), w)).abs().max().item()
    print(json.dumps({"products_by_batch": path, **out}))
    return out


def time_sampler(dec) -> dict:
    """The sampler's device time a step on v0-sized bf16 logits (spin-queued
    medians of 20), greedy and sampled, with and without the penalty."""
    rng = np.random.default_rng(SEED + 21)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    out = {}
    for B in (1, 4):
        logits = _bf16(rng, B, dec.vocab_size, scale=2.0)
        seen = torch.from_numpy(rng.random((B, dec.vocab_size)) < 0.01).cuda()
        for name, m in (("greedy", {"greedy": True}),
                        ("greedy_penalty", {"greedy": True, "repetition_penalty": PENALTY, "seen": seen}),
                        ("top_p_0.8", {"greedy": False}),
                        ("top_k_50_top_p_0.8_penalty", {"greedy": False, "top_k": 50,
                                                         "repetition_penalty": PENALTY, "seen": seen})):
            out[f"{name} B={B}"] = _median_ms(lambda: gen._sample_token(logits, rng=g, **SAMPLE_KNOBS, **m))
    print(json.dumps({"sampler_ms": out}))
    return out


def request_latency(wrapper, request) -> dict:
    """Host-clock latency of one B=1 ``max_len=32`` request, greedy against
    sampled (top_p 0.8), in turns: greedy, sampled, sampled, greedy; one
    request each."""
    ms = {"greedy": [], "sampled": []}
    for mode in ("greedy", "sampled", "sampled", "greedy"):
        kw = {"sample": True, **SAMPLE_KNOBS} if mode == "sampled" else {}
        ms[mode].append(_host_ms(lambda: wrapper.generate([request], max_len=MAX_LEN, **kw), reps=1))
    out = {f"{mode}_ms": statistics.mean(v) for mode, v in ms.items()}
    out.update({f"{mode}_ms_runs": v for mode, v in ms.items()})
    print(json.dumps({"request_latency bf16 B=1": out}))
    return out


def decoding_phase(wrappers, cfgs, requests, answers) -> dict:
    """Sampling on the bf16 and int8 paths, the penalty in fp32, the host
    syncs, streaming, the cascade on the fp32, bf16, int8 and GPT-2 bf16
    paths, and the sampler's times."""
    t = time.perf_counter()
    v0 = cfgs["v0"]
    batch = requests[:2]
    out = {"sampling": {}, "stream": {}, "cascade": {}}
    for path in ("bf16", "int8"):
        rec = CallRecorder(wrappers[path])
        try:
            greedy = wrappers[path].generate(batch, max_len=MAX_LEN, **PATHS[path][2])
            out["sampling"][path] = hold_sampling(path, wrappers[path], v0, batch, greedy)
        finally:
            rec.remove()
        check_calls(path, v0, rec.calls)
        out["stream"][path] = hold_stream(path, wrappers[path], v0, batch)
        out[f"no_host_sync {path}"] = hold_no_sync(wrappers[path], v0, requests[0])
    rec = CallRecorder(wrappers["fp32"])
    try:
        out["penalty"] = hold_penalty(wrappers["fp32"], v0, batch, answers["fp32"][:2])
    finally:
        rec.remove()
    check_calls("fp32", v0, rec.calls)
    for path in ("fp32", "bf16", "int8", "gpt2_bf16"):
        out["cascade"][path] = hold_cascade(path, wrappers[path], cfgs[PATHS[path][0]], requests)
    out["products_by_batch"] = {path: products_by_batch(path, wrappers[path], v0) for path in ("fp32", "bf16", "int8")}
    out["sampler_ms"] = time_sampler(v0.decoder)
    out["request_latency"] = request_latency(wrappers["bf16"], requests[0])
    print(f"decoding phase took {time.perf_counter() - t:.1f} s")
    return out


# ---------------------------------------------------------------------------
# continuous batching phase
# ---------------------------------------------------------------------------

CONTINUOUS_SLOTS = 4
CONTINUOUS_HORIZON = 64
CONTINUOUS_W = 8
# Ten requests' token budgets (4 to 48): through 4 slots and a 64-step
# window they force two window rolls and a capacity reset. No stop token
# (-1): each row ends at its deadline, so the schedule is the budgets'.
CONTINUOUS_BUDGETS = (8, 4, 40, 16, 48, 6, 24, 12, 32, 44)
# mode -> (the wrapper's path, kv_cache_dtype): fp32 (no kernel), bf16 (#4,
# #6 in admit, #2 with start), bf16 with an int8 cache (#4 kv_quant, #6,
# #3 with start).
CONTINUOUS_MODES = {"fp32": ("fp32", None), "bf16": ("bf16", None), "int8_cache": ("bf16", "int8")}
# A greedy fp32 row may leave its solo run only where the solo run's top two
# logits lie this close (a near-tie that summation order can flip).
NEAR_TIE = 1e-5


def _device_ms(fn):
    """(fn's result, the device time of its kernels): torch.profiler over the
    call, the sum of the kernel times it saw."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, sum(e.time_range.elapsed_us() for e in kernels) / 1e3


class ContinuousRecorder:
    """Wraps ``continuous.admit``, ``roll_window`` and ``decode_stage`` (the
    scheduler looks each up at call time), ``generate._window_body`` and
    ``llama.decode_step`` (looked up by every stage and every window): each
    admission's device time (``_device_ms``: a prefill and its splice),
    each roll's (``_median_ms`` of the same roll again: it is pure and
    sync-free), the device time of the first window after the first
    admission (``_device_ms``: W decode steps at the slots' full width),
    each stage's decode steps and host time, and the decode steps run."""

    def __enter__(self):
        from mellow_tpu_torch.models import continuous as cb

        self._cb = cb
        self.admits, self.rolls, self.stages, self.window = [], [], [], None
        self.steps = 0
        self._orig = {name: getattr(cb, name) for name in ("admit", "roll_window", "decode_stage")}
        self._body, self._step = gen._window_body, llama.decode_step

        def admit(*args, **kwargs):
            out, ms = _device_ms(lambda: self._orig["admit"](*args, **kwargs))
            self.admits.append({"rows": int(args[4].shape[0]), "device_ms": ms})
            return out

        def roll(*args, **kwargs):
            out = self._orig["roll_window"](*args, **kwargs)
            self.rolls.append({"delta": args[1], "device_ms": _median_ms(
                lambda: self._orig["roll_window"](*args, **kwargs))})
            return out

        def stage(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = self._orig["decode_stage"](*args, **kwargs)
            torch.cuda.synchronize()
            self.stages.append({"steps": out.t - args[2].t, "host_ms": (time.perf_counter() - t) * 1e3})
            return out

        def window_body(*args, **kwargs):
            body = self._body(*args, **kwargs)

            def timed(state):
                if self.window is not None:
                    return body(state)
                live = int((~state.done).sum().item())
                out, ms = _device_ms(lambda: body(state))
                self.window = {"steps": out.t - state.t, "live_rows": live, "device_ms": ms}
                return out
            return timed

        def step(*args, **kwargs):
            self.steps += 1
            return self._step(*args, **kwargs)

        cb.admit, cb.roll_window, cb.decode_stage = admit, roll, stage
        gen._window_body, llama.decode_step = window_body, step
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self._cb, name, fn)
        gen._window_body, llama.decode_step = self._body, self._step


def continuous_launches(cfg, mode: str, admits: int, steps: int) -> dict:
    """What the scheduler's run in ``mode`` must launch: per admission one
    prefill (each block once a layer; the bf16 blocks, in their kv_quant
    mode for the attention with an int8 cache) and per decode step a
    decode attention a layer (#2, or #3 with an int8 cache, each with its
    start); fp32 none."""
    want = {name: 0 for name in KERNELS}
    if mode == "fp32":
        return want
    L = cfg.decoder.num_layers
    attn, decode = ("attn_block_kv_quant", "decode_attention_int8") if mode == "int8_cache" else (
        "attn_block", "decode_attention")
    want[attn] = want["mlp_block"] = L * admits
    want[decode] = L * steps
    return want


def hold_continuous(mode: str, wrapper, cfg, prefixes) -> dict:
    """Ten requests through the scheduler at full width (4 slots, a 64-step
    window, W = 8): every request finishes with its budget, the window
    rolls and resets, each kernel launched as ``continuous_launches`` says
    (counts set to 0 just before the run, read just after); each row against
    its solo ``generate`` (B=1, the same cache) on the card: fp32 rows
    equal, or their first difference at a near-tie of the solo logits;
    bf16 and int8 agreement printed. The device time of a window's decode
    step at the slots' width, and each admission's and roll's device
    time, are printed."""
    from mellow_tpu_torch.models import continuous as cb

    _, cache = CONTINUOUS_MODES[mode]
    dec = wrapper.params["decoder"]
    sched = cb.ContinuousScheduler(dec, cfg.decoder, slots=CONTINUOUS_SLOTS, prefix_len=cfg.prefix_length,
                                   horizon=CONTINUOUS_HORIZON, cache_dtype=cache, dtype=wrapper.dtype,
                                   stop_token_id=-1, W=CONTINUOUS_W, device="cuda")
    rids = [sched.submit(prefixes[i], b) for i, b in enumerate(CONTINUOUS_BUDGETS)]
    t = time.perf_counter()
    with ContinuousRecorder() as rec:
        zero_counts()
        got = sched.run_to_completion()
        launches = read_counts()
    wall = time.perf_counter() - t
    if sorted(got) != sorted(rids) or [len(got[r]) for r in rids] != list(CONTINUOUS_BUDGETS):
        raise RuntimeError(f"continuous {mode}: requests unfinished or cut: "
                           f"{ {r: len(got.get(r, [])) for r in rids} }")
    if sched.rolls < 1 or sched.resets < 1:
        raise RuntimeError(f"continuous {mode}: {sched.rolls} rolls, {sched.resets} resets; the budgets must force both")
    want = continuous_launches(cfg, mode, len(rec.admits), rec.steps)
    if launches != want:
        raise RuntimeError(f"continuous {mode}: launched {launches}, expected {want}")

    same, total, ties = 0, 0, []
    for i, (rid, budget) in enumerate(zip(rids, CONTINUOUS_BUDGETS)):
        with StepRecorder() as steps:
            solo = gen.generate(dec, cfg.decoder, prefixes[i : i + 1], max_len=budget, stop_token_id=-1,
                                flush_window=CONTINUOUS_W, kv_cache_dtype=cache).tokens[0, :budget].tolist()
        row = got[rid]
        same += sum(a == b for a, b in zip(row, solo))
        total += budget
        if row != solo:
            j = next(j for j, (a, b) in enumerate(zip(row, solo)) if a != b)
            top2 = steps.steps[j][0][0].topk(2).values
            gap = (top2[0] - top2[1]).item()
            ties.append({"request": i, "step": j, "solo_top2_gap": gap})
            if mode == "fp32" and gap > NEAR_TIE:
                raise RuntimeError(f"continuous fp32: request {i} leaves its solo run at step {j}, where the "
                                   f"solo top two logits are {gap:.3e} apart (> {NEAR_TIE})")
    step_ms = rec.window["device_ms"] / rec.window["steps"]
    out = {"mode": mode, "requests": len(rids), "rolls": sched.rolls, "resets": sched.resets, "clock": sched.clock,
           "decode_steps": rec.steps, "admits": len(rec.admits), "launches": launches, "wall_s": wall,
           "solo_agreement": [same, total], "first_differences": ties, "window": rec.window,
           "stage_device_ms_per_decode_step": step_ms, "stages": rec.stages, "admit_device_ms": rec.admits,
           "roll_window_device_ms": rec.rolls}
    print(json.dumps({"continuous": out}))
    print(f"continuous {mode}: {len(rids)} requests, {sched.rolls} rolls, {sched.resets} resets, clock {sched.clock}, "
          f"{rec.steps} decode steps; tokens equal to the solo runs {same}/{total}"
          + "".join(f"; request {d['request']} leaves its solo run at step {d['step']} (solo top-two gap "
                    f"{d['solo_top2_gap']:.3e})" for d in ties)
          + f"; a stage's device time {step_ms:.3f} ms a decode step ({rec.window['live_rows']} live rows); admit "
          + ", ".join(f"{c['device_ms']:.3f} ({c['rows']} rows)" for c in rec.admits) + " ms; roll_window "
          + ", ".join(f"{c['device_ms']:.4f}" for c in rec.rolls) + " ms (device time)")
    return out


def hold_continuous_engine(wrapper, cfg, requests) -> dict:
    """``ContinuousBatchingEngine`` on the bf16 path with per-request knobs:
    greedy and sampled requests on the smoke's wavs, and one with a missing
    wav, which fails alone (FileNotFoundError) while the others answer; the
    path's kernels launched (counts set to 0 just before); the greedy
    answers' agreement with ``wrapper.generate`` printed (the cache's
    columns and the kernels' splits differ, so bf16 bits may move)."""
    from mellow_tpu_torch.serving import ContinuousBatchingEngine

    engine = ContinuousBatchingEngine(wrapper, slots=CONTINUOUS_SLOTS, horizon=CONTINUOUS_HORIZON,
                                      flush_window=CONTINUOUS_W, per_request=True, seed=SEED)
    jobs = [(requests[i % len(requests)], n, i % 2 == 1) for i, n in enumerate((24, 8, 32, 16, 12, 40))]
    try:
        zero_counts()
        t = time.perf_counter()
        bad = engine.submit(requests[0][0], os.path.join(os.path.dirname(requests[0][0]), "missing.wav"),
                            requests[0][2], max_len=8)
        futures = [engine.submit(*req, max_len=n, sample=sampled, **(SAMPLE_KNOBS if sampled else {}))
                   for req, n, sampled in jobs]
        answers = [f.result(timeout=600) for f in futures]
        wall = time.perf_counter() - t
        err = bad.exception(timeout=60)
        if err is None or "missing.wav" not in str(err):
            raise RuntimeError(f"continuous engine: the request with a missing wav gave {err!r}")
        launches = read_counts()
    finally:
        engine.shutdown()
    if any(len(a) > n for a, (_, n, _) in zip(answers, jobs)):
        raise RuntimeError("continuous engine: an answer outgrew its max_len")
    must = ("log_mel", "swin_block", "attn_block", "mlp_block", "decode_attention")
    missing = [k for k in must if not launches[k]]
    if missing:
        raise RuntimeError(f"continuous engine: kernels never launched: {missing}")
    greedy = [(a, wrapper.generate([req], max_len=n)[0]) for a, (req, n, sampled) in zip(answers, jobs)
              if not sampled]
    agree = sum(x == y for a, b in greedy for x, y in zip(a, b))
    out = {"requests": len(jobs) + 1, "wall_s": wall, "launches": launches, "missing_wav_error": repr(err),
           "greedy_agreement_with_generate": [agree, sum(len(b) for _, b in greedy)],
           "answer_lengths": [len(a) for a in answers]}
    print(json.dumps({"continuous_engine": out}))
    return out


def hold_checkpoint(params_np, wrapper, request) -> dict:
    """The v0 random weights through the port's ``export_mellow`` into a .pt
    and back through ``MellowWrapper(params_path=...)``: parameters bit-equal
    to the wrapper's given ``params=``, and the same greedy answer."""
    from mellow_tpu_torch.tools.export_ckpt import export_mellow

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "v0.pt")
        torch.save({k: torch.from_numpy(v) for k, v in export_mellow(params_np).items()}, path)
        size = os.path.getsize(path)
        loaded = MellowWrapper(config=wrapper.cfg.name, model="v0", device="cuda", params_path=path,
                               tokenizer=wrapper.tokenizer)
    ours, theirs = list(_leaves(loaded.params)), list(_leaves(wrapper.params))
    if len(ours) != len(theirs) or not all(torch.equal(a, b) for a, b in zip(ours, theirs)):
        raise RuntimeError("checkpoint: the .pt round trip moved a parameter")
    if loaded.generate([request], max_len=MAX_LEN) != wrapper.generate([request], max_len=MAX_LEN):
        raise RuntimeError("checkpoint: the loaded weights answer otherwise")
    out = {"bytes": size, "tensors": len(ours), "seconds": time.perf_counter() - t}
    print(json.dumps({"checkpoint_round_trip": out}))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def continuous_phase(wrappers, cfg, params_np, wavs) -> dict:
    """The scheduler in fp32, bf16 and bf16 with an int8 cache on prefixes
    the v0 wrappers encode from the smoke's wavs, the engine, and the
    checkpoint round trip."""
    t = time.perf_counter()
    a, b = wavs
    prompts = ("caption the audio.", "what is different between the two clips?", "is there speech?",
               "describe the second clip.", "count the sounds.")
    examples = [[(a, b), (b, a), (a, a), (b, b)][i % 4] + (prompts[i % 5],) for i in range(len(CONTINUOUS_BUDGETS))]
    out = {}
    for mode, (path, _) in CONTINUOUS_MODES.items():
        w = wrappers[path]
        audio1 = w.preprocess_audio([e[0] for e in examples], True, 0)
        audio2 = w.preprocess_audio([e[1] for e in examples], True, 0)
        text = w.preprocess_text([e[2] for e in examples])
        prefixes = encode_and_prefix(w.params, cfg, *w._device_inputs(audio1, audio2, text))
        out[mode] = hold_continuous(mode, w, cfg, prefixes)
    out["engine"] = hold_continuous_engine(wrappers["bf16"], cfg, [list(e) for e in examples[:3]])
    out["checkpoint"] = hold_checkpoint(params_np, wrappers["fp32"], list(examples[0]))
    out["seconds"] = time.perf_counter() - t
    print(f"continuous phase took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# training phase
# ---------------------------------------------------------------------------

# Six steps on one batch (the loss must fall), at a learning rate past its
# warmup from update 1 (update 0's rate is 0, as optax's schedule gives).
TRAIN_LR = 1e-3
# Gradient accumulation and remat against the plain step, from one state:
# the loss within TRAIN_LOSS_RTOL relative, and each parameter after the
# step within TRAIN_PARAM_TOL x the learning rate of the plain step's (the
# same gradients in another summation order move an Adam update by a
# small share of its step).
TRAIN_LOSS_RTOL = 1e-5
TRAIN_PARAM_TOL = 1e-2
# Four answers of one length: every micro-batch has the same answer tokens,
# so accumulation's equal-micro-batch average is the whole batch's gradient.
TRAIN_ROWS = (("caption the audio.", "a busy street, honks"), ("what is different?", "rain on the tin roof"),
              ("is there speech?", "yes, two people talk"), ("count the sounds.", "three sounds, a bell"))
TRAIN_ANSWER_LEN = 16


class ForwardCounter:
    """Counts ``mellow.forward_train`` calls (``train/step.py`` looks the
    function up at call time): each must launch the log-mel kernel twice."""

    def __init__(self):
        self.calls = 0
        self.fn = mellow_model.forward_train
        mellow_model.forward_train = self

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)

    def remove(self):
        mellow_model.forward_train = self.fn


def _train_launches(label, fn, forwards: int, total: dict):
    """Run ``fn`` with every count set to 0 first; it must launch the
    log-mel kernel twice a forward pass and no other kernel. Adds the
    launches to ``total``."""
    zero_counts()
    out = fn()
    torch.cuda.synchronize()
    got = read_counts()
    want = {name: 2 * forwards if name == "log_mel" else 0 for name in KERNELS}
    if got != want:
        raise RuntimeError(f"training {label}: launched {got}, expected {want}")
    for name, n in got.items():
        total[name] = total.get(name, 0) + n
    return out


def _max_param_diff(a, b) -> float:
    from mellow_tpu_torch.models.params import tree_leaves

    return max((x.detach() - y.detach()).abs().max().item() for x, y in zip(tree_leaves(a), tree_leaves(b)))


def training_phase(wrappers, cfg, wavs, tmp, card) -> dict:
    """v0 at full width in fp32 from the seed-0 weights: the port's
    ``ReasonAQALoader`` over a 4-row manifest of the smoke's wavs, six
    ``train_step``s on one batch (losses finite and falling), one mixup
    step, ``train_step_accum(2)`` and remat against the plain step, the
    checkpoint round trip and ``loop.train`` resuming from it; each
    forward pass launches the log-mel kernel twice and nothing else, while
    a bf16 request of the same phase launches the Swin-block kernel (the
    route is by mode); one bf16 ``forward_train`` and backward; a step's
    device and host time, answer tokens/s and peak memory."""
    from mellow_tpu_torch.models.params import cast_floating, tree_leaves, tree_map
    from mellow_tpu_torch.train import checkpoint, loop
    from mellow_tpu_torch.train import step as tstep
    from mellow_tpu_torch.train.data import ReasonAQALoader, load_json

    t0 = time.perf_counter()
    a, b = wavs
    manifest = os.path.join(tmp, "train.json")
    with open(manifest, "w") as f:
        json.dump([{"filepath1": x, "filepath2": y, "input": q, "answer": ans, "subtype": "smoke"}
                   for (x, y), (q, ans) in zip(((a, b), (b, a), (a, a), (b, b)), TRAIN_ROWS)], f)
    tok = wrappers["fp32"].tokenizer
    loader = ReasonAQALoader(load_json(manifest), tok, cfg, batch_size=4, answer_len=TRAIN_ANSWER_LEN)
    batch = next(loader.epoch(0))
    if (batch["audio1"].shape != (4, cfg.frontend.num_samples)
            or set(batch["answer_mask"].sum(1)) != {float(TRAIN_ANSWER_LEN)}):
        raise RuntimeError(f"training: bad batch {batch['audio1'].shape}, {batch['answer_mask'].sum(1)}")
    opt = tstep.make_optimizer(learning_rate=TRAIN_LR, warmup_steps=1, total_steps=100)
    fp32, dev = wrappers["fp32"].params, wrappers["fp32"].device
    state = tstep.init_train_state(tree_map(lambda p: p.detach().clone(), fp32), opt)
    out = {"card": card}
    total = {}
    counter = ForwardCounter()
    try:
        losses = []
        for i in range(6):
            g = torch.Generator(device=dev)
            g.manual_seed(SEED + i)
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = _train_launches(f"step {i}", lambda: tstep.train_step(state, cfg, opt, batch, g), 1, total)
            host_ms = (time.perf_counter() - t) * 1e3
            losses.append(float(m["loss"]))
            print(json.dumps({"train_step": i, "loss": losses[-1], "grad_norm": float(m["grad_norm"]),
                              "host_ms": host_ms, "max_memory_allocated": torch.cuda.max_memory_allocated()}))
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise RuntimeError(f"training: the loss did not fall over six steps: {losses}")
        out["losses"] = losses
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 6)
        state, m = _train_launches("mixup", lambda: tstep.train_step(state, cfg, opt, batch, g, mixup=True), 1,
                                  total)
        out["mixup_loss"] = float(m["loss"])
        # The mixed pairs' token weights sum to each pair's tokens: half the batch's.
        if not np.isfinite(out["mixup_loss"]) or abs(float(m["num_answer_tokens"]) - 2 * TRAIN_ANSWER_LEN) > 1e-3:
            raise RuntimeError(f"training: bad mixup step {m}")

        # Accumulation and remat against the plain step, from copies of one state.
        ref, m_ref = tstep.train_step(tstep.clone_state(state), cfg, opt, batch, None)
        lr = opt.schedule(state.opt_state.count)
        for label, fn, forwards in (
                ("accum", lambda: tstep.train_step_accum(tstep.clone_state(state), cfg, opt, batch, None, 2), 2),
                ("remat", lambda: tstep.train_step(tstep.clone_state(state), cfg, opt, batch, None, remat=True), 1)):
            other, m_other = _train_launches(label, fn, forwards, total)
            loss_err = abs(float(m_other["loss"]) - float(m_ref["loss"])) / abs(float(m_ref["loss"]))
            param_err = _max_param_diff(other.params, ref.params)
            out[label] = {"loss_rel_err": loss_err, "max_param_diff": param_err, "lr": lr}
            print(json.dumps({f"train_{label}_vs_plain": out[label], "card": card}))
            if loss_err > TRAIN_LOSS_RTOL or param_err > TRAIN_PARAM_TOL * lr:
                raise RuntimeError(f"training: {label} is off the plain step: {out[label]}")
        del ref, other

        # A step's device time (torch.profiler), host time and peak memory.
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 7)
        torch.cuda.reset_peak_memory_stats()
        (state, m), device_ms = _device_ms(lambda: tstep.train_step(state, cfg, opt, batch, g))
        g.manual_seed(SEED + 8)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = tstep.train_step(state, cfg, opt, batch, g)
        float(m["loss"])
        host_ms = (time.perf_counter() - t) * 1e3
        out["step"] = {"device_ms": device_ms, "host_ms": host_ms,
                       "answer_tokens_per_s": float(m["num_answer_tokens"]) / (host_ms / 1e3),
                       "max_memory_allocated": torch.cuda.max_memory_allocated(), "batch": 4,
                       "answer_len": 16}
        print(json.dumps({"train_step_v0_fp32_B4": out["step"], "card": card}))

        # Checkpoint: bit for bit, then the loop resumes from it.
        ckpt_dir = os.path.join(tmp, "ckpt")
        t = time.perf_counter()
        path = checkpoint.save(ckpt_dir, state)
        back = checkpoint.restore(path, state)
        pairs = [(state.params, back.params), (state.opt_state.mu, back.opt_state.mu),
                 (state.opt_state.nu, back.opt_state.nu)]
        if back.step != state.step or not all(torch.equal(x, y) for ta, tb in pairs
                                              for x, y in zip(tree_leaves(ta), tree_leaves(tb))):
            raise RuntimeError("training: the checkpoint round trip moved a value")
        del back
        resumed = _train_launches("loop", lambda: loop.train(fp32, cfg, loader, max_steps=state.step + 1,
                                                            ckpt_dir=ckpt_dir, log_every=1), 1, total)
        if resumed.step != state.step + 1:
            raise RuntimeError(f"training: loop.train ended at step {resumed.step}, not {state.step + 1}")
        out["checkpoint"] = {"bytes": os.path.getsize(path), "step": state.step, "resumed_to": resumed.step,
                             "seconds": time.perf_counter() - t}
        print(json.dumps({"train_checkpoint": out["checkpoint"]}))
        del resumed
    finally:
        counter.remove()
    # 6 steps, mixup, the plain, accumulated (2) and remat comparison steps,
    # the two timed steps and the loop's step.
    if counter.calls != 14:
        raise RuntimeError(f"training: {counter.calls} forward passes, expected 14")

    # The same phase's bf16 request takes the Swin-block kernel.
    zero_counts()
    wrappers["bf16"].generate([[a, b, "caption the audio."]], max_len=4)
    swin = read_counts()["swin_block"]
    if not swin:
        raise RuntimeError("training: a bf16 request of the phase launched no Swin-block kernel")
    out["bf16_request_swin_block_launches"] = swin

    # One bf16 forward_train + backward, against fp32's loss at the seed weights.
    p32 = tstep.init_train_state(tree_map(lambda p: p.detach().clone(), fp32), opt).params
    p16 = tree_map(lambda p: p.requires_grad_(True), cast_floating(tree_map(lambda p: p.detach().clone(), fp32),
                                                                   torch.bfloat16))
    losses = {}
    for label, params in (("fp32", p32), ("bf16", p16)):
        dev = tstep._device_batch(batch, params)

        def fwd_bwd():
            loss, _ = mellow_model.forward_train(params, cfg, dev["audio1"], dev["audio2"], dev["text_ids"],
                                                 dev["answer_ids"], dev["answer_mask"])
            grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)
            return loss, grads

        loss, grads = _train_launches(f"{label} forward_train", fwd_bwd, 1, total)
        if not torch.isfinite(loss) or not all(gr is None or torch.isfinite(gr).all() for gr in grads):
            raise RuntimeError(f"training: {label} forward_train or its gradients are not finite")
        losses[label] = loss.item()
    out["bf16_loss"] = losses
    out["bf16_loss_rel_diff"] = abs(losses["bf16"] - losses["fp32"]) / abs(losses["fp32"])
    del p32, p16, params
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"training": {k: v for k, v in out.items() if k not in ("card", "launches")}, "card": card}))
    print(f"training phase took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# entry phase
# ---------------------------------------------------------------------------

def _http_json(url, body=None):
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def entry_phase(wrappers, cfg, wavs, tmp, card) -> dict:
    """``cli.build_wrapper("v0")`` with no weights reachable (the seed-0
    random weights, on the card); a bf16 v0 ``MellowServer`` on loopback:
    three concurrent ``/generate`` POSTs coalesced into one batch (answers
    equal to ``wrapper.generate``'s, ``/metrics`` showing one call of six
    clips), one SSE stream (its text equal to the one-shot answer); and
    ``run_eval`` on a 4-row manifest."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from mellow_tpu_torch import cli
    from mellow_tpu_torch import eval as ev
    from mellow_tpu_torch.models.params import tree_leaves
    from mellow_tpu_torch.server import MellowServer

    t0 = time.perf_counter()
    a, b = wavs
    out = {}
    for name in ("MELLOW_TPU_PARAMS", "MELLOW_TPU_CKPT"):
        os.environ.pop(name, None)
    fallback = cli.build_wrapper("v0")
    if fallback.device != wrappers["fp32"].device or not isinstance(fallback.tokenizer, ByteTokenizer) or not all(
            torch.equal(x, y) for x, y in zip(tree_leaves(fallback.params), tree_leaves(wrappers["fp32"].params))):
        raise RuntimeError("entry: build_wrapper's fallback is not the seed-0 random weights on the card")
    del fallback

    w = wrappers["bf16"]
    bodies = [{"audio1": x, "audio2": y, "prompt": q, "max_len": MAX_LEN}
              for x, y, q in ((a, b, "caption the audio."), (b, a, "what is different?"), (a, a, "is there speech?"))]
    srv = MellowServer(w, max_batch_size=3, max_wait_ms=600_000)
    httpd = srv.make_http_server("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        if _http_json(url + "/healthz") != {"status": "ok"}:
            raise RuntimeError("entry: /healthz")
        before = _http_json(url + "/metrics")
        zero_counts()
        t = time.perf_counter()
        with ThreadPoolExecutor(max_workers=3) as pool:
            answers = [r["text"] for r in pool.map(lambda body: _http_json(url + "/generate", body), bodies)]
        out["three_posts_s"] = time.perf_counter() - t
        out["launches"] = read_counts()
        after = _http_json(url + "/metrics")
        calls = after["generate_calls"] - before.get("generate_calls", 0)
        clips = after["clips"] - before.get("clips", 0)
        direct = w.generate([[x["audio1"], x["audio2"], x["prompt"]] for x in bodies], max_len=MAX_LEN,
                            dynamic_batch=True)
        if answers != direct or (calls, clips) != (1, 6):
            raise RuntimeError(f"entry: the server answered {answers} in {calls} calls of {clips} clips, "
                               f"the wrapper {direct}")
        req = urllib.request.Request(url + "/generate_stream", data=json.dumps(bodies[0]).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            events = [json.loads(line[6:]) for line in (r.decode().strip() for r in resp) if line.startswith("data: ")]
        # The one-shot answer from the wrapper: the server's engine holds a
        # lone request back while it waits for a batch of 3.
        one_shot = w.generate([[bodies[0]["audio1"], bodies[0]["audio2"], bodies[0]["prompt"]]], max_len=MAX_LEN)[0]
        if not events or not events[-1]["done"] or events[-1]["text"] != one_shot:
            raise RuntimeError(f"entry: the stream's text {events[-1:]} is not the one-shot answer {one_shot!r}")
        out["stream_events"] = len(events)
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.shutdown()
        thread.join(timeout=60)

    manifest = os.path.join(tmp, "eval.json")
    with open(manifest, "w") as f:
        json.dump([{"filepath1": x, "filepath2": y, "input": q, "answer": ans, "subtype": sub}
                   for (x, y), (q, ans), sub in zip(((a, b), (b, a), (a, a), (b, b)), TRAIN_ROWS,
                                                    ("AudioCaps.json", "ClothoAQA-binary.json") * 2)], f)
    reports, preds = ev.run_eval(w, ev.load_manifest(manifest), batch_size=4, max_len=MAX_LEN)
    print(ev.format_report(reports))
    if len(preds) != 4 or reports["OVERALL"].n != 4:
        raise RuntimeError("entry: run_eval did not score the four rows")
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"entry": out, "card": card}))
    print(f"entry phase took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# parallel phase
# ---------------------------------------------------------------------------

# The TP forms at tp=1 against the plain layer: every collective of a
# one-rank group returns its input, so the two agree bit for bit.
PARALLEL_LAYER_ROWS = (2, 16)  # (B, S) of the layer's input
# The mesh's training steps against the unsharded ones: the same draws
# (data index 0 draws the unsharded stream), the grad norm summed in
# another order.
PARALLEL_LOSS_RTOL = 1e-6


def hold_tp_layer(cfg, mesh) -> dict:
    """One full-width decoder layer (attention, then MLP) of ``cfg`` in
    ``parallel/tensor.py``'s TP forms at tp=1 through the mesh's NCCL model
    group, against the plain layer, forward and backward: bit for bit."""
    from mellow_tpu_torch.parallel import tensor as tpar

    tp = tpar.tp_of(mesh, cfg.num_kv_heads)
    if tp.size != 1 or not tp.heads:
        raise RuntimeError(f"parallel: expected a model group of 1 with its heads sharded, got {tp}")
    rng = np.random.default_rng(SEED)

    def w(*shape, scale=0.05):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).cuda()

    D, I, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    H, KV = cfg.num_heads * hd, cfg.num_kv_heads * hd
    lp = {"ln_attn": 1 + w(D, scale=0.1), "ln_mlp": 1 + w(D, scale=0.1), "wq": w(D, H), "wk": w(D, KV),
          "wv": w(D, KV), "wo": w(H, D), "w_gate": w(D, I), "w_up": w(D, I), "w_down": w(I, D)}
    lp = {k: v.requires_grad_(True) for k, v in lp.items()}
    B, S = PARALLEL_LAYER_ROWS
    x = w(B, S, D, scale=1.0)
    cos, sin = llama.rope_device_tables(cfg, S, torch.float32, x.device)
    mask = torch.zeros((S, S), device=x.device).masked_fill(
        ~torch.ones((S, S), dtype=torch.bool, device=x.device).tril(), float("-inf"))

    def plain():
        q, k, v = llama._qkv(cfg, x, lp, cos, sin)
        return llama._mlp(cfg, x + llama._mm(llama._attend(cfg, q, k, v, mask), lp["wo"]), lp)

    def sharded():
        lcfg = tpar.local_config(cfg, tp)
        q, k, v = tpar.qkv(lcfg, x, lp, cos, sin, tp)
        return tpar.mlp(lcfg, x + tpar.attn_out(llama._attend(lcfg, q, k, v, mask), lp["wo"], tp), lp, tp)

    outs = []
    for fn in (plain, sharded):
        y = fn()
        grads = torch.autograd.grad((y.float() ** 2).mean(), list(lp.values()))
        outs.append((y.detach(), grads))
    torch.cuda.synchronize()
    out = {"shape": list(outs[0][0].shape), "max_abs_err": (outs[0][0] - outs[1][0]).abs().max().item(),
           "max_grad_err": max((a - b).abs().max().item() for a, b in zip(outs[0][1], outs[1][1]))}
    if out["max_abs_err"] or out["max_grad_err"]:
        raise RuntimeError(f"parallel: the TP layer at tp=1 differs from the plain layer: {out}")
    return out


class _LossRecorder:
    """Keeps the loss of every ``train_step_accum`` (``train/loop.py`` looks
    the function up at call time)."""

    def __init__(self):
        from mellow_tpu_torch.train import step as tstep

        self.mod, self.fn, self.losses = tstep, tstep.train_step_accum, []
        tstep.train_step_accum = self

    def __call__(self, *args, **kwargs):
        state, m = self.fn(*args, **kwargs)
        self.losses.append(float(m["loss"]))
        return state, m

    def remove(self):
        self.mod.train_step_accum = self.fn


def parallel_phase(wrappers, cfgs, params_np, requests, answers, tmp, card, ckpt_bytes: int) -> dict:
    """The mesh path on the one card: a one-rank NCCL group; ``make_mesh()``
    as (1, 1); the v0 bf16 wrapper on that mesh (``mellow.
    generate_tokens_sharded``, every kernel of the bf16 path) answering the
    bf16 path's requests as the plain bf16 wrapper did, each call launching
    what ``expected_launches`` says; one v0 decoder layer in the TP forms;
    ``loop.train(mesh=)`` two steps of v0 in fp32 (B=4) against the same
    steps without the mesh, rank 0 writing the checkpoint (the full trees:
    the unsharded checkpoint's bytes). Raises on any failure; the group is
    destroyed at the end."""
    import torch.distributed as dist

    from mellow_tpu_torch.parallel import multihost, sharding
    from mellow_tpu_torch.parallel.dryrun import free_port
    from mellow_tpu_torch.train import loop
    from mellow_tpu_torch.train.data import ReasonAQALoader, load_json

    t0 = time.perf_counter()
    out = {"card": card}
    info = multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, timeout=120.0)
    try:
        out["backend"] = dist.get_backend()
        if out["backend"] != "nccl" or info["process_count"] != 1:
            raise RuntimeError(f"parallel: expected a one-rank NCCL group, got {out['backend']}, {info}")
        mesh = sharding.make_mesh()
        out["mesh"] = sharding.axis_sizes(mesh)
        if out["mesh"] != {"data": 1, "model": 1} or mesh.device_type != "cuda":
            raise RuntimeError(f"parallel: make_mesh() gave {out['mesh']} on {mesh.device_type}")

        cfg = cfgs["v0"]
        ctor = PATHS["bf16"][1]
        w = MellowWrapper(config=cfg.name, model="v0", device="cuda", params=params_np,
                          tokenizer=wrappers["bf16"].tokenizer, mesh=mesh, **ctor)
        t = time.perf_counter()
        singles, launches, calls = drive(w, cfg, requests, "bf16", "batch")
        out["mesh_dp"] = {"seconds": time.perf_counter() - t, "generate_calls": calls, "launches": launches}
        if singles != answers["bf16"]:
            raise RuntimeError(f"parallel: the mesh wrapper answered {singles}, the bf16 wrapper {answers['bf16']}")
        del w

        out["tp_layer"] = hold_tp_layer(cfg.decoder, mesh)
        print(json.dumps({"parallel_tp_layer": out["tp_layer"], "card": card}))

        fp32 = wrappers["fp32"].params
        # The training phase's manifest of the smoke's wavs (train.json).
        loader = ReasonAQALoader(load_json(os.path.join(tmp, "train.json")), wrappers["fp32"].tokenizer, cfg,
                                 batch_size=4, answer_len=TRAIN_ANSWER_LEN)
        runs = {}
        total = {}
        for label, kw in (("plain", {}), ("mesh", {"mesh": mesh, "ckpt_dir": os.path.join(tmp, "mesh_ckpt"),
                                                   "ckpt_every": 2})):
            rec = _LossRecorder()
            try:
                state = _train_launches(f"parallel {label}", lambda: loop.train(
                    fp32, cfg, loader, num_epochs=3, max_steps=2, log_every=1, **kw), 2, total)
            finally:
                rec.remove()
            runs[label] = rec.losses
            del state
        errs = [abs(a - b) / abs(b) for a, b in zip(runs["mesh"], runs["plain"])]
        path = os.path.join(tmp, "mesh_ckpt", "step_2.pt")
        out["train"] = {"losses": runs, "loss_rel_err": errs, "checkpoint_bytes": os.path.getsize(path)}
        print(json.dumps({"parallel_train": out["train"], "card": card}))
        if len(errs) != 2 or max(errs) > PARALLEL_LOSS_RTOL:
            raise RuntimeError(f"parallel: the mesh's losses are off the unsharded ones: {runs}")
        if out["train"]["checkpoint_bytes"] != ckpt_bytes:
            raise RuntimeError(f"parallel: the mesh's checkpoint has {out['train']['checkpoint_bytes']} bytes, "
                               f"the unsharded one {ckpt_bytes}")
        out["train_launches"] = total
    finally:
        multihost.shutdown()
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"parallel": {k: v for k, v in out.items() if k != "card"}, "card": card}))
    print(f"parallel phase took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# utils phase: the entry module, trace(), the tripwires, an installed copy
# ---------------------------------------------------------------------------

# The bf16 path's kernels in a Chrome trace: name -> the PROFILED_KERNELS
# labels of the CUDA symbols each launches.
TRACE_KERNELS = {"log_mel": ("log_mel",), "swin_block": ("swin_block",), "mlp_block": ("mlp_block",),
                 "attn_block": ("attn_qkv_projection", "prefill_attention_core", "attn_o_projection"),
                 "decode_attention": ("decode_attention",)}
TRACE_MAX_LEN = 8

# Run in a fresh interpreter beside an installed copy of the port (argv: the
# copy's directory, the cache directory): build the kernels, #1 on a 10 s
# clip against its plain version, the native audio library; one JSON line.
INSTALLED_CHECK = r"""
import json, os, sys, time
import torch
import mellow_tpu_torch
from mellow_tpu_torch.config import get_config
from mellow_tpu_torch.native import binding
from mellow_tpu_torch.ops import _build, frontend, melspec

site, cache = sys.argv[1], sys.argv[2]
if not mellow_tpu_torch.__file__.startswith(site + os.sep):
    raise SystemExit(f"imported {mellow_tpu_torch.__file__}, not the copy in {site}")
t = time.perf_counter()
lib = _build.build()
build_s = time.perf_counter() - t
if lib != os.path.join(cache, "mellow_tpu_torch", "libmellow_kernels.so") or not os.path.exists(lib):
    raise SystemExit(f"the kernel library is at {lib}, not under {cache}")
cfg = get_config("v0").frontend
gen = torch.Generator(device="cuda").manual_seed(0)
wave = torch.randn((1, cfg.num_samples), generator=gen, device="cuda") * 0.1
out = melspec.log_mel_cuda(wave, cfg)
ref = frontend.log_mel_spectrogram(wave, cfg)
torch.testing.assert_close(out, ref, atol=float(sys.argv[3]), rtol=float(sys.argv[4]))
native = binding.available()
if not native or not binding._LIB_PATH.startswith(os.path.join(cache, "mellow_tpu_torch") + os.sep):
    raise SystemExit(f"the native audio library is not built under {cache}: {binding._LIB_PATH}")
print(json.dumps({"package": mellow_tpu_torch.__file__, "library": lib, "build_s": build_s,
                  "log_mel_max_abs_err": (out - ref).abs().max().item(), "log_mel_launches": melspec.LAUNCHES,
                  "native_audio": binding._LIB_PATH}))
"""


def hold_entry(card: str) -> dict:
    """``entry.entry()``'s ``fn`` on the card at full v0 width: finite
    logits, within BF16_TOL's logits limit of the same forward in fp32 (the
    weights and clips cast), launching #1 twice and #8 in each of stages
    1-3's 20 blocks and nothing else; its device time."""
    from mellow_tpu_torch import entry
    from mellow_tpu_torch.models.params import cast_floating

    fn, args = entry.entry("cuda")
    cfg = get_config("v0")
    zero_counts()
    with torch.no_grad():
        logits = fn(*args)
    torch.cuda.synchronize()
    launches = read_counts()
    want = encoder_launches(cfg.encoder, 2)
    if launches != want:
        raise RuntimeError(f"entry: fn launched {launches}, expected {want}")
    if logits.shape != (1, cfg.prefix_length + entry.ANSWER_LEN, cfg.decoder.vocab_size) or \
            not torch.isfinite(logits).all():
        raise RuntimeError(f"entry: logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    p32 = cast_floating(args[0], torch.float32)
    with torch.no_grad():
        ref = fn(p32, args[1].float(), args[2].float(), args[3], args[4])
    del p32
    err = (logits.float() - ref).abs().max().item() / ref.abs().max().item()
    _, device_ms = _device_ms(lambda: fn(*args))
    host_ms = _host_ms(lambda: fn(*args))
    out = {"launches": launches, "logits_rel_err": err, "limit": BF16_TOL[1], "device_ms": device_ms,
           "host_ms": host_ms, "card": card}
    print(json.dumps({"entry_forward": out}))
    if err > BF16_TOL[1]:
        raise RuntimeError(f"entry: bf16 logits {err:.3g} x max|fp32| off the fp32 forward's")
    return out


def hold_trace(wrapper, cfg, request, tmp: str) -> dict:
    """One bf16 B=1 request at max_len 8 inside ``profiling.trace(dir)``: one
    Chrome trace, JSON, whose kernel events hold each of the bf16 path's
    kernels' launches (the wrapper's count times its kernels a call) less
    at most one (the profiler misses the first launch after it starts); a
    request outside ``trace()`` writes no file."""
    trace_dir = os.path.join(tmp, "traces")
    rec = CallRecorder(wrapper)
    try:
        with profiling.trace(trace_dir):
            wrapper.generate([request], max_len=TRACE_MAX_LEN)
        wrapper.generate([request], max_len=TRACE_MAX_LEN)
    finally:
        rec.remove()
    files = os.listdir(trace_dir)
    if len(files) != 1:
        raise RuntimeError(f"trace: {len(files)} files in {trace_dir}, expected 1: {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    call = rec.calls[0]
    want = expected_launches(cfg, call["steps"], "bf16", TRACE_MAX_LEN)
    if call["launches"] != want:
        raise RuntimeError(f"trace: the traced request launched {call['launches']}, expected {want}")
    seen = {}
    for name, labels in TRACE_KERNELS.items():
        syms = [sym for label in labels for sym in PROFILED_KERNELS[label]]
        seen[name] = sum(any(sym in k for sym in syms) for k in kernels)
    expected = {name: want[name] * getattr(KERNELS[name][0], KERNELS[name][2]) for name in TRACE_KERNELS}
    out = {"file_bytes": os.path.getsize(os.path.join(trace_dir, files[0])), "kernel_events": len(kernels),
           "by_kernel": seen, "expected": expected, "steps": call["steps"]}
    print(json.dumps({"trace": out}))
    short = [n for n in TRACE_KERNELS if seen[n] < expected[n] - 1]
    if short:
        raise RuntimeError(f"trace: too few kernel events for {short}: {seen}, expected {expected}")
    return out


def hold_tripwire(wrapper, cfg, request) -> dict:
    """The bf16 wrapper with stage 1's first qkv kernel at +-1e38 (bf16):
    with ``enable_debug()`` the request raises from #8's wrapper, whose own
    products overflow; after ``disable_debug()`` the same request returns,
    with the bf16 path's launches."""
    qkv = wrapper.params["encoder"]["stages"][0]["blocks"][0]["qkv"]
    kernel = qkv["kernel"]
    qkv["kernel"] = torch.where(kernel < 0, -1e38, 1e38).to(kernel.dtype)
    rec = CallRecorder(wrapper)
    try:
        debug.enable_debug()
        try:
            wrapper.generate([request], max_len=TRACE_MAX_LEN)
            raise RuntimeError("tripwire: the request with an overflowing Swin block returned")
        except FloatingPointError as e:
            raised = str(e)
        finally:
            debug.disable_debug()
        if not raised.startswith("swin_block_cuda:"):
            raise RuntimeError(f"tripwire: raised {raised!r}, not from #8's wrapper")
        wrapper.generate([request], max_len=TRACE_MAX_LEN)
    finally:
        qkv["kernel"] = kernel
        rec.remove()
    call = rec.calls[-1]
    want = expected_launches(cfg, call["steps"], "bf16", TRACE_MAX_LEN)
    if call["launches"] != want:
        raise RuntimeError(f"tripwire: the request after disable_debug launched {call['launches']}, expected {want}")
    out = {"raised": raised, "rerun_launches": call["launches"], "rerun_steps": call["steps"]}
    print(json.dumps({"tripwire": out}))
    return out


def start_installed(tmp: str) -> dict:
    """A wheel of this tree (``pip wheel --no-build-isolation``, from a copy
    of the files setuptools reads), unpacked into ``tmp``; then, in the
    background, ``INSTALLED_CHECK`` in a fresh interpreter outside the
    repository with only the copy on PYTHONPATH and the cache directory in
    ``tmp``. Its nvcc build overlaps the paths phase, which the smoke
    times by nothing it records. Killed at exit if still running."""
    import atexit
    import shutil
    import zipfile

    root = os.path.dirname(os.path.abspath(__file__))
    src, wheels, site, cache = (os.path.join(tmp, d) for d in ("src", "wheels", "site", "cache"))
    skip = shutil.ignore_patterns("__pycache__", "*.so")
    for name in ("mellow_tpu", "mellow_tpu_torch"):
        shutil.copytree(os.path.join(root, name), os.path.join(src, name), ignore=skip)
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(os.path.join(root, name), src)
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pip", "wheel", src, "--no-deps", "--no-build-isolation",
                           "-w", wheels], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"installed: pip wheel failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    (whl,) = [os.path.join(wheels, f) for f in os.listdir(wheels) if f.endswith(".whl")]
    with zipfile.ZipFile(whl) as z:
        z.extractall(site)
    out = {"wheel": os.path.basename(whl), "wheel_s": time.perf_counter() - t, "log": os.path.join(tmp, "check.log")}
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XDG_CACHE_HOME")}
    env.update(PYTHONPATH=site, XDG_CACHE_HOME=cache)
    with open(out["log"], "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", INSTALLED_CHECK, site, cache, str(KERNEL_TOL["atol"]),
                                 str(KERNEL_TOL["rtol"])], cwd=tmp, env=env, stdout=log, stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    out.update(proc=proc, started=time.perf_counter())
    return out


def hold_installed(started: dict) -> dict:
    """Wait for ``start_installed``'s check; its JSON line, the seconds from
    its start to this wait's end (``check_s``) and the seconds this phase
    waited for it."""
    t = time.perf_counter()
    proc, started_at = started.pop("proc"), started.pop("started")
    rc = proc.wait(timeout=600)
    with open(started["log"]) as f:
        log = f.read()
    if rc != 0:
        raise RuntimeError(f"installed: the check failed ({rc}):\n{log}")
    out = {**started, "check_s": time.perf_counter() - started_at, "waited_s": time.perf_counter() - t,
           **json.loads([line for line in log.splitlines() if line.startswith("{")][-1])}
    print(json.dumps({"installed": out}))
    return out


def utils_phase(wrappers, cfg, requests, tmp: str, card: str, installed: dict) -> dict:
    """(a) ``entry()``'s forward (``hold_entry``), (b) ``trace()``
    (``hold_trace``), (c) the tripwires (``hold_tripwire``), (d) an
    installed copy (``start_installed``, ``hold_installed``). Raises on any
    failure."""
    t0 = time.perf_counter()
    out = {"entry": hold_entry(card)}
    out["trace"] = hold_trace(wrappers["bf16"], cfg, requests[0], tmp)
    out["tripwire"] = hold_tripwire(wrappers["bf16"], cfg, requests[0])
    out["installed"] = hold_installed(installed)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"utils": {"seconds": out["seconds"], "card": card}}))
    print(f"utils phase took {out['seconds']:.1f} s")
    return out


def slice_phase(card: str) -> dict:
    """Drive every path; return each path's kernel launches and generate
    calls, the encoder entry points' launches, the stage timings, and the
    training, entry and parallel phases."""
    t0 = time.perf_counter()
    register_config(GPT2_CONFIG, gpt2_config())
    register_config(LARGE_CONFIG, htsat_large_config())
    cfgs = {name: get_config(name) for name in ("v0", GPT2_CONFIG, LARGE_CONFIG)}
    params = {name: init_params(cfg, SEED) for name, cfg in cfgs.items()}
    tok = DistinctTokenizer()
    wrappers = {path: MellowWrapper(config=name, model="v0", device="cuda", params=params[name], tokenizer=tok,
                                    **ctor)
                for path, (name, ctor, _) in PATHS.items()}
    print(f"weights made and loaded ({', '.join(PATHS)}) in {time.perf_counter() - t0:.2f} s")
    timings, launches, answers, calls = {}, {}, {}, {}
    scope = {"int8_weights": "one", "gpt2_int8_weights": "one", "large_fp32": "batch", "large_bf16": "batch"}
    with tempfile.TemporaryDirectory() as tmp:
        installed = start_installed(os.path.join(tmp, "installed"))
        a = _write_wav(os.path.join(tmp, "a.wav"), 7.0, 1)  # repeat-padded
        b = _write_wav(os.path.join(tmp, "b.wav"), 9.5, 2)
        requests = [[a, b, "caption the audio."],
                    [b, a, "what is different between the two clips?"],
                    [a, a, "is there speech?"]]
        for path, w in wrappers.items():
            answers[path], launches[path], calls[path] = drive(w, cfgs[PATHS[path][0]], requests, path,
                                                               scope.get(path, "all"))
        if not _agreement("bf16 vs fp32", answers["bf16"], answers["fp32"]):
            raise RuntimeError("bf16's first greedy token differs from fp32's")
        if not _agreement("HTSAT-large bf16 vs fp32", answers["large_bf16"], answers["large_fp32"]):
            raise RuntimeError("HTSAT-large bf16's first greedy token differs from fp32's")
        _agreement("int8 (W8A8 weights, int8 cache) vs bf16", answers["int8"], answers["bf16"])
        _agreement("int8 weights + int8 cache vs bf16", answers["int8_weights"], answers["bf16"][:1])
        _agreement("gpt2 bf16 vs gpt2 fp32", answers["gpt2_bf16"], answers["gpt2_fp32"])
        _agreement("gpt2 int8 weights vs gpt2 bf16", answers["gpt2_int8_weights"], answers["gpt2_bf16"][:1])
        gpt2_float_cache = hold_gpt2_float_cache(wrappers["gpt2_bf16"], cfgs[GPT2_CONFIG], requests[0])
        print(f"paths took {time.perf_counter() - t0:.1f} s")
        t = time.perf_counter()
        entries = hold_encoder_entries(cfgs[LARGE_CONFIG], wrappers["large_bf16"].params,
                                       wrappers["large_fp32"].params)
        print(f"encoder entry points took {time.perf_counter() - t:.1f} s")
        decoding = decoding_phase(wrappers, cfgs, requests, answers)
        continuous = continuous_phase(wrappers, cfgs["v0"], params["v0"], (a, b))
        training = training_phase(wrappers, cfgs["v0"], (a, b), tmp, card)
        entry = entry_phase(wrappers, cfgs["v0"], (a, b), tmp, card)
        launches["training"], launches["entry_server"] = training["launches"], entry["launches"]
        parallel = parallel_phase(wrappers, cfgs, params["v0"], requests, answers, tmp, card,
                                  training["checkpoint"]["bytes"])
        launches["mesh_dp"] = parallel["mesh_dp"]["launches"]
        utils = utils_phase(wrappers, cfgs["v0"], requests, tmp, card, installed)
        launches["entry_forward"] = utils["entry"]["launches"]

        audio1 = wrappers["fp32"].preprocess_audio([r[0] for r in requests[:2]], True)
        audio2 = wrappers["fp32"].preprocess_audio([r[1] for r in requests[:2]], True)
        texts = {name: wrappers[path].preprocess_text([r[2] for r in requests[:2]])
                 for name, path in (("v0", "fp32"), (GPT2_CONFIG, "gpt2_fp32"), (LARGE_CONFIG, "large_fp32"))}
        t = time.perf_counter()
        for path, batches in (("fp32", (1, 4)), ("bf16", (1, 4)), ("int8", (1, 4)),
                              ("gpt2_fp32", (1,)), ("gpt2_bf16", (1,)), ("large_fp32", (1,)), ("large_bf16", (1,))):
            for batch in batches:
                key = f"{path} B={batch}"
                timings[key] = stage_times(wrappers[path], cfgs[PATHS[path][0]], requests[0], batch, path)
                print(json.dumps({"stage_times": key, **timings[key]}))
        print(f"stage timings took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        for path in ("fp32", "bf16", "int8", "gpt2_fp32", "gpt2_bf16", "large_fp32", "large_bf16"):
            timings[f"profile {path}"] = profile_request(wrappers[path], requests[0], path)
        print(f"request profiles took {time.perf_counter() - t:.1f} s")

    # Two rows (requests 0 and 1), so the batch strides of the prefill
    # blocks' cache writes and of decode attention's cache reads are used.
    t = time.perf_counter()
    for label, name, paths, int8_cache, int8_tol in (
            ("", "v0", ("fp32", "bf16", "int8"), True, INT8_TOL),
            ("gpt2 ", GPT2_CONFIG, ("gpt2_fp32", "gpt2_bf16", "gpt2_int8_weights"), False, GPT2_INT8_TOL),
            ("large ", LARGE_CONFIG, ("large_fp32", "large_bf16"), False, None)):
        hold_family(label, cfgs[name], params[name], [wrappers[p].params for p in paths], paths[-1],
                    (audio1, audio2, texts[name]), int8_cache, int8_tol)
    print(f"family holds took {time.perf_counter() - t:.1f} s")
    return {"launches": launches, "calls": calls, "entries": entries, "timings": timings, "decoding": decoding,
            "continuous": continuous, "training": training, "entry": entry, "parallel": parallel,
            "utils": utils, "gpt2_float_cache": gpt2_float_cache}


# Kernels whose device time per request the profile reports: name -> the
# substrings of their CUDA symbols. The prefill attention core's symbol is
# #10 on the GPT-2 paths and #4/#5's attention stage on the llama paths
# (the only callers of each); rowquant_kernel is #4/#5's kv_quant launch and
# #5's o quantizer. #6's launches are mlp_gate_up/mlp_down, #7's mlp_w8a8_*,
# #8's swin_*; the log-mel's is log_mel_*. Before #7 moved onto
# proj_mma_core.cuh it was two gemm_int8_kernel launches (int8_gemm) between
# a bf16 rowquant_kernel (counted under rowquant) and a fp32 one
# (rowquant_float), as an A/B's parent reads it.
PROFILED_KERNELS = {"log_mel": ("log_mel",), "decode_attention": ("decode_gqa_kernel",),
                    "decode_attention_int8": ("decode_gqa_int8_kernel",),
                    "prefill_attention_core": ("flash_prefill_kernel",), "attn_qkv_projection": ("qkv_proj_",),
                    "attn_o_projection": ("o_proj_",), "rowquant": ("rowquant_kernel",),
                    "rowquant_float": ("rowquant_kernel<float>",), "mlp_block": ("mlp_gate_up", "mlp_down"),
                    "mlp_block_w8a8": ("mlp_w8a8_",), "int8_gemm": ("gemm_int8_kernel",), "swin_block": ("swin_",)}


def profile_request(wrapper, request, path: str) -> dict:
    """One warm B=1 request unprofiled (host clock), then the same request
    under torch.profiler: device time (the sum of kernel times), kernel
    launches, the device's idle share against both walls, the kernels that
    take the most device time, and the totals of ``PROFILED_KERNELS``."""
    from torch.profiler import ProfilerActivity, profile

    gen_kwargs = PATHS[path][2]
    wall_ms = _host_ms(lambda: wrapper.generate([request], max_len=MAX_LEN, **gen_kwargs), reps=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_ms = _host_ms(lambda: wrapper.generate([request], max_len=MAX_LEN, **gen_kwargs), reps=1)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError(f"{path}: the profiler saw no kernel on the device")
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        n, total = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, total + e.time_range.elapsed_us() / 1e3)
    out = {"wall_ms": wall_ms, "profiled_wall_ms": profiled_ms, "device_ms": device_ms,
           "kernel_launches": len(kernels), "idle_share": 1 - device_ms / wall_ms,
           "idle_share_profiled": 1 - device_ms / profiled_ms}
    for label, syms in PROFILED_KERNELS.items():
        hits = [(n, t) for name, (n, t) in by_name.items() if any(sym in name for sym in syms)]
        if hits:
            out[f"{label}_ms"] = sum(t for _, t in hits)
            out[f"{label}_launches"] = sum(n for n, _ in hits)
    print(json.dumps({"profile": path, **out}))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (n, total) in ranked[:8]:
        print(f"  {path} {total:9.3f} ms {n:6d} launches  {name[:110]}")
    out["by_kernel"] = {name: [n, total] for name, (n, total) in ranked}
    return out


# ---------------------------------------------------------------------------
# A/B mode: #1, #4-#9 of one tree (this checkout's or --tree's package)
# ---------------------------------------------------------------------------

AB_DIGEST_CASES = ("attn_block", "attn_block_kv_quant", "attn_block_w8a8", "mlp_block", "mlp_block_w8a8_b1",
                   "mlp_block_w8a8_b4", "swin_block_s1", "swin_block_s2", "swin_block_s3", "window_attention",
                   "window_attention_hd24")
# The targets ``ab_compare`` reports: key -> limit in ms, or None for half
# the parent's time (#6 and #8: PR 9's; #7 and #1: PR 10's).
AB_TARGETS = {"mlp_block B=1": 0.060, "mlp_block B=4": 0.100,
              "mlp_block_w8a8 B=1": 0.050, "mlp_block_w8a8 B=4": 0.090, "log_mel B=1": 0.030, "log_mel B=4": 0.060,
              **{f"swin_block {stage} B={b} {msa}": limit if b == 1 else None
                 for stage, limit in (("v0 stage 1", 0.050), ("v0 stage 2", 0.050), ("v0 stage 3", 0.070),
                                      ("HTSAT-large stage 1", 0.110))
                 for b in (1, 4) for msa in ("W-MSA", "SW-MSA")}}
# Readings the change must keep within a fraction of the parent's median
# (#2 and #3 without a start, PR 12).
AB_WITHIN = {f"decode_attention B={b}": 0.02 for b in (1, 4)}
AB_WITHIN.update({f"decode_attention_int8 B={b} E={e}": 0.02 for b in (1, 4) for e in (1, 8)})
# A B=1 v0 request's device time (profile) in a kernel's calls: name ->
# (path, limit in ms): #6's 30 calls and #8's 20 in bf16, #7's 30 in int8.
AB_PROFILE_TARGETS = {"mlp_block": ("bf16", 1.8), "swin_block": ("bf16", 1.3), "mlp_block_w8a8": ("int8", 1.6)}
# Where a parent's profile lacks a target's symbol: the profile entries that
# held the same work before (#7: its GEMMs and its fp32 quantizer; its 30
# bf16 quantizers share rowquant_kernel's symbol with #5's and are left
# out, so the parent's number is a lower bound).
AB_PROFILE_PARENT = {"mlp_block_w8a8": ("int8_gemm", "rowquant_float")}


def _ab_time(res, tag, key, call) -> None:
    """Three device-time medians of 20 calls and the per-launch split."""
    call()
    times = [_median_ms(call) for _ in range(3)]
    res[key] = {"ms": statistics.median(times), "ms_all": times, "stages": split_or_none(call)}
    _print_split(f"{tag} {key}", res[key]["stages"])
    print(f"{tag} {key}: {statistics.median(times):.4f} ms ({min(times):.4f}-{max(times):.4f})")


def _ab_composed(res, tag, key, composed) -> None:
    res[key] = statistics.median(_median_ms(composed) for _ in range(3))
    print(f"{tag} {key}: {res[key]:.4f} ms")


def ab_run(tag: str, out_dir: str) -> dict:
    """One tree's readings of #4, #4 kv_quant and #5 at v0 (B=1, B=4), of #6
    and #7 at v0 (B=1, B=4), of #1 on 10 s clips (B=1, B=4; with its plain
    version), of #8 at v0's stages 1-3 and HTSAT-large's stage 1
    and of #9 at HTSAT-large's stage 2 (B=1, B=4, W-MSA and SW-MSA):
    device-time medians (3 medians of 20
    each), the per-launch split, the composed library chains, the outputs of
    the digest cases of ``tests/torch_kernel_cases.py`` (this checkout's
    file, on the imported package; saved for ``ab_compare``), and the
    profile of one warm B=1 bf16 and int8 request. Writes
    ``ab_<tag>_<time>.json`` to ``out_dir``."""
    sys.path.append(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_kernel_cases as kc

    cfg = get_config("v0")
    dec, S = cfg.decoder, cfg.prefix_length
    D, H, KV, hd, I = dec.hidden_size, dec.num_heads, dec.num_kv_heads, dec.head_dim, dec.intermediate_size
    eps = dec.rms_norm_eps
    res = {"tree": tag, "t": time.time(), "device": torch.cuda.get_device_name(0)}
    outs = {name: [t.cpu() for t in kc.digest_case(name)] for name in AB_DIGEST_CASES}
    res["digests"] = {name: kc.digest(*o) for name, o in outs.items()}
    res["digests"]["attn_block_w8a8_kv"] = kc.digest(*outs["attn_block_w8a8"][1:])
    path = os.path.join(out_dir, f"ab_{tag}_outputs.pt")
    if not os.path.exists(path):
        torch.save(outs, path)
    rng = np.random.default_rng(SEED + 2)
    lp = _decoder_layer(rng, dec)
    w16 = [lp[k] for k in ("ln_attn", "wq", "wk", "wv", "wo")]
    w8 = [lp["ln_attn"]] + [t for shape in ((D, H * hd), (D, KV * hd), (D, KV * hd), (H * hd, D))
                            for t in _int8_weight(rng, *shape)]
    w6 = [lp[k] for k in ("ln_mlp", "w_gate", "w_up", "w_down")]
    cos, sin = llama.rope_device_tables(dec, S, torch.bfloat16, "cuda")
    kw = dict(num_heads=H, num_kv_heads=KV, head_dim=hd, eps=eps)
    wqkv = torch.cat([lp["wq"], lp["wk"], lp["wv"]], dim=1)
    wgu = torch.cat([lp["w_gate"], lp["w_up"]], dim=1)
    w7 = [1 + _bf16(rng, D, scale=0.1)] + [t for shape in ((D, I), (D, I), (I, D)) for t in _int8_weight(rng, *shape)]
    for batch in (1, 4):
        x = _bf16(rng, batch, S, D, scale=0.5)
        calls = {"attn_block": lambda: ab.attn_block_cuda(x, *w16, cos, sin, **kw),
                 "attn_block_kv_quant": lambda: ab.attn_block_cuda(x, *w16, cos, sin, **kw, kv_quant=True),
                 "attn_block_w8a8": lambda: aw.attn_block_w8a8_cuda(x, *w8, cos, sin, **kw, kv_quant=True),
                 "mlp_block": lambda: mb.mlp_block_cuda(x, *w6, eps=eps),
                 "mlp_block_w8a8": lambda: mw.mlp_block_w8a8_cuda(x, *w7, eps=eps)}
        for name, call in calls.items():
            _ab_time(res, tag, f"{name} B={batch}", call)
        _ab_composed(res, tag, f"composed_library B={batch}",
                     lambda: composed_attn_block(x, lp["ln_attn"], wqkv, lp["wo"], cos, sin, H, KV, hd, eps))
        _ab_composed(res, tag, f"composed_mlp_block B={batch}",
                     lambda: composed_mlp_block(x, lp["ln_mlp"], wgu, lp["w_down"], eps))
        _ab_composed(res, tag, f"composed_mlp_block_w8a8 B={batch}",
                     lambda: composed_mlp_block_w8a8(x, *w7, eps=eps))
    fcfg = cfg.frontend
    window = torch.from_numpy(fe.hann_window(fcfg.n_fft).astype(np.float32)).cuda()
    fb = fe.device_tables(fcfg, torch.device("cuda"))[1]
    for batch in (1, 4):
        wave_ = torch.from_numpy((rng.standard_normal((batch, fcfg.num_samples)) * 0.1).astype(np.float32)).cuda()
        _ab_time(res, tag, f"log_mel B={batch}", lambda: melspec.log_mel_cuda(wave_, fcfg))
        _ab_composed(res, tag, f"plain_log_mel B={batch}", lambda: fe.log_mel_spectrogram(wave_, fcfg))
        _ab_composed(res, tag, f"composed_log_mel B={batch}", lambda: composed_log_mel(wave_, fcfg, window, fb))
    # #2 and #3 as the main path calls them (no start), at v0's decode shapes.
    drng = np.random.default_rng(SEED + 6)
    s_max = S + MAX_LEN
    for batch, n in ((1, S), (4, S + 31)):
        q = _bf16(drng, batch, H, hd)
        k, v = _bf16(drng, batch, s_max, KV, hd), _bf16(drng, batch, s_max, KV, hd)
        _ab_time(res, tag, f"decode_attention B={batch}", lambda: da.decode_attention_cuda(q, k, v, n))
        k8, ks = llama.quantize_kv(_bf16(drng, batch, s_max, KV * hd, scale=0.5))
        v8, vs = llama.quantize_kv(_bf16(drng, batch, s_max, KV * hd))
        k8, v8 = k8.reshape(batch, s_max, KV, hd), v8.reshape(batch, s_max, KV, hd)
        for E in (1, 8):
            cur = (_bf16(drng, batch, 8, KV, hd, scale=0.5)[:, :E], _bf16(drng, batch, 8, KV, hd)[:, :E])
            _ab_time(res, tag, f"decode_attention_int8 B={batch} E={E}",
                     lambda: di.decode_attention_int8_cuda(q, k8, v8, ks, vs, n, *cur))
    srng = np.random.RandomState(SEED + 4)
    for label, enc in (("v0", cfg.encoder), ("HTSAT-large", htsat_large_config().encoder)):
        for si, R, C, Hs in _stages(enc, "swin_block"):
            for batch in (1, 4):
                for shifted in (False, True):
                    x, p, bias, mask = kc.swin_inputs(srng, batch, R, C, Hs, shifted)
                    key = f"swin_block {label} stage {si + 1} B={batch} {'SW-MSA' if shifted else 'W-MSA'}"
                    _ab_time(res, tag, key, lambda: sb.swin_block_cuda(x, p, bias, mask, num_heads=Hs, window_size=8))
                    _ab_composed(res, tag, "composed_" + key, lambda: composed_swin_block(x, p, bias, mask, Hs))
    # #9 shares #8's attention core: HTSAT-large's stage 2 (R=32, C=512, H=8).
    for batch in (1, 4):
        for shifted in (False, True):
            qkv = kc.bf16(srng, batch * 16, 64, 3 * 512, scale=0.5)
            bias = kc.bf16(srng, 8, 64, 64, scale=0.5).float()
            mask = torch.from_numpy(shifted_window_mask(32, 8, 4)).cuda() if shifted else None
            _ab_time(res, tag, f"window_attention B={batch} {'SW-MSA' if shifted else 'W-MSA'}",
                     lambda: wa.window_attention_cuda(qkv, bias, mask, num_heads=8))
    params = init_params(cfg, SEED)
    with tempfile.TemporaryDirectory() as tmp:
        req = [_write_wav(os.path.join(tmp, "a.wav"), 7.0, 1), _write_wav(os.path.join(tmp, "b.wav"), 9.5, 2),
               "caption the audio."]
        for path in ("bf16", "int8"):
            name, ctor, gen_kwargs = PATHS[path]
            w = MellowWrapper(config=name, model="v0", device="cuda", params=params,
                              tokenizer=DistinctTokenizer(), **ctor)
            w.generate([req], max_len=MAX_LEN, **gen_kwargs)
            res[f"profile_{path}"] = profile_request(w, req, path)
            del w
    with open(os.path.join(out_dir, f"ab_{tag}_{int(res['t'])}.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({"ab": tag, "digests": res["digests"]}))
    return res


def ab_compare(out_dir: str) -> dict:
    """The largest bf16 ulp distance between the parent's and the change's
    outputs on the digest tests' inputs (int8 rows: the largest level
    difference; fp32 scales: whether they are equal), and each target of
    ``AB_TARGETS`` and ``AB_PROFILE_TARGETS`` as met or not, with the
    readings of every parent and change run in ``out_dir``."""
    a, b = (torch.load(os.path.join(out_dir, f"ab_{t}_outputs.pt")) for t in ("parent", "change"))
    diff = {}
    for name in a:
        for i, (x, y) in enumerate(zip(a[name], b[name])):
            if x.dtype == torch.bfloat16:
                diff[f"{name}[{i}] max ulp"] = max_ulp(x, y)
            elif x.dtype == torch.int8:
                diff[f"{name}[{i}] max levels"] = int((x.int() - y.int()).abs().max().item())
            else:
                diff[f"{name}[{i}] equal"] = bool(torch.equal(x, y))
    print(json.dumps({"ab_compare": diff}))
    runs = {"parent": [], "change": []}
    for fname in sorted(os.listdir(out_dir)):
        tag = fname.split("_")[1] if fname.startswith("ab_") and fname.endswith(".json") else None
        if tag in runs:
            with open(os.path.join(out_dir, fname)) as f:
                runs[tag].append(json.load(f))
    if not (runs["parent"] and runs["change"]):
        return diff
    targets = {}
    for key, limit in AB_TARGETS.items():
        par = [r[key]["ms"] for r in runs["parent"] if key in r]
        chg = [r[key]["ms"] for r in runs["change"] if key in r]
        if not (par and chg):
            continue
        lim = limit if limit is not None else 0.5 * min(par)
        targets[key] = {"parent_ms": par, "change_ms": chg, "limit_ms": lim, "met": max(chg) <= lim}
    for key, frac in AB_WITHIN.items():
        par = [r[key]["ms"] for r in runs["parent"] if key in r]
        chg = [r[key]["ms"] for r in runs["change"] if key in r]
        if par and chg:
            lim = (1 + frac) * statistics.median(par)
            targets[key] = {"parent_ms": par, "change_ms": chg, "limit_ms": lim,
                            "met": statistics.median(chg) <= lim}
    for name, (path, limit) in AB_PROFILE_TARGETS.items():
        chg = [r[f"profile_{path}"].get(f"{name}_ms") for r in runs["change"]]
        par = [r[f"profile_{path}"].get(f"{name}_ms",
                                         sum(r[f"profile_{path}"].get(f"{k}_ms", 0.0)
                                             for k in AB_PROFILE_PARENT.get(name, ())) or None)
               for r in runs["parent"]]
        if None not in chg:
            targets[f"profile {path} {name}"] = {"parent_ms": par, "change_ms": chg, "limit_ms": limit,
                                                 "met": max(chg) <= limit}
    for key, t in targets.items():
        print(f"target {key}: parent {t['parent_ms']}, change {t['change_ms']}, limit {t['limit_ms']:.4f} ms: "
              f"{'met' if t['met'] else 'NOT MET'}")
    # #1 against its plain version and the torch.stft chain, #7 against its
    # composed chain, in each change run.
    for batch in (1, 4):
        for kernel, others in ((f"log_mel B={batch}", (f"plain_log_mel B={batch}", f"composed_log_mel B={batch}")),
                               (f"mlp_block_w8a8 B={batch}", (f"composed_mlp_block_w8a8 B={batch}",))):
            for r in runs["change"]:
                if kernel in r and all(o in r for o in others):
                    faster = all(r[kernel]["ms"] < r[o] for o in others)
                    print(f"{kernel}: kernel {r[kernel]['ms']:.4f} ms, "
                          + ", ".join(f"{o.rsplit(' ', 1)[0]} {r[o]:.4f}" for o in others)
                          + f": kernel {'faster than all' if faster else 'NOT faster than all'}")
    print(json.dumps({"ab_targets": targets}))
    return diff


def ab_main(argv) -> int:
    """``chip_smoke.py --ab TAG [--tree DIR] [--out OUT]``: ``ab_run`` for
    DIR's package (default this checkout); ``chip_smoke.py --ab compare
    [--out OUT]``: ``ab_compare``. Results go to OUT (default ``build/ab``
    of this checkout)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.abspath(argv[argv.index("--out") + 1]) if "--out" in argv else os.path.join(here, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    tag = argv[argv.index("--ab") + 1]
    if tag == "compare":
        ab_compare(out_dir)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.load_library()
    ab_run(tag, out_dir)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # A trace directory in the environment would trace every request, and
    # profiling.trace refuses to start inside the profiled phases' profiler.
    os.environ.pop(profiling.ENV_VAR, None)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    t = time.perf_counter()
    _build.load_library()
    print(f"kernels built and loaded in {time.perf_counter() - t:.2f} s")
    log = os.path.join(_build.BUILD_DIR, "nvcc.log")
    if os.path.exists(log):
        with open(log) as f:
            for line in f:
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print("ptxas:", line.strip())

    t = time.perf_counter()
    rows = kernel_phase(get_config("v0"), gpt2_config(), htsat_large_config())
    print(f"kernel phase took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    run = slice_phase(card)
    launches = run["launches"]
    print(f"slice phase took {time.perf_counter() - t:.1f} s")
    # Each kernel's launches on the run of the path that carries it (the
    # int8 path's own kernels on that path, #4's kv_quant mode on the
    # int8-weights path, the prefill attention on the GPT-2 bf16 path, the
    # window attention on the HTSAT-large bf16 path; the rest on the bf16
    # path), with that run's generate calls, and on every path.
    home = {"decode_attention_int8": "int8", "attn_block_w8a8": "int8", "mlp_block_w8a8": "int8",
            "attn_block_kv_quant": "int8_weights", "flash_gqa_prefill": "gpt2_bf16",
            "window_attention": "large_bf16"}
    for row in rows:
        name = row["name"]
        mod, _, per_call, *_ = KERNELS[name]
        path = home.get(name, "bf16")
        row["launches"] = launches[path][name]
        row["home_path"] = path
        row["home_path_generate_calls"] = run["calls"][path]
        row["launches_by_path"] = {p: counts[name] for p, counts in launches.items()}
        row["launches_by_encoder_entry"] = {e: counts[name] for e, counts in run["entries"].items()}
        row["kernel_launches_per_call"] = getattr(mod, per_call)
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(ab_main(sys.argv) if "--ab" in sys.argv else main())
