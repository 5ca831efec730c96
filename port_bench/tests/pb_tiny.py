"""A tiny cell for the benchmark's CPU tests: a copy of ``port_bench/`` in a
temporary root, with a configuration, a traffic mix, a limit and a
``BENCHMARK.json`` of its own added as new files."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
REPO = os.path.dirname(PB)

TINY_CFG = {
    "name": "tiny_bf16", "source": "https://github.com/soham97/mellow", "reference": "mellow",
    "compute_dtype": "bfloat16", "decoder_family": "llama", "d_proj": 64, "text_tokenization_len": 8,
    "prefix_length": 268, "sep_token_id": 0, "stop_token_id": 0, "pad_token_id": 1,
    "frontend": {"sample_rate": 32000, "segment_seconds": 10, "n_fft": 1024, "win_length": 1024, "hop_length": 320,
                 "n_mels": 64, "fmin": 50.0, "fmax": 14000.0, "ref": 1.0, "amin": 1e-10, "top_db": None},
    "encoder": {"spec_size": 256, "patch_size": 4, "patch_stride": 4, "in_chans": 1, "num_classes": 527,
                "embed_dim": 24, "depths": [2, 2, 6, 2], "num_heads": [4, 8, 16, 32], "window_size": 8,
                "mlp_ratio": 4.0, "qkv_bias": True, "drop_rate": 0.0, "attn_drop_rate": 0.0,
                "drop_path_rate": 0.1, "mel_bins": 64, "out_emb": 192},
    "decoder": {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128, "num_layers": 4, "num_heads": 4,
                "num_kv_heads": 2, "head_dim": 16, "rope_theta": 100000.0, "rms_norm_eps": 1e-5,
                "tie_word_embeddings": True, "max_position_embeddings": 8192},
}
TINY_MIX = {"batch": 2, "max_len": 4, "greedy": True, "clip_seconds": 10,
            "sample_rate": 32000, "prompt_tokens_min": 2, "prompt_tokens_max": 6, "pool_batches": 2,
            "check_requests": 4, "trace_calls": 1}
CELL = "tiny_bf16.tiny_mix"
# The tiny cell's limits. Its sound runs read (on the CPU, seeds 5, 6 and
# 2**31 + 12345) gaps under 0.001, logits within 0.0055-0.0068 of the
# reference, the prefix within 0.0061-0.0068, the decoder alone within
# 0.0055, the decode steps' cache within 0.0045 and the first layer's
# keys and values within 0.0026. An altered token reads gaps of 0.8-0.96,
# a stale cache 1.0 in the cache, a skipped Swin block 0.048-0.052 in the
# prefix.
TINY_LIMITS = {"max_logit_gap": 0.1, "logits_rel_err": 0.1, "prefix_rel_err": 0.02, "decoder_rel_err": 0.03,
               "cache_rel_err": 0.05, "first_layer_kv_rel_err": 0.02}


def _dump(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_root(tmp: str, metrics=("launches_per_call",)) -> str:
    """A checkout-like root under ``tmp``: ``port_bench/`` copied, the tiny
    configuration, mix and limit added, and a BENCHMARK.json naming the
    tiny cell with the three end-to-end metrics and ``metrics``."""
    root = os.path.join(tmp, "root")
    shutil.copytree(PB, os.path.join(root, "port_bench"), ignore=shutil.ignore_patterns("__pycache__", "tests"))
    _dump(TINY_CFG, os.path.join(root, "port_bench", "configs", "tiny_bf16.json"))
    _dump(TINY_MIX, os.path.join(root, "port_bench", "traffic", "tiny_mix.json"))
    _dump(TINY_LIMITS, os.path.join(root, "port_bench", "limits", CELL + ".json"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny_bf16", "source": TINY_CFG["source"], "file": "port_bench/configs/tiny_bf16.json",
                         "reduced": [], "why": "tiny"}]
    bench["workloads"] = [{"name": CELL, "config": "tiny_bf16", "traffic": "tiny_mix", "chips": 1, "why": "tiny"}]
    bench["per_layer"] = [dict(m, workloads=[CELL]) for m in bench["per_layer"] if m["name"] in metrics]
    _dump(bench, os.path.join(root, "BENCHMARK.json"))
    return root
