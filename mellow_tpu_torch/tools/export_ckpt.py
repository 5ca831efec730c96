"""Offline checkpoint exporter: parameter tree -> PyTorch state_dict.

The port's own copy of ``mellow_tpu/tools/export_ckpt.py``, its functions
held equal to the original's by ``tests/test_torch_copies.py``. The exact
inverse of ``convert_ckpt.py`` — so a model in the JAX package's tree
layout (a converted ``.npz`` or ``models/mellow.init_params``) can be
loaded back into the reference PyTorch stack
(mellow/wrapper.py:74-82 `load_state_dict`). Covers every LEARNED
parameter and BatchNorm statistic the reference checkpoint carries (the
same key set convert_ckpt consumes). Constructed buffers —
`relative_position_index`, `attn_mask`, the frozen torchlibrosa DFT/mel
extractor weights, `rotary_emb.inv_freq`, `num_batches_tracked` — are
intentionally NOT emitted: torch rebuilds all of them in module
``__init__`` with identical values, so the reference loads the export
with ``strict=False`` (or via its DataParallel-fallback loader) and
produces the same outputs.

Usage:
    python -m mellow_tpu_torch.tools.export_ckpt params.npz out_v0.ckpt
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


# ---------------------------------------------------------------------------
# Llama decoder (inverse of convert_ckpt.convert_llama)
# ---------------------------------------------------------------------------

def export_llama(dec: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """Stacked-layer tree -> HF LlamaForCausalLM keys. Our kernels are
    (in, out); HF Linear weights are (out, in), so transpose back."""
    out: Dict[str, np.ndarray] = {}
    out[prefix + "model.embed_tokens.weight"] = _a(dec["embed"])
    layers = dec["layers"]
    L = int(np.asarray(layers["ln_attn"]).shape[0])
    per_layer = {
        "input_layernorm.weight": ("ln_attn", False),
        "post_attention_layernorm.weight": ("ln_mlp", False),
        "self_attn.q_proj.weight": ("wq", True),
        "self_attn.k_proj.weight": ("wk", True),
        "self_attn.v_proj.weight": ("wv", True),
        "self_attn.o_proj.weight": ("wo", True),
        "mlp.gate_proj.weight": ("w_gate", True),
        "mlp.up_proj.weight": ("w_up", True),
        "mlp.down_proj.weight": ("w_down", True),
    }
    for i in range(L):
        for hf_key, (ours, transpose) in per_layer.items():
            w = _a(layers[ours][i])
            out[f"{prefix}model.layers.{i}.{hf_key}"] = w.T if transpose else w
    out[prefix + "model.norm.weight"] = _a(dec["norm_f"])
    # The reference checkpoint carries lm_head.weight (tied to the
    # embedding for SmolLM2 — convert_ckpt's ignore list); emit the tie.
    head = dec.get("lm_head")
    out[prefix + "lm_head.weight"] = (
        _a(head).T if head is not None else _a(dec["embed"])
    )
    return out


# ---------------------------------------------------------------------------
# HTSAT encoder (inverse of convert_ckpt.convert_htsat)
# ---------------------------------------------------------------------------

def export_htsat(enc: dict, prefix: str = "audio_encoder.base.htsat.") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}

    def lin(key: str, node: dict):
        out[prefix + key + ".weight"] = _a(node["kernel"]).T
        if "bias" in node:
            out[prefix + key + ".bias"] = _a(node["bias"])

    def ln(key: str, node: dict):
        out[prefix + key + ".weight"] = _a(node["scale"])
        out[prefix + key + ".bias"] = _a(node["bias"])

    bn = enc["bn0"]
    out[prefix + "bn0.weight"] = _a(bn["scale"])
    out[prefix + "bn0.bias"] = _a(bn["bias"])
    out[prefix + "bn0.running_mean"] = _a(bn["mean"])
    out[prefix + "bn0.running_var"] = _a(bn["var"])

    pe = enc["patch_embed"]
    # (kh*kw, O) patch-matmul kernel -> Conv2d (O, 1, kh, kw); the patch
    # is 4x4 single-channel by architecture (htsat.py:103-105).
    pk = _a(pe["kernel"])  # (16, O)
    O = pk.shape[1]
    out[prefix + "patch_embed.proj.weight"] = pk.T.reshape(O, 1, 4, 4)
    out[prefix + "patch_embed.proj.bias"] = _a(pe["bias"])
    ln("patch_embed.norm", pe["norm"])

    for si, stage in enumerate(enc["stages"]):
        for bi, blk in enumerate(stage["blocks"]):
            p = f"layers.{si}.blocks.{bi}."
            ln(p + "norm1", blk["norm1"])
            lin(p + "attn.qkv", blk["qkv"])
            lin(p + "attn.proj", blk["proj"])
            out[prefix + p + "attn.relative_position_bias_table"] = _a(
                blk["rel_bias_table"]
            )
            ln(p + "norm2", blk["norm2"])
            lin(p + "mlp.fc1", blk["fc1"])
            lin(p + "mlp.fc2", blk["fc2"])
        if "downsample" in stage:
            ln(f"layers.{si}.downsample.norm", stage["downsample"]["norm"])
            lin(
                f"layers.{si}.downsample.reduction",
                stage["downsample"]["reduction"],
            )

    ln("norm", enc["norm"])
    # (C*2*3, 527) transposed im2col matmul RHS -> Conv2d (527, C, 2, 3).
    tw = _a(enc["tscam_conv"]["kernel"]).T
    out[prefix + "tscam_conv.weight"] = tw.reshape(tw.shape[0], -1, 2, 3)
    out[prefix + "tscam_conv.bias"] = _a(enc["tscam_conv"]["bias"])
    lin("head", enc["head"])
    return out


def export_encoder_bundle(params: dict, base_prefix: str = "audio_encoder.") -> Dict[str, np.ndarray]:
    out = export_htsat(params["encoder"], prefix=base_prefix + "base.htsat.")
    out[base_prefix + "base.c2l.weight"] = _a(params["c2l"]["kernel"]).T
    out[base_prefix + "base.c2l.bias"] = _a(params["c2l"]["bias"])
    proj = params["projection"]
    out[base_prefix + "projection.linear1.weight"] = _a(
        proj["linear1"]["kernel"]
    ).T
    out[base_prefix + "projection.linear2.weight"] = _a(
        proj["linear2"]["kernel"]
    ).T
    out[base_prefix + "projection.layer_norm.weight"] = _a(
        proj["layer_norm"]["scale"]
    )
    out[base_prefix + "projection.layer_norm.bias"] = _a(
        proj["layer_norm"]["bias"]
    )
    return out


def export_mellow(params: dict) -> Dict[str, np.ndarray]:
    """Full param tree -> reference-layout state_dict (numpy values)."""
    sd = export_encoder_bundle(params)
    sd.update(export_llama(params["decoder"], prefix="caption_decoder.lm."))
    return sd


def main(argv):
    import torch

    from mellow_tpu_torch.utils.params_io import load_params

    params_path, out_path = argv[1], argv[2]
    params = load_params(params_path)
    sd = export_mellow(params)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, out_path)
    print(f"wrote {out_path} ({len(sd)} tensors)")


if __name__ == "__main__":
    main(sys.argv)
