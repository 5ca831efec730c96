"""Offline checkpoint converter: PyTorch state_dict -> the parameter tree.

The port's own copy of ``mellow_tpu/tools/convert_ckpt.py``, its functions
held equal to the original's by ``tests/test_torch_copies.py``. The
reference loads a whole-model torch state_dict covering every submodule
(mellow/wrapper.py:74-82; key prefixes: ``audio_encoder.base.htsat.*``,
``audio_encoder.base.c2l.*``, ``audio_encoder.projection.*``,
``caption_decoder.lm.*``). This tool maps those keys 1:1 into the JAX
package's parameter tree layout, which the port loads
(``models/params.params_from_jax``), and saves the result as a ``.npz``;
``MellowWrapper`` also runs it on a ``.ckpt``/``.pt`` path itself. The
conversion is numpy on the host: nothing runs on a device.

Usage:
    python -m mellow_tpu_torch.tools.convert_ckpt v0.ckpt out_params.npz
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np


def _np(t):
    import torch

    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


# ---------------------------------------------------------------------------
# Llama decoder (HF LlamaForCausalLM weights -> stacked-layer tree)
# ---------------------------------------------------------------------------

def convert_llama(sd: Dict[str, "object"], num_layers: int, prefix: str = "") -> dict:
    """Convert HF Llama weights. ``sd`` keys look like
    ``{prefix}model.layers.0.self_attn.q_proj.weight``.

    HF Linear weights are (out, in); ours are (in, out), so transpose.
    Per-layer tensors are stacked on a leading L axis for ``lax.scan``.
    """

    def g(key):
        return _np(sd[prefix + key]).astype(np.float32)

    def stack(fmt, transpose=True):
        arrs = [g(fmt.format(i)) for i in range(num_layers)]
        if transpose:
            arrs = [a.T for a in arrs]
        return np.stack(arrs, axis=0)

    params = {
        "embed": g("model.embed_tokens.weight"),
        "layers": {
            "ln_attn": stack("model.layers.{}.input_layernorm.weight", transpose=False),
            "ln_mlp": stack(
                "model.layers.{}.post_attention_layernorm.weight", transpose=False
            ),
            "wq": stack("model.layers.{}.self_attn.q_proj.weight"),
            "wk": stack("model.layers.{}.self_attn.k_proj.weight"),
            "wv": stack("model.layers.{}.self_attn.v_proj.weight"),
            "wo": stack("model.layers.{}.self_attn.o_proj.weight"),
            "w_gate": stack("model.layers.{}.mlp.gate_proj.weight"),
            "w_up": stack("model.layers.{}.mlp.up_proj.weight"),
            "w_down": stack("model.layers.{}.mlp.down_proj.weight"),
        },
        "norm_f": g("model.norm.weight"),
    }
    if prefix + "lm_head.weight" in sd:
        head = _np(sd[prefix + "lm_head.weight"]).astype(np.float32)
        if not np.shares_memory(head, _np(sd[prefix + "model.embed_tokens.weight"])):
            # Untied head (not the SmolLM2 case, but supported).
            if head.shape != params["embed"].shape or not np.array_equal(
                head, params["embed"]
            ):
                params["lm_head"] = head.T
    return params


# ---------------------------------------------------------------------------
# HTSAT encoder (reference key layout: audio_encoder.base.htsat.*)
# ---------------------------------------------------------------------------

def convert_htsat(sd, prefix: str = "audio_encoder.base.htsat.") -> dict:
    """Convert the HTSAT Swin encoder weights.

    Source module structure: mellow/model/htsat.py:599-714. Target layout:
    mellow_tpu/models/htsat.py. Conv kernels (O, I, kh, kw) are reshaped to
    patch-matmul layout; Linear (out, in) -> (in, out).
    """

    def g(key):
        return _np(sd[prefix + key]).astype(np.float32)

    def lin(key):
        return {"kernel": g(key + ".weight").T, "bias": g(key + ".bias")}

    def lin_nb(key):
        return {"kernel": g(key + ".weight").T}

    def ln(key):
        return {"scale": g(key + ".weight"), "bias": g(key + ".bias")}

    # Patch embed: Conv2d(1, 96, 4, stride 4, pad 0) == patchify matmul.
    # Conv weight (96, 1, 4, 4) -> (16, 96) with patch pixels flattened
    # row-major (kh, kw), matching our space-to-depth ordering.
    pe_w = g("patch_embed.proj.weight")  # (96, 1, 4, 4)
    O, I, kh, kw = pe_w.shape
    patch_kernel = pe_w.reshape(O, I * kh * kw).T  # (16, 96)

    depths = [2, 2, 6, 2]
    stages = []
    for si, depth in enumerate(depths):
        blocks = []
        for bi in range(depth):
            p = f"layers.{si}.blocks.{bi}."
            blocks.append(
                {
                    "norm1": ln(p + "norm1"),
                    "qkv": lin(p + "attn.qkv"),
                    "proj": lin(p + "attn.proj"),
                    "rel_bias_table": g(p + "attn.relative_position_bias_table"),
                    "norm2": ln(p + "norm2"),
                    "fc1": lin(p + "mlp.fc1"),
                    "fc2": lin(p + "mlp.fc2"),
                }
            )
        stage = {"blocks": blocks}
        if si < len(depths) - 1:
            stage["downsample"] = {
                "norm": ln(f"layers.{si}.downsample.norm"),
                "reduction": lin_nb(f"layers.{si}.downsample.reduction"),
            }
        stages.append(stage)

    # (527, 768, 2, 3) -> (768*2*3, 527): stored flattened AND transposed
    # as the im2col matmul RHS (row-major (c, f, k) contraction order,
    # matching the column construction in htsat.tscam_head) — a 4D
    # conv-filter param costs a 14.85 ms strided layout-conversion DMA
    # per encoder pass on TPU, and the untransposed (O, K) orientation
    # costs another 9.65 ms transpose copy per pass (htsat.tscam_head).
    tscam_w = g("tscam_conv.weight").reshape(527, -1).T

    return {
        "bn0": {
            "scale": g("bn0.weight"),
            "bias": g("bn0.bias"),
            "mean": g("bn0.running_mean"),
            "var": g("bn0.running_var"),
        },
        "patch_embed": {
            "kernel": patch_kernel,
            "bias": g("patch_embed.proj.bias"),
            "norm": ln("patch_embed.norm"),
        },
        "stages": stages,
        "norm": ln("norm"),
        "tscam_conv": {"kernel": tscam_w, "bias": g("tscam_conv.bias")},
        # 'head' (Linear 527->527, htsat.py:710) is dead in the tscam forward
        # path (htsat.py:742-796 never calls it) but present in the ckpt;
        # keep it for checkpoint round-trip completeness.
        "head": lin("head"),
    }


def convert_encoder_bundle(sd, base_prefix: str = "audio_encoder.") -> dict:
    """Audio side: HTSAT + c2l + projection -> the tree consumed by
    mellow_tpu.models.htsat.encode_audio."""
    return {
        "encoder": convert_htsat(sd, prefix=base_prefix + "base.htsat."),
        "c2l": {
            "kernel": _np(sd[base_prefix + "base.c2l.weight"]).astype(np.float32).T,
            "bias": _np(sd[base_prefix + "base.c2l.bias"]).astype(np.float32),
        },
        "projection": {
            "linear1": {
                "kernel": _np(sd[base_prefix + "projection.linear1.weight"])
                .astype(np.float32)
                .T
            },
            "linear2": {
                "kernel": _np(sd[base_prefix + "projection.linear2.weight"])
                .astype(np.float32)
                .T
            },
            "layer_norm": {
                "scale": _np(sd[base_prefix + "projection.layer_norm.weight"]).astype(
                    np.float32
                ),
                "bias": _np(sd[base_prefix + "projection.layer_norm.bias"]).astype(
                    np.float32
                ),
            },
        },
    }


def convert_mellow(sd, num_layers: int = 30) -> dict:
    """Full Mellow state_dict -> param tree. Asserts exact key coverage."""
    used = set()

    class Tracking(dict):
        def __getitem__(self, k):
            used.add(k)
            return dict.__getitem__(self, k)

        def __contains__(self, k):
            return dict.__contains__(self, k)

    tsd = Tracking(sd)

    params = convert_encoder_bundle(tsd)
    params["decoder"] = convert_llama(tsd, num_layers, prefix="caption_decoder.lm.")

    # Coverage check (SURVEY.md section 7.3 item 8): every ckpt key must be consumed
    # or on the explicit ignore list.
    ignorable = {
        k
        for k in sd
        if k.endswith("num_batches_tracked")
        or ".relative_position_index" in k
        or ".attn_mask" in k
        or "spectrogram_extractor" in k  # frozen DFT basis, recomputed exactly
        or "logmel_extractor" in k  # frozen mel filterbank, recomputed exactly
        or k == "caption_decoder.lm.lm_head.weight"  # tied to embed_tokens
        or "rotary_emb.inv_freq" in k
    }
    missing = set(sd) - used - ignorable
    if missing:
        raise ValueError(f"Unconverted checkpoint keys: {sorted(missing)[:20]}")
    return params


# npz (de)serialization, the port's copy of the JAX package's.
from mellow_tpu_torch.utils.params_io import (  # noqa: E402,F401
    flatten_tree,
    load_params,
    save_params,
    unflatten_tree,
)


def load_state_dict(path: str) -> dict:
    """A reference checkpoint (``.ckpt``/``.pt``) as a state dict on the
    host: ``weights_only=True`` passed explicitly, so a file loads the same
    way under every torch version (tensors and containers only), and any
    ``module.`` prefix of a DataParallel-trained checkpoint stripped
    (reference fallback, wrapper.py:75-82)."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if any(k.startswith("module.") for k in sd):
        sd = {k[len("module.") :]: v for k, v in sd.items()}
    return sd


def main(argv):
    ckpt_path, out_path = argv[1], argv[2]
    params = convert_mellow(load_state_dict(ckpt_path))
    save_params(params, out_path)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main(sys.argv)
