"""Mellow assembly in PyTorch: two audio encodings + prompt -> prefix -> LM.

Port of the inference path of ``mellow_tpu/models/mellow.py``. The port's
parameter tree is the JAX tree with the decoder's stacked layers split per
layer (``models/params.py``); ``init_params`` builds the JAX-layout tree in
numpy, so full-width random weights need no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from mellow_tpu.config import MellowConfig
from mellow_tpu_torch.models import generate as gen
from mellow_tpu_torch.models import htsat


def build_prefix(
    params: dict,
    cfg: MellowConfig,
    audio_proj1: torch.Tensor,  # (B, 33, D) compact encoder outputs
    audio_proj2: torch.Tensor,
    text_ids: torch.Tensor,  # (B, T) int
) -> torch.Tensor:
    """(B, 389, D) = [a1 (129) | sep | a2 (129) | sep | text (T)], sep the
    embedding of ``cfg.sep_token_id``."""
    a1 = htsat.downsample_tokens_compact(audio_proj1)
    a2 = htsat.downsample_tokens_compact(audio_proj2)
    embed = params["decoder"]["embed"]
    dtext = embed[text_ids.long()]
    sep = embed[cfg.sep_token_id].expand(a1.shape[0], 1, embed.shape[1])
    return torch.cat([a1, sep, a2, sep, dtext], dim=1)


@torch.no_grad()
def encode_and_prefix(
    params: dict, cfg: MellowConfig, audio1: torch.Tensor, audio2: torch.Tensor, text_ids: torch.Tensor
) -> torch.Tensor:
    """Encode both clips (one batch-B encoder call each) and assemble the
    prefix."""
    p1 = htsat.encode_audio_compact(audio1, params, cfg.frontend, cfg.encoder)
    p2 = htsat.encode_audio_compact(audio2, params, cfg.frontend, cfg.encoder)
    return build_prefix(params, cfg, p1, p2, text_ids)


def generate_tokens(
    params: dict,
    cfg: MellowConfig,
    audio1: torch.Tensor,  # (B, 320000)
    audio2: torch.Tensor,
    text_ids: torch.Tensor,  # (B, T)
    *,
    max_len: int,
    stop_token_id=None,  # default: cfg.stop_token_id
) -> gen.GenerateResult:
    """Two waveforms + prompt ids -> greedy token ids."""
    prefix = encode_and_prefix(params, cfg, audio1, audio2, text_ids)
    return gen.generate(
        params["decoder"], cfg.decoder, prefix, max_len=max_len,
        stop_token_id=cfg.stop_token_id if stop_token_id is None else stop_token_id,
    )


def init_params(cfg: MellowConfig, seed: int) -> dict:
    """Random full-model weights, as numpy float32 in the JAX package's
    tree (same keys and shapes as ``mellow_tpu.models.mellow.init_params``;
    the values differ, since that one draws the decoder from jax.random).
    Kernels are N(0, 0.02); biases zero; norms identity."""
    rng = np.random.default_rng(seed)
    enc = cfg.encoder
    dec = cfg.decoder

    def nrm(*shape):
        return (rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02))

    def ln(dim):
        return {"scale": np.ones((dim,), np.float32), "bias": np.zeros((dim,), np.float32)}

    def lin(i, o, bias=True):
        p = {"kernel": nrm(i, o)}
        if bias:
            p["bias"] = np.zeros((o,), np.float32)
        return p

    stages = []
    dim = enc.embed_dim
    for si, depth in enumerate(enc.depths):
        blocks = [
            {
                "norm1": ln(dim),
                "qkv": lin(dim, 3 * dim),
                "proj": lin(dim, dim),
                "rel_bias_table": nrm((2 * enc.window_size - 1) ** 2, enc.num_heads[si]),
                "norm2": ln(dim),
                "fc1": lin(dim, 4 * dim),
                "fc2": lin(4 * dim, dim),
            }
            for _ in range(depth)
        ]
        stage = {"blocks": blocks}
        if si < len(enc.depths) - 1:
            stage["downsample"] = {"norm": ln(4 * dim), "reduction": lin(4 * dim, 2 * dim, bias=False)}
            dim *= 2
        stages.append(stage)

    nf, nc = enc.num_features, enc.num_classes
    L, D, I = dec.num_layers, dec.hidden_size, dec.intermediate_size
    H, KV, hd = dec.num_heads, dec.num_kv_heads, dec.head_dim
    decoder = {
        "embed": nrm(dec.vocab_size, D),
        "layers": {
            "ln_attn": np.ones((L, D), np.float32),
            "ln_mlp": np.ones((L, D), np.float32),
            "wq": nrm(L, D, H * hd),
            "wk": nrm(L, D, KV * hd),
            "wv": nrm(L, D, KV * hd),
            "wo": nrm(L, H * hd, D),
            "w_gate": nrm(L, D, I),
            "w_up": nrm(L, D, I),
            "w_down": nrm(L, I, D),
        },
        "norm_f": np.ones((D,), np.float32),
    }
    if not dec.tie_word_embeddings:
        decoder["lm_head"] = nrm(D, dec.vocab_size)
    return {
        "encoder": {
            "bn0": {
                "scale": np.ones((64,), np.float32),
                "bias": np.zeros((64,), np.float32),
                "mean": np.zeros((64,), np.float32),
                "var": np.ones((64,), np.float32),
            },
            "patch_embed": {
                "kernel": nrm(enc.patch_size ** 2, enc.embed_dim),
                "bias": np.zeros((enc.embed_dim,), np.float32),
                "norm": ln(enc.embed_dim),
            },
            "stages": stages,
            "norm": ln(nf),
            "tscam_conv": {"kernel": nrm(nf * 2 * 3, nc), "bias": np.zeros((nc,), np.float32)},
            "head": lin(nc, nc),
        },
        "c2l": lin(nc, nf),
        "projection": {
            "linear1": lin(nf, cfg.d_proj, bias=False),
            "linear2": lin(cfg.d_proj, cfg.d_proj, bias=False),
            "layer_norm": ln(cfg.d_proj),
        },
        "decoder": decoder,
    }
