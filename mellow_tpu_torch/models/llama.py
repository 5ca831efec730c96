"""Llama-architecture causal LM (SmolLM2-135M shape) in PyTorch.

Port of ``mellow_tpu/models/llama.py`` in its fp32 parity mode and its bf16
perf mode: RMSNorm (in fp32, cast back), HF half-split RoPE, GQA attention
that contracts query-head groups against the KV heads without repeating
them, the SiLU-gated MLP and tied logits.

In bf16 the port takes the JAX package's kernel paths: the prefill runs
each layer as the attention block then the MLP block
(``ops/attn_block.py``, ``ops/mlp_block.py``), and the decode step's
attention is ``ops/decode_attention.py``; each is the hand-written CUDA
kernel on the card and its plain PyTorch version on the CPU. fp32 keeps the
plain formulation below. (The TPU's VMEM gate on its decode kernel is not
carried over: the math is the same either way, and the card's kernel has
no such limit.)

Parameters are per layer (the JAX tree stacks them on a leading L axis;
``models/params.py`` unstacks):

  params = {
    "embed": (V, D),
    "layers": [ {"ln_attn": (D,), "ln_mlp": (D,), "wq": (D, H*hd),
                 "wk": (D, KV*hd), "wv": (D, KV*hd), "wo": (H*hd, D),
                 "w_gate": (D, I), "w_up": (D, I), "w_down": (I, D)}, ... ],
    "norm_f": (D,),
  }

The KV cache is a static buffer (L, B, S_max, KV, hd) in the compute dtype,
written in place. Not ported: the packed-lane cache, pending/flush windows,
chunked prefill, int8 and W8A8.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mellow_tpu_torch.config import LlamaConfig
from mellow_tpu_torch.ops.attn_block import attn_block
from mellow_tpu_torch.ops.decode_attention import decode_attention
from mellow_tpu_torch.ops.mlp_block import mlp_block, rms_norm


class KVCache(NamedTuple):
    """Static-shape cache; k, v: (L, B, S_max, KV, hd). Positions beyond
    what has been written are never read."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def create(cfg: LlamaConfig, batch: int, max_len: int, device,
               dtype: torch.dtype = torch.float32) -> "KVCache":
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
        )


def rope_tables(cfg: LlamaConfig, max_len: int, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin tables (max_len, hd), HF convention: emb = concat(freqs, freqs)."""
    inv_freq = 1.0 / (
        cfg.rope_theta ** (np.arange(0, cfg.head_dim, 2, dtype=np.float64) / cfg.head_dim)
    )
    t = np.arange(max_len, dtype=np.float64)
    freqs = np.outer(t, inv_freq)  # (S, hd/2)
    emb = np.concatenate([freqs, freqs], axis=-1)  # (S, hd)
    return np.cos(emb).astype(dtype), np.sin(emb).astype(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (S, hd). HF rotate_half convention."""
    x1, x2 = x.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    return x * cos[None, :, None, :] + rotated * sin[None, :, None, :]


def rope_device_tables(cfg: LlamaConfig, max_len: int, dtype: torch.dtype, device):
    """``rope_tables`` as tensors in the compute dtype on ``device`` (the
    JAX package builds them in the compute dtype too)."""
    cos, sin = rope_tables(cfg, max_len)
    return (torch.from_numpy(cos).to(device=device, dtype=dtype),
            torch.from_numpy(sin).to(device=device, dtype=dtype))


def uses_fused_prefill(cfg: LlamaConfig, x: torch.Tensor) -> bool:
    """The JAX package's gate for the fused prefill blocks
    (``llama.prefill``): bf16, S <= 1024, and the attention and MLP weights
    within their VMEM budgets. The port applies it on every device: the
    CUDA kernels on the card, their plain versions on the CPU."""
    D, H, KV, hd = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn_bytes = 2 * D * (2 * H + 2 * KV) * hd + 2 * ((H * hd) ** 2 + (KV * hd) ** 2)
    mlp_bytes = 2 * 3 * D * cfg.intermediate_size
    return (x.dtype == torch.bfloat16 and x.shape[1] <= 1024
            and attn_bytes < 8 * 1024 * 1024 and mlp_bytes < 12 * 1024 * 1024)


def _mlp(cfg: LlamaConfig, x: torch.Tensor, lp: dict) -> torch.Tensor:
    h = rms_norm(x, lp["ln_mlp"], cfg.rms_norm_eps)
    return x + (F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]


def _qkv(cfg: LlamaConfig, x: torch.Tensor, lp: dict, cos, sin):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["ln_attn"], cfg.rms_norm_eps)
    q = apply_rope((h @ lp["wq"]).reshape(B, S, H, hd), cos, sin)
    k = apply_rope((h @ lp["wk"]).reshape(B, S, KV, hd), cos, sin)
    v = (h @ lp["wv"]).reshape(B, S, KV, hd)
    return q, k, v


def _attend(cfg: LlamaConfig, q, k, v, mask) -> torch.Tensor:
    """GQA without repeating KV: query heads grouped (KV, rep) contract
    against their KV head. q: (B, S, H, hd); k, v: (B, T, KV, hd); mask
    additive (S, T) or None. Returns (B, S, H*hd)."""
    B, S, H, hd = q.shape
    KV = cfg.num_kv_heads
    qg = q.reshape(B, S, KV, H // KV, hd)
    attn = torch.einsum("bqhrd,bkhd->bhrqk", qg, k) * (1.0 / np.sqrt(hd))
    if mask is not None:
        attn = attn + mask
    attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)  # fp32 softmax, as the JAX path
    return torch.einsum("bhrqk,bkhd->bqhrd", attn, v).reshape(B, S, H * hd)


def logits_from_hidden(params: dict, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    return x @ head


def prefill(params: dict, cfg: LlamaConfig, inputs_embeds: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """Run the prefix (B, S, D) through the model, writing positions [0, S)
    of ``cache`` in place. Returns the post-final-norm hidden of the last
    position, (B, D)."""
    B, S, D = inputs_embeds.shape
    device = inputs_embeds.device
    cos, sin = rope_device_tables(cfg, S, inputs_embeds.dtype, device)
    if uses_fused_prefill(cfg, inputs_embeds):
        x = inputs_embeds
        for li, lp in enumerate(params["layers"]):
            x, _, _ = attn_block(
                x, lp["ln_attn"], lp["wq"], lp["wk"], lp["wv"], lp["wo"], cos, sin,
                num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                eps=cfg.rms_norm_eps, k_out=cache.k[li, :, :S], v_out=cache.v[li, :, :S],
            )
            x = mlp_block(x, lp["ln_mlp"], lp["w_gate"], lp["w_up"], lp["w_down"],
                          eps=cfg.rms_norm_eps)
        return rms_norm(x[:, -1, :], params["norm_f"], cfg.rms_norm_eps)
    causal = torch.ones((S, S), dtype=torch.bool, device=device).tril()
    mask = torch.zeros((S, S), dtype=torch.float32, device=device).masked_fill(~causal, float("-inf"))

    x = inputs_embeds
    for li, lp in enumerate(params["layers"]):
        q, k, v = _qkv(cfg, x, lp, cos, sin)
        cache.k[li, :, :S] = k
        cache.v[li, :, :S] = v
        x = x + _attend(cfg, q, k, v, mask) @ lp["wo"]
        x = _mlp(cfg, x, lp)
    # The final norm is per position: only the last row feeds decoding.
    return rms_norm(x[:, -1, :], params["norm_f"], cfg.rms_norm_eps)


def decode_step(
    params: dict,
    cfg: LlamaConfig,
    token_embed: torch.Tensor,  # (B, D) embedding of the token just chosen
    cache: KVCache,
    pos: int,  # this token's position; positions [0, pos) are cached
    cos_full: torch.Tensor,  # (S_max, hd) rope tables on the device
    sin_full: torch.Tensor,
) -> torch.Tensor:
    """One incremental step: writes this token's k/v at ``pos`` in place and
    attends over positions [0, pos]. Returns the post-final-norm hidden
    (B, D). In bf16 the attention is the decode-attention kernel (its plain
    version on the CPU); the projections and the MLP stay plain matmuls, as
    the JAX package leaves them to XLA."""
    cos = cos_full[pos : pos + 1]
    sin = sin_full[pos : pos + 1]
    x = token_embed[:, None, :]
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.head_dim
    for li, lp in enumerate(params["layers"]):
        q, k, v = _qkv(cfg, x, lp, cos, sin)
        cache.k[li, :, pos : pos + 1] = k
        cache.v[li, :, pos : pos + 1] = v
        if x.dtype == torch.bfloat16:
            o = decode_attention(q.reshape(B, H, hd), cache.k[li], cache.v[li], pos + 1)
            o = o.reshape(B, 1, H * hd)
        else:
            o = _attend(cfg, q, cache.k[li, :, : pos + 1], cache.v[li, :, : pos + 1], None)
        x = _mlp(cfg, x + o @ lp["wo"], lp)
    return rms_norm(x[:, 0, :], params["norm_f"], cfg.rms_norm_eps)
