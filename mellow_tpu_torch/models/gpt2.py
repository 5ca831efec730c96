"""GPT-2 causal LM (the reference's second decoder family) in PyTorch.

Port of ``mellow_tpu/models/gpt2.py``: learned positional embeddings,
pre-LN blocks, full multi-head attention (KV heads == heads), GELU in its
tanh form (GPT-2's "gelu_new"), a tied LM head and LayerNorm with bias, in
fp32 parity mode and in bf16 perf mode. In bf16 the prefill's attention is
``ops/flash_gqa_prefill.py`` (the hand-written CUDA kernel on the card, its
plain PyTorch version on the CPU), as the JAX package runs its Pallas
kernel there; fp32 keeps the plain formulation below.

int8 weights (``quantize_gpt2``, bf16 compute): every per-layer matmul
kernel becomes ``{"q": int8 (in, out), "scale": (out,)}`` and the logits
head gets a quantized copy, ``wte_head_q``; the products are
``llama._mm``'s ``(x @ q) * scale``. GPT-2 has no int8 KV cache and no W8A8
path, in the JAX package as here.

Parameters are per layer (the JAX tree stacks them on a leading L axis;
``models/params.py`` unstacks):

  params = {
    "wte": (V, D), "wpe": (P, D),
    "layers": [ {"ln1_g", "ln1_b", "ln2_g", "ln2_b": (D,),
                 "w_qkv": (D, 3D), "b_qkv": (3D,), "w_o": (D, D), "b_o": (D,),
                 "w_fc": (D, 4D), "b_fc": (4D,), "w_proj": (4D, D),
                 "b_proj": (D,)}, ... ],
    "lnf_g", "lnf_b": (D,),
  }

The KV cache is a static buffer (L, B, S_max, D), heads packed along D,
written in place. A cache in the compute dtype takes each decode step's
row at once, then the step attends over it. A cache in another float dtype
(a bf16 cache under fp32, an fp32 or fp16 cache under bf16) decodes as the
JAX package's einsum step does: the prefill writes its rows cast to the
cache's dtype, the step reads the flushed rows back in the compute dtype,
and the rows of the current flush window stay in the compute dtype
(``FlushWindow``) until the window's last step writes them into the cache.

``forward`` is the teacher-forced pass of training (``gpt2.forward``): the
plain formulation in every dtype, as in the JAX package, so autograd
differentiates it; the prefill's kernel has no backward.

One deliberate difference: GPT-2 has ``max_position_embeddings`` learned
positions, and the JAX package's gather silently clamps past them;
``models/generate.py`` raises before the prefill instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mellow_tpu_torch.models import llama
from mellow_tpu_torch.models.llama import _mm, quantize_weight
from mellow_tpu_torch.ops.flash_gqa_prefill import flash_gqa_prefill


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class GPT2Cache(NamedTuple):
    k: torch.Tensor  # (L, B, S_max, D), heads packed along D
    v: torch.Tensor

    @staticmethod
    def create(cfg: GPT2Config, batch: int, max_len: int, device,
               dtype: torch.dtype = torch.float32) -> "GPT2Cache":
        if not dtype.is_floating_point:
            # No quantized-cache path (no scale fields): a cast would
            # silently truncate (-1, 1) values to 0.
            raise ValueError(
                f"gpt2 KV cache requires a floating dtype, got {dtype}; "
                "kv_cache_dtype='int8' is a llama-family-only perf mode"
            )
        shape = (cfg.num_layers, batch, max_len, cfg.hidden_size)
        return GPT2Cache(torch.zeros(shape, dtype=dtype, device=device),
                         torch.zeros(shape, dtype=dtype, device=device))


class FlushWindow(llama.FlushWindow):
    """The flush window of a cache in another float dtype than the compute
    dtype: ``k``, ``v`` (L, B, W, D) in the compute dtype, heads packed as
    in the cache (the JAX package's pending rows)."""

    @staticmethod
    def row_shape(cfg: GPT2Config) -> tuple:
        return (cfg.hidden_size,)

    def flush(self, cache: GPT2Cache) -> None:
        """Write the window's rows into ``cache`` at [flushed, flushed + W),
        cast to its dtype, and start the next window."""
        W = self.size
        cache.k[:, :, self.flushed : self.flushed + W] = self.k
        cache.v[:, :, self.flushed : self.flushed + W] = self.v
        self.flushed += W
        self.count = 0


def uses_window(cache: GPT2Cache, dtype: torch.dtype) -> bool:
    """Whether a cache decodes through a ``FlushWindow`` under compute
    ``dtype``: a cache in another float dtype."""
    return cache.k.dtype != dtype


_QUANT_KEYS = ("w_qkv", "w_o", "w_fc", "w_proj")


def quantize_gpt2(params: dict, cfg: GPT2Config) -> dict:
    """int8 weights (``gpt2.quantize_gpt2``): every per-layer matmul kernel,
    plus ``wte_head_q``, the logits head quantized from ``wte.T``, which
    ``logits_from_hidden`` prefers. Biases and the ``wte`` gather stay
    float. Quantize the fp32 weights, then cast the floating leaves to the
    compute dtype, as the JAX wrapper does."""
    out = dict(params)
    out["layers"] = [{**lp, **{k: quantize_weight(lp[k]) for k in _QUANT_KEYS}}
                     for lp in params["layers"]]
    out["wte_head_q"] = quantize_weight(params["wte"].T)
    return out


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm in x's dtype, as the JAX package computes it."""
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _gelu_new(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _attn_full(cfg: GPT2Config, q, k, v, mask) -> torch.Tensor:
    """q, k, v: (B, S, H, hd); mask additive (S, S_kv) fp32. The einsum path
    with an fp32 softmax."""
    attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / np.sqrt(cfg.head_dim))
    attn = attn + mask
    attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)


def _mlp(cfg: GPT2Config, x: torch.Tensor, lp: dict) -> torch.Tensor:
    h = _ln(x, lp["ln2_g"], lp["ln2_b"], cfg.layer_norm_eps)
    return x + _mm(_gelu_new(_mm(h, lp["w_fc"]) + lp["b_fc"]), lp["w_proj"]) + lp["b_proj"]


def _layer_full(cfg: GPT2Config, x: torch.Tensor, lp: dict, mask, use_kernel: bool):
    B, S, D = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    h = _ln(x, lp["ln1_g"], lp["ln1_b"], cfg.layer_norm_eps)
    qkv = _mm(h, lp["w_qkv"]) + lp["b_qkv"]
    q, k, v = qkv.split(D, dim=-1)
    if use_kernel:
        o = flash_gqa_prefill(q, k, v, num_heads=H, num_kv_heads=H, head_dim=hd)
    else:
        o = _attn_full(cfg, q.reshape(B, S, H, hd), k.reshape(B, S, H, hd),
                       v.reshape(B, S, H, hd), mask).reshape(B, S, D)
    x = x + _mm(o, lp["w_o"]) + lp["b_o"]
    return _mlp(cfg, x, lp), k, v


def prefill(params: dict, cfg: GPT2Config, inputs_embeds: torch.Tensor, cache: GPT2Cache) -> torch.Tensor:
    """Run the prefix (B, S, D) through the model, writing positions [0, S)
    of ``cache`` in place. Returns the post-final-norm hidden of the last
    position, (B, D)."""
    B, S, D = inputs_embeds.shape
    device = inputs_embeds.device
    x = inputs_embeds + params["wpe"][:S].to(inputs_embeds.dtype)
    # The JAX package's gate for its prefill attention kernel, with the card
    # in place of the TPU: a CUDA tensor takes the kernel, a CPU tensor its
    # plain version.
    use_kernel = inputs_embeds.dtype == torch.bfloat16 and S <= 1024
    mask = None
    if not use_kernel:
        causal = torch.ones((S, S), dtype=torch.bool, device=device).tril()
        mask = torch.zeros((S, S), dtype=torch.float32, device=device).masked_fill(~causal, float("-inf"))
    for li, lp in enumerate(params["layers"]):
        x, k, v = _layer_full(cfg, x, lp, mask, use_kernel)
        cache.k[li, :, :S] = k
        cache.v[li, :, :S] = v
    # The final norm is per position: only the last row feeds decoding.
    return _ln(x[:, -1, :], params["lnf_g"], params["lnf_b"], cfg.layer_norm_eps)


def forward(params: dict, cfg: GPT2Config, inputs_embeds: torch.Tensor, *, position_offset: int = 0,
            remat: bool = False) -> torch.Tensor:
    """Full-sequence teacher-forced forward (``gpt2.forward``): the
    embedded inputs (B, S, D) from position ``position_offset`` -> logits
    (B, S, V). The plain formulation in every dtype. ``remat`` recomputes
    each layer's activations in the backward pass
    (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``)."""
    B, S, D = inputs_embeds.shape
    device = inputs_embeds.device
    x = inputs_embeds + params["wpe"][position_offset : position_offset + S].to(inputs_embeds.dtype)
    causal = torch.ones((S, S), dtype=torch.bool, device=device).tril()
    mask = torch.zeros((S, S), dtype=torch.float32, device=device).masked_fill(~causal, float("-inf"))

    def layer(x, lp):
        return _layer_full(cfg, x, lp, mask, False)[0]

    for lp in params["layers"]:
        x = checkpoint(layer, x, lp, use_reentrant=False) if remat else layer(x, lp)
    x = _ln(x, params["lnf_g"], params["lnf_b"], cfg.layer_norm_eps)
    return x @ params["wte"].T.to(x.dtype)


def decode_step(params: dict, cfg: GPT2Config, token_embed: torch.Tensor, cache: GPT2Cache,
                pos: int, window: Optional[FlushWindow] = None) -> torch.Tensor:
    """One incremental step: ``token_embed`` (B, D) at position ``pos``;
    attends over [0, pos]. Returns the post-final-norm hidden (B, D).
    Rounding as ``gpt2.decode_step``: the scores in the compute dtype, then
    fp32; the exps cast back; the value product in the compute dtype.

    A cache in the compute dtype takes this step's k/v row first. A cache
    in another float dtype (``uses_window``) leaves it in ``window`` (row
    ``pos - window.flushed``), attends over the flushed positions read back
    in the compute dtype plus the window's rows, and once the window is
    full writes its rows into the cache; it raises without ``window``."""
    B, D = token_embed.shape
    H, hd = cfg.num_heads, cfg.head_dim
    n = pos + 1
    x = token_embed[:, None, :] + params["wpe"][pos].to(token_embed.dtype)
    windowed = uses_window(cache, x.dtype)
    if windowed:
        if window is None:
            raise ValueError(f"a {cache.k.dtype} cache under {x.dtype} decodes through a FlushWindow")
        i = pos - window.flushed
        if i != window.count or i >= window.size:
            raise ValueError(f"position {pos} is not the next row of the flush window "
                             f"({window.count} of {window.size} rows from {window.flushed})")
    scale = 1.0 / np.sqrt(hd)
    for li, lp in enumerate(params["layers"]):
        h = _ln(x, lp["ln1_g"], lp["ln1_b"], cfg.layer_norm_eps)
        qkv = _mm(h, lp["w_qkv"]) + lp["b_qkv"]
        q, k, v = qkv.split(D, dim=-1)  # (B, 1, D) each
        if windowed:
            window.k[li, :, i] = k[:, 0]
            window.v[li, :, i] = v[:, 0]
            kc = torch.cat([cache.k[li, :, : window.flushed].to(x.dtype), window.k[li, :, : i + 1]], dim=1)
            vc = torch.cat([cache.v[li, :, : window.flushed].to(x.dtype), window.v[li, :, : i + 1]], dim=1)
        else:
            cache.k[li, :, pos] = k[:, 0]
            cache.v[li, :, pos] = v[:, 0]
            kc, vc = cache.k[li, :, :n], cache.v[li, :, :n]
        kc, vc = kc.reshape(B, n, H, hd), vc.reshape(B, n, H, hd)
        s = (torch.einsum("bhd,bshd->bhs", q.reshape(B, H, hd), kc) * scale).float()
        e = torch.exp(s - s.amax(-1, keepdim=True)).to(x.dtype)
        o = torch.einsum("bhs,bshd->bhd", e, vc) / e.sum(-1, keepdim=True)
        x = x + _mm(o.reshape(B, 1, D), lp["w_o"]) + lp["b_o"]
        x = _mlp(cfg, x, lp)
    if windowed:
        window.count = i + 1
        if window.count == window.size:
            window.flush(cache)
    return _ln(x[:, 0, :], params["lnf_g"], params["lnf_b"], cfg.layer_norm_eps)


def logits_from_hidden(params: dict, cfg: GPT2Config, x: torch.Tensor) -> torch.Tensor:
    if "wte_head_q" in params:  # int8 weights (quantize_gpt2)
        return _mm(x, params["wte_head_q"])
    return x @ params["wte"].T


def init_params(cfg: GPT2Config, seed: int) -> dict:
    """Random weights as numpy float32 in the JAX package's stacked tree,
    equal to ``gpt2.init_params(jax.random.PRNGKey(seed), cfg)``: the same
    numpy generator, the same draws in the same order. Kernels N(0, 0.02),
    ``wpe`` N(0, 0.01); biases zero; norms identity."""
    g = np.random.default_rng(seed)
    L, D = cfg.num_layers, cfg.hidden_size

    def nrm(shape, std=0.02):
        return g.normal(0.0, std, shape).astype(np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    return {
        "wte": nrm((cfg.vocab_size, D)),
        "wpe": nrm((cfg.max_position_embeddings, D), 0.01),
        "layers": {
            "ln1_g": ones(L, D), "ln1_b": zeros(L, D),
            "ln2_g": ones(L, D), "ln2_b": zeros(L, D),
            "w_qkv": nrm((L, D, 3 * D)), "b_qkv": zeros(L, 3 * D),
            "w_o": nrm((L, D, D)), "b_o": zeros(L, D),
            "w_fc": nrm((L, D, 4 * D)), "b_fc": zeros(L, 4 * D),
            "w_proj": nrm((L, 4 * D, D)), "b_proj": zeros(L, D),
        },
        "lnf_g": ones(D), "lnf_b": zeros(D),
    }


def convert_hf_gpt2(sd, num_layers: int, prefix: str = "") -> dict:
    """HF GPT2LMHeadModel state_dict -> the JAX package's stacked tree, as
    numpy float32 (``gpt2.convert_hf_gpt2``). HF stores attention and MLP
    weights as Conv1D, already (in, out): no transpose."""

    def g(key):
        t = sd[prefix + key]
        return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t, np.float32)

    def stack(fmt):
        return np.stack([g(fmt.format(i)) for i in range(num_layers)], axis=0)

    return {
        "wte": g("transformer.wte.weight"),
        "wpe": g("transformer.wpe.weight"),
        "layers": {
            "ln1_g": stack("transformer.h.{}.ln_1.weight"),
            "ln1_b": stack("transformer.h.{}.ln_1.bias"),
            "ln2_g": stack("transformer.h.{}.ln_2.weight"),
            "ln2_b": stack("transformer.h.{}.ln_2.bias"),
            "w_qkv": stack("transformer.h.{}.attn.c_attn.weight"),
            "b_qkv": stack("transformer.h.{}.attn.c_attn.bias"),
            "w_o": stack("transformer.h.{}.attn.c_proj.weight"),
            "b_o": stack("transformer.h.{}.attn.c_proj.bias"),
            "w_fc": stack("transformer.h.{}.mlp.c_fc.weight"),
            "b_fc": stack("transformer.h.{}.mlp.c_fc.bias"),
            "w_proj": stack("transformer.h.{}.mlp.c_proj.weight"),
            "b_proj": stack("transformer.h.{}.mlp.c_proj.bias"),
        },
        "lnf_g": g("transformer.ln_f.weight"),
        "lnf_b": g("transformer.ln_f.bias"),
    }
