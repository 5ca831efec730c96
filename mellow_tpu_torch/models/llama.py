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

int8 options, as in the JAX package (bf16 or fp32 compute):

  * int8 weights (``quantize_decoder``): every per-layer matmul kernel and
    the logits head become ``{"q": int8 (in, out), "scale": (out,)}``. The
    decode step's products are plain ``(x @ q) * scale`` (``_mm``); the
    fused prefill blocks take the weights dequantized per layer
    (``_deq_weight``), or, with ``w8a8``, run as the W8A8 blocks
    (``ops/attn_block_w8a8.py``, ``ops/mlp_block_w8a8.py``).
  * an int8 KV cache (``KVCache.create(..., torch.int8)``): per-position
    scales over all KV heads together (``quantize_kv``). The bf16 prefill
    blocks quantize k/v in their ``kv_quant`` mode; the plain prefill
    quantizes the k/v it computed (the JAX package's non-fused prefill).
    The decode step runs in flush windows of W steps, as the JAX package's
    decode does (``decode_step``'s pending rows, ``flush_pending``): each
    step's k/v row goes into a ``FlushWindow`` in the compute dtype, the
    attention reads the flushed int8 positions plus the window's rows as
    extra positions, and a full window is quantized into the cache at once.
    Under bf16 the attention is ``ops/decode_attention_int8.py``'s kernel;
    under fp32 it is the plain formulation ``_attend_window``, the JAX
    package's einsum step, which never routes fp32 to a kernel.

A float cache in another dtype than the compute dtype (a bf16 cache under
fp32, an fp32 or fp16 cache under bf16) decodes through the same
``FlushWindow``, cast at its flush instead of quantized, and
``_attend_window``: the JAX package keeps a window's pending rows in the
compute dtype and sends these caches down its einsum path.

Continuous batching (``models/continuous.py``) passes ``decode_step`` a
per-row ``start``: row b's sequence begins at cache column ``start[b]``,
its prefix prefilled at local positions. The step ropes row b at its
local position ``pos - start[b]`` and attends to columns ``[start[b],
pos]`` only; the bf16 and int8 kernels take the same ``start``.

The bf16 decode step on the card replays a CUDA graph (``DecodeWorkspace``,
one per batch bucket, cache length and weight set, at most ``WORKSPACES``
kept; a call of B rows decodes in the first B rows of the power-of-two
bucket at or above B, ``batch_bucket``): the whole step, 30 layers of
RMSNorm, q/k/v products, rope, the cache write, #2, ``wo``, the MLP and the
final norm (``_decode_layers``, the eager step's own loop), captured from
the step's own kernels with the position and #2's length read on the card
(``decode_attention_cuda_at``). ``decode_step`` replays it where
``generate`` handed it a workspace's cache (``decode_workspace``); every
other step (the CPU, fp32, a windowed cache, a ``start``, ``tp``) runs
eagerly. ``utils.metrics.GLOBAL`` counts ``decode_graph_captures``,
``decode_graph_replays`` and ``decode_eager_steps``.

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
another float dtype or int8, written in place. Not ported: the packed-lane
cache, pending/flush windows for a cache in the compute dtype (a pending
row in the cache's own dtype changes nothing), chunked prefill.

``forward`` is the teacher-forced pass of training, on the plain
formulation in every dtype (the JAX package's ``forward`` never takes its
kernels either), so autograd differentiates it.

Tensor parallelism: ``forward``, ``prefill``, ``decode_step`` and
``logits_from_hidden`` take an optional ``tp`` (a ``parallel.tensor.TP``:
the model group). With it, the parameters are the rank's shards
(``parallel/sharding.py``; the token embedding is ``tensor.embed``'s
vocab-parallel lookup, in ``models/mellow.py`` and ``generate``), the
layers run ``parallel/tensor.py``'s TP forms on
``tensor.local_config(cfg, tp)``, the cache holds the rank's KV heads, and
the plain formulation replaces every kernel, as the JAX package turns its
Pallas kernels off under a model axis. With ``tp=None`` nothing changes.
"""

from __future__ import annotations

import copy
import threading
import warnings
from collections import OrderedDict
from contextlib import contextmanager
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mellow_tpu_torch.config import LlamaConfig
from mellow_tpu_torch.ops.attn_block import attn_block
from mellow_tpu_torch.ops.attn_block_w8a8 import attn_block_w8a8
from mellow_tpu_torch.ops.decode_attention import decode_attention, decode_attention_cuda_at, start_mask
from mellow_tpu_torch.ops.decode_attention_int8 import decode_attention_int8
from mellow_tpu_torch.ops.mlp_block import mlp_block, rms_norm
from mellow_tpu_torch.ops.mlp_block_w8a8 import mlp_block_w8a8
from mellow_tpu_torch.parallel import tensor as tpar
from mellow_tpu_torch.utils import debug
from mellow_tpu_torch.utils.metrics import GLOBAL as metrics
from mellow_tpu_torch.utils.profiling import annotate


class KVCache(NamedTuple):
    """Static-shape cache; k, v: (L, B, S_max, KV, hd). Positions beyond
    what has been written are never read. An int8 cache also holds fp32
    per-position scales k_scale, v_scale: (L, B, S_max)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @staticmethod
    def create(cfg: LlamaConfig, batch: int, max_len: int, device,
               dtype: torch.dtype = torch.float32) -> "KVCache":
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        scales = {}
        if dtype == torch.int8:
            scales = {n: torch.zeros(shape[:3], dtype=torch.float32, device=device)
                      for n in ("k_scale", "v_scale")}
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            **scales,
        )

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


class FlushWindow:
    """The flush window of an int8 cache, or of a float cache in another
    dtype than the compute dtype: the k/v rows of the window's steps in the
    compute dtype, ``k``, ``v`` (L, B, W, KV, hd), rows [0, count) live,
    covering positions [flushed, flushed + count). The JAX package's
    pending rows (``extras`` of its packed decode)."""

    def __init__(self, cfg: LlamaConfig, batch: int, window: int, flushed: int, device,
                 dtype: torch.dtype, tp=None):
        shape = (cfg.num_layers, batch, window) + self.row_shape(cfg)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.flushed = flushed
        self.count = 0
        self.tp = tp  # the model group whose ranks share an int8 scale

    @staticmethod
    def row_shape(cfg: LlamaConfig) -> tuple:
        """One position's k (or v) row: (KV, hd), as in the cache."""
        return (cfg.num_kv_heads, cfg.head_dim)

    @property
    def size(self) -> int:
        return self.k.shape[2]

    def select(self, rows: torch.Tensor) -> "FlushWindow":
        """This window over the batch rows ``rows`` (a cascade compaction,
        ``generate._compact_state``): only between windows, when it holds
        no row."""
        if self.count:
            raise ValueError(f"a flush window holding {self.count} rows cannot be compacted")
        out = copy.copy(self)
        out.k, out.v = self.k[:, rows], self.v[:, rows]
        return out

    def flush(self, cache: "KVCache") -> None:
        """Write the window's rows into ``cache`` at [flushed, flushed + W),
        quantized with one scale per position for an int8 cache
        (``flush_pending``), cast for a float one, and start the next
        window."""
        W = self.size
        write_rows(cache, slice(None), self.flushed, self.k, self.v, self.tp)
        self.flushed += W
        self.count = 0


def write_rows(cache: "KVCache", layers, pos: int, k: torch.Tensor, v: torch.Tensor, tp=None) -> None:
    """Write k/v rows (..., B, S, KV, hd) into ``cache`` at [pos, pos + S)
    of the layers ``layers`` (an index or a slice): quantized per position
    (``quantize_kv``, its scale over the KV heads of every rank of ``tp``)
    for an int8 cache, cast for a float one."""
    S = k.shape[-3]
    if not cache.quantized:
        cache.k[layers, :, pos : pos + S] = k
        cache.v[layers, :, pos : pos + S] = v
        return
    for rows, vals, scales in ((k, cache.k, cache.k_scale), (v, cache.v, cache.v_scale)):
        q8, sc = quantize_kv(rows.reshape(*rows.shape[:-2], -1), tp)
        vals[layers, :, pos : pos + S] = q8.reshape(rows.shape)
        scales[layers, :, pos : pos + S] = sc


def quantize_kv(x: torch.Tensor, tp=None):
    """Symmetric per-position int8 over the last (packed KV*hd) axis:
    x (..., KV*hd) -> (int8 (..., KV*hd), fp32 scale (...)).
    (``llama.quantize_kv``: one scale per position for all KV heads, the
    heads of every rank of ``tp`` included.)"""
    xf = x.float()
    amax = xf.abs().amax(-1)
    if tp is not None:
        amax = tpar.kv_amax(amax, tp)
    scale = amax.clamp_min(1e-8) / 127.0
    return torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8), scale


def quantize_weight(w: torch.Tensor) -> dict:
    """Symmetric per-output-column int8 of a (..., in, out) kernel: the scale
    is taken over the contraction axis (``llama.quantize_weight``)."""
    wf = w.float()
    scale = wf.abs().amax(-2, keepdim=True).clamp_min(1e-12) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8).contiguous()
    return {"q": q, "scale": scale.squeeze(-2)}


_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_decoder(params: dict, cfg: LlamaConfig) -> dict:
    """int8 weights (``llama.quantize_decoder``): every per-layer matmul
    kernel, plus ``lm_head_q``, the logits head quantized from ``embed.T``
    (tied) or ``lm_head``, which ``logits_from_hidden`` prefers. The
    embedding gather keeps the float table. Quantize the fp32 weights, then
    cast the floating leaves to the compute dtype, as the JAX wrapper does."""
    out = dict(params)
    out["layers"] = [{**lp, **{k: quantize_weight(lp[k]) for k in _QUANT_KEYS}}
                     for lp in params["layers"]]
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    out["lm_head_q"] = quantize_weight(head)
    return out


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a float kernel; for an int8 ``{"q", "scale"}`` kernel,
    (x @ q) * scale in x's dtype, the scale folded in after the product."""
    if isinstance(w, dict):
        return (x @ w["q"].to(x.dtype)) * w["scale"].to(x.dtype)
    return x @ w


def _deq_weight(w, dtype: torch.dtype) -> torch.Tensor:
    """An int8 ``{"q", "scale"}`` kernel as a dense ``dtype`` kernel (q * scale
    in fp32, rounded once), for the fused prefill blocks; a float kernel as
    it is."""
    if isinstance(w, dict):
        return (w["q"].float() * w["scale"][None, :].float()).to(dtype)
    return w


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
    """x: (B, S, H, hd); cos/sin: (S, hd), or (B, S, hd) per row. HF
    rotate_half convention."""
    x1, x2 = x.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    cos, sin = (cos[None, :, None, :], sin[None, :, None, :]) if cos.ndim == 2 else (cos[:, :, None], sin[:, :, None])
    return x * cos + rotated * sin


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
    return x + _mm(F.silu(_mm(h, lp["w_gate"])) * _mm(h, lp["w_up"]), lp["w_down"])


def _qkv(cfg: LlamaConfig, x: torch.Tensor, lp: dict, cos, sin):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["ln_attn"], cfg.rms_norm_eps)
    q = apply_rope(_mm(h, lp["wq"]).reshape(B, S, H, hd), cos, sin)
    k = apply_rope(_mm(h, lp["wk"]).reshape(B, S, KV, hd), cos, sin)
    v = _mm(h, lp["wv"]).reshape(B, S, KV, hd)
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


def _attend_window(cfg: LlamaConfig, q, cache: KVCache, li: int, n: int, k_extra, v_extra,
                   start: Optional[torch.Tensor]) -> torch.Tensor:
    """One decode step's attention over layer ``li`` of the cache, positions
    [0, n) ([start[b], n) for row b with a ``start``), plus the extra rows
    ``k_extra``, ``v_extra`` (B, E, KV, hd) in the compute dtype (the flush
    window's rows, this step's last), in plain PyTorch as the JAX package's
    einsum decode step computes it (``llama.decode_step``): the cached rows
    cast to the compute dtype, an int8 cache's k scales folded into the
    scores after the product and its v scales into the weights before it;
    one softmax in fp32 over the cached and the extra positions, its
    weights cast to the compute dtype. q: (B, 1, H, hd). Returns (B, 1,
    H*hd)."""
    B, _, H, hd = q.shape
    KV = cfg.num_kv_heads
    dt = q.dtype
    qg = q.reshape(B, KV, H // KV, hd)
    scale = 1.0 / np.sqrt(hd)
    s = torch.einsum("bgrd,bngd->bgrn", qg, cache.k[li, :, :n].to(dt)) * scale
    if cache.quantized:
        s = s * cache.k_scale[li][:, None, None, :n].to(dt)
    s = s.float()
    if start is not None:
        s = s.masked_fill(start_mask(start, n), float("-inf"))
    s_x = (torch.einsum("bgrd,bxgd->bgrx", qg, k_extra) * scale).float()
    m = torch.maximum(s.amax(-1, keepdim=True), s_x.amax(-1, keepdim=True))
    e, e_x = torch.exp(s - m).to(dt), torch.exp(s_x - m).to(dt)
    denom = e.sum(-1, keepdim=True) + e_x.sum(-1, keepdim=True)
    if cache.quantized:
        e = e * cache.v_scale[li][:, None, None, :n].to(dt)
    o = (torch.einsum("bgrn,bngd->bgrd", e, cache.v[li, :, :n].to(dt))
         + torch.einsum("bgrx,bxgd->bgrd", e_x, v_extra))
    return (o / denom).reshape(B, 1, H * hd)


def _layer_fns(cfg: LlamaConfig, tp):
    """(config, qkv, wo product, mlp) of a layer: the plain formulation's,
    or under ``tp`` the TP forms on the rank's configuration."""
    if tp is None:
        return cfg, _qkv, _mm, _mlp
    return (tpar.local_config(cfg, tp), lambda c, x, lp, cos, sin: tpar.qkv(c, x, lp, cos, sin, tp),
            lambda o, wo: tpar.attn_out(o, wo, tp), lambda c, x, lp: tpar.mlp(c, x, lp, tp))


def forward(params: dict, cfg: LlamaConfig, inputs_embeds: torch.Tensor, *,
            attention_mask: Optional[torch.Tensor] = None, remat: bool = False, tp=None) -> torch.Tensor:
    """Full-sequence teacher-forced forward (``llama.forward``): the
    embedded inputs (B, S, D) -> logits (B, S, V), causal, with keys where
    ``attention_mask`` (B, S) is 0 masked out. The plain formulation
    (``_qkv``, ``_attend``, ``_mlp``) in every dtype, as the JAX package's
    training forward, so autograd differentiates it; the prefill kernels
    have no backward. ``remat`` recomputes each layer's activations in the
    backward pass (``torch.utils.checkpoint``, the JAX package's
    ``jax.checkpoint``)."""
    B, S, D = inputs_embeds.shape
    device = inputs_embeds.device
    cos, sin = rope_device_tables(cfg, S, inputs_embeds.dtype, device)
    causal = torch.ones((S, S), dtype=torch.bool, device=device).tril()
    mask = torch.zeros((S, S), dtype=torch.float32, device=device).masked_fill(~causal, float("-inf"))
    if attention_mask is not None:
        pad = torch.zeros((B, 1, 1, 1, S), dtype=torch.float32, device=device).masked_fill(
            ~attention_mask.bool()[:, None, None, None, :], float("-inf"))
        mask = mask + pad  # (B, 1, 1, S, S): broadcast over (KV, rep)

    lcfg, qkv, out, mlp = _layer_fns(cfg, tp)

    def layer(x, lp):
        q, k, v = qkv(lcfg, x, lp, cos, sin)
        return mlp(lcfg, x + out(_attend(lcfg, q, k, v, mask), lp["wo"]), lp)

    x = inputs_embeds
    for lp in params["layers"]:
        x = checkpoint(layer, x, lp, use_reentrant=False) if remat else layer(x, lp)
    return logits_from_hidden(params, cfg, rms_norm(x, params["norm_f"], cfg.rms_norm_eps), tp)


def logits_from_hidden(params: dict, cfg: LlamaConfig, x: torch.Tensor, tp=None) -> torch.Tensor:
    """The logits over the vocabulary; under ``tp`` gathered from the
    ranks' vocabulary shards."""
    if tp is not None:
        return tpar.logits(params, cfg, x, tp)
    if "lm_head_q" in params:  # int8 weights (quantize_decoder)
        return _mm(x, params["lm_head_q"])
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    return x @ head


def uses_window(cache: KVCache, dtype: torch.dtype) -> bool:
    """Whether a cache decodes through a ``FlushWindow`` under compute
    ``dtype``: an int8 cache, or a float cache in another dtype."""
    return cache.quantized or cache.k.dtype != dtype


def prefill(params: dict, cfg: LlamaConfig, inputs_embeds: torch.Tensor, cache: KVCache,
            w8a8: bool = False, tp=None) -> torch.Tensor:
    """Run the prefix (B, S, D) through the model, writing positions [0, S)
    of ``cache`` in place. Returns the post-final-norm hidden of the last
    position, (B, D). ``w8a8``: with int8 weights, run the fused prefill
    blocks as W8A8 (the JAX package's ``prefill(w8a8=True)``); without it,
    int8 weights enter the bf16 blocks dequantized per layer. An int8
    cache takes the blocks' in-kernel k/v quantization, or in the plain
    prefill the quantizer after (``write_rows``); a float cache in another
    dtype takes the rows cast. ``tp``: the plain prefill's TP forms."""
    B, S, D = inputs_embeds.shape
    device = inputs_embeds.device
    with annotate("mellow.host_sync"):  # a copy from host memory: it waits for the stream (the encoder)
        cos, sin = rope_device_tables(cfg, S, inputs_embeds.dtype, device)
    if tp is None and uses_fused_prefill(cfg, inputs_embeds):
        kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                  eps=cfg.rms_norm_eps)
        w8 = w8a8 and isinstance(params["layers"][0]["w_gate"], dict)
        dt = inputs_embeds.dtype
        x = inputs_embeds
        # A float cache in another dtype: each block writes its k/v rows in
        # bf16 here, cast into the cache after.
        cast = None if cache.quantized or cache.k.dtype == dt else torch.empty(
            (2, B, S, cfg.num_kv_heads, cfg.head_dim), dtype=dt, device=device)
        for li, lp in enumerate(params["layers"]):
            kv = dict(k_out=cache.k[li, :, :S], v_out=cache.v[li, :, :S])
            if cache.quantized:
                kv.update(kv_quant=True, k_scale_out=cache.k_scale[li, :, :S],
                          v_scale_out=cache.v_scale[li, :, :S])
            elif cast is not None:
                kv = dict(k_out=cast[0], v_out=cast[1])
            if w8:
                ws = [t for k in ("wq", "wk", "wv", "wo") for t in (lp[k]["q"], lp[k]["scale"])]
                x = attn_block_w8a8(x, lp["ln_attn"], *ws, cos, sin, **kw, **kv)[0]
            else:
                ws = [_deq_weight(lp[k], dt) for k in ("wq", "wk", "wv", "wo")]
                x = attn_block(x, lp["ln_attn"], *ws, cos, sin, **kw, **kv)[0]
            if w8:
                ws = [t for k in ("w_gate", "w_up", "w_down") for t in (lp[k]["q"], lp[k]["scale"])]
                x = mlp_block_w8a8(x, lp["ln_mlp"], *ws, eps=cfg.rms_norm_eps)
            else:
                ws = [_deq_weight(lp[k], dt) for k in ("w_gate", "w_up", "w_down")]
                x = mlp_block(x, lp["ln_mlp"], *ws, eps=cfg.rms_norm_eps)
            if cast is not None:
                write_rows(cache, li, 0, cast[0], cast[1])
        return rms_norm(x[:, -1, :], params["norm_f"], cfg.rms_norm_eps)
    causal = torch.ones((S, S), dtype=torch.bool, device=device).tril()
    mask = torch.zeros((S, S), dtype=torch.float32, device=device).masked_fill(~causal, float("-inf"))

    lcfg, qkv, out, mlp = _layer_fns(cfg, tp)
    x = inputs_embeds
    for li, lp in enumerate(params["layers"]):
        q, k, v = qkv(lcfg, x, lp, cos, sin)
        write_rows(cache, li, 0, k, v, tp)
        x = x + out(_attend(lcfg, q, k, v, mask), lp["wo"])
        x = mlp(lcfg, x, lp)
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
    window: Optional[FlushWindow] = None,
    start: Optional[torch.Tensor] = None,  # (B,) int32: each row's first cache column
    tp=None,
) -> torch.Tensor:
    """One incremental step over positions [0, pos]. Returns the
    post-final-norm hidden (B, D). In bf16 the attention is a decode-attention
    kernel (its plain version on the CPU); the projections and the MLP stay
    plain matmuls, as the JAX package leaves them to XLA.

    A cache in the compute dtype is written at ``pos`` first and attended
    over [0, pos]: in bf16 by ``ops/decode_attention.py``, in fp32 by
    ``_attend``. Any other cache (int8, or a float cache in another dtype;
    ``uses_window``) takes this step's k/v row into ``window`` (row ``pos -
    window.flushed``; the JAX package's pending rows), attends over its
    flushed positions [0, window.flushed) plus the window's rows as extra
    positions, and, once the window is full, writes its rows into the
    cache; it raises without ``window``. The int8 cache under bf16 attends
    through ``ops/decode_attention_int8.py``, every other windowed cache
    through ``_attend_window``.

    ``start`` (continuous batching): row b ropes at its local position
    ``pos - start[b]`` (a (B, hd) gather of the tables on the device) and
    attends to columns [start[b], pos] only; ``pos`` stays the batch's
    shared write column.

    ``tp``: the TP forms on the rank's KV heads, every attention on the
    plain formulation (``_attend``, ``_attend_window``).

    On a ``DecodeWorkspace``'s cache, held by the call whose ``params`` these
    are, with its rope tables, a bf16 CUDA step with no ``window``,
    ``start`` or ``tp`` replays the workspace's CUDA graph of this body
    (``DecodeWorkspace.step``); every other step runs the body below."""
    ws = _graph_workspace(params, cfg, token_embed, cache, cos_full, sin_full, window, start, tp)
    hidden = None if ws is None else ws.step(params, token_embed, pos)
    if hidden is not None:
        return hidden
    metrics.count("decode_eager_steps")
    if start is None:
        cos, sin = cos_full[pos : pos + 1], sin_full[pos : pos + 1]
    else:
        local = pos - start.long()
        cos, sin = cos_full[local][:, None], sin_full[local][:, None]
    B, dt = token_embed.shape[0], token_embed.dtype
    lcfg = _layer_fns(cfg, tp)[0]
    H, hd = cfg.num_heads, cfg.head_dim
    kernel = tp is None and dt == torch.bfloat16
    windowed = uses_window(cache, dt)
    if windowed:
        if window is None:
            raise ValueError(f"a {cache.k.dtype} cache under {dt} decodes through a FlushWindow")
        i = pos - window.flushed
        if i != window.count or i >= window.size:
            raise ValueError(f"position {pos} is not the next row of the flush window "
                             f"({window.count} of {window.size} rows from {window.flushed})")

    def attend(li, q, k, v):
        if windowed:
            window.k[li, :, i] = k[:, 0]
            window.v[li, :, i] = v[:, 0]
            kx, vx = window.k[li, :, : i + 1], window.v[li, :, : i + 1]
            if cache.quantized and kernel:
                o = decode_attention_int8(q.reshape(B, H, hd), cache.k[li], cache.v[li], cache.k_scale[li],
                                          cache.v_scale[li], window.flushed, kx, vx, start)
                return o.reshape(B, 1, H * hd)
            return _attend_window(lcfg, q, cache, li, window.flushed, kx, vx, start)
        cache.k[li, :, pos : pos + 1] = k
        cache.v[li, :, pos : pos + 1] = v
        if kernel:
            o = decode_attention(q.reshape(B, H, hd), cache.k[li], cache.v[li], pos + 1, start)
            return o.reshape(B, 1, H * hd)
        mask = None
        if start is not None:
            mask = torch.zeros((B, 1, 1, 1, pos + 1), dtype=torch.float32, device=q.device).masked_fill(
                start_mask(start, pos + 1)[:, :, None], float("-inf"))
        return _attend(lcfg, q, cache.k[li, :, : pos + 1], cache.v[li, :, : pos + 1], mask)

    hidden = _decode_layers(params, cfg, token_embed, cos, sin, attend, tp)
    if windowed:
        window.count = i + 1
        if window.count == window.size:
            window.flush(cache)
    return hidden


def _decode_layers(params: dict, cfg: LlamaConfig, token_embed: torch.Tensor, cos, sin, attend, tp=None):
    """The decode step's layers and final norm on one position: ``token_embed``
    (B, D) -> the post-final-norm hidden (B, D). ``attend(li, q, k, v)`` keeps
    layer ``li``'s roped k and v (B, 1, KV, hd) where the step writes them and
    returns the attention of q (B, 1, H, hd) over the cached positions, (B, 1,
    H * hd); ``decode_step`` and the graph's body (``DecodeWorkspace``) differ
    only there."""
    lcfg, qkv, out, mlp = _layer_fns(cfg, tp)
    x = token_embed[:, None, :]
    for li, lp in enumerate(params["layers"]):
        q, k, v = qkv(lcfg, x, lp, cos, sin)
        x = mlp(lcfg, x + out(attend(li, q, k, v), lp["wo"]), lp)
    return rms_norm(x[:, 0, :], params["norm_f"], cfg.rms_norm_eps)


# ---------------------------------------------------------------------------
# the bf16 decode step as a CUDA graph
# ---------------------------------------------------------------------------

# Workspaces kept at once (batch buckets, cache lengths and weight sets).
WORKSPACES = 8
# A kept workspace makes room for a new key only once it has gone unused for
# this many calls; until then the new key's calls decode eagerly, so traffic
# with more live keys than WORKSPACES does not capture anew at every call.
IDLE_CALLS = 64
# Host passes of the step's body in a capture: the eager warm-up on a side
# stream and the capture itself. Each calls every kernel wrapper once.
CAPTURE_PASSES = 2
# CUDA's refusals of a stream capture, cudaErrorStreamCaptureUnsupported (900)
# to cudaErrorStreamCaptureWrongThread (908): the only errors after which a
# workspace stays eager instead of raising.
CAPTURE_REFUSED = range(900, 909)

_WORKSPACES: "OrderedDict[tuple, DecodeWorkspace]" = OrderedDict()
_WORKSPACES_LOCK = threading.Lock()
_calls = 0  # calls that asked decode_workspace for a workspace


def _step_weights(params: dict) -> list:
    """The tensors a decode step reads: each layer's weights (an int8
    kernel's q and scale) and the final norm."""
    return [t for lp in params["layers"] for w in lp.values()
            for t in (w.values() if isinstance(w, dict) else (w,))] + [params["norm_f"]]


def batch_bucket(batch: int) -> int:
    """The batch a workspace is made for: the power of two at or above
    ``batch``. A call of fewer rows uses the first ``batch`` of them."""
    return 1 << (batch - 1).bit_length()


def _capture_refused(e: BaseException) -> bool:
    """Whether ``e`` is CUDA refusing a capture: torch raises a CUDA error
    as an ``AcceleratorError`` (a RuntimeError) carrying its ``error_code``."""
    return getattr(e, "error_code", None) in CAPTURE_REFUSED


class DecodeWorkspace:
    """What the bf16 decode steps of one batch bucket, one cache length and
    one weight set keep on the card from call to call: the cache ``kv``
    (bucket, S_max), the rope tables ``cos``, ``sin`` for S_max (made once),
    the step's position ``pos`` (int64) and #2's length ``n`` (int32, pos + 1)
    as device scalars, and the CUDA graph of the step over the whole bucket
    with its static input ``x`` (bucket, D) and output ``out``. The call that
    holds it decodes its ``rows`` in the first rows of each (``cache``, a view
    of ``kv``); the rows past them are computed and ignored, each row's step
    reading only its own row. The cache is never zeroed: the prefill writes
    [0, P) and each step writes its position before #2 reads [0, pos]."""

    def __init__(self, cfg: LlamaConfig, batch: int, max_len: int, device, dtype: torch.dtype):
        self.cfg = cfg
        self.kv = KVCache.create(cfg, batch, max_len, device, dtype)
        self.rope = torch.stack(rope_device_tables(cfg, max_len, dtype, device))  # (2, S_max, hd)
        self.cos, self.sin = self.rope.unbind(0)
        self.pos = torch.zeros((1,), dtype=torch.int64, device=device)
        self.n = torch.zeros((1,), dtype=torch.int32, device=device)
        self.x = torch.zeros((batch, cfg.hidden_size), dtype=dtype, device=device)
        self.graph = self.out = None
        self.eager = False  # CUDA refused the capture: this workspace's steps stay eager
        self.owner = None  # id() of the params of the call that holds it
        self.rows, self.cache = batch, self.kv
        self.used = 0  # the last call that held it, in decode_workspace's count

    def _take(self, owner: int, rows: int) -> None:
        self.owner, self.rows = owner, rows
        self.cache = self.kv if rows == self.x.shape[0] else KVCache(self.kv.k[:, :rows], self.kv.v[:, :rows])

    def _body(self, params: dict) -> torch.Tensor:
        """``decode_step``'s bf16 body on ``x`` at the device position: the
        rope rows gathered, the k/v rows written and #2's length read on the
        card."""
        cfg, kv = self.cfg, self.kv
        B, H, hd = self.x.shape[0], cfg.num_heads, cfg.head_dim
        torch.add(self.pos, 1, out=self.n)
        cos, sin = self.rope.index_select(1, self.pos).unbind(0)

        def attend(li, q, k, v):
            kv.k[li].index_copy_(1, self.pos, k)
            kv.v[li].index_copy_(1, self.pos, v)
            return decode_attention_cuda_at(q.reshape(B, H, hd), kv.k[li], kv.v[li], self.n).reshape(B, 1, H * hd)

        return _decode_layers(params, cfg, self.x, cos, sin, attend)

    def _warm_up(self, params: dict) -> None:
        """The body run once on a side stream, as a capture wants."""
        device = self.x.device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._body(params)
        torch.cuda.current_stream(device).wait_stream(side)

    def _record(self, params: dict):
        """The body captured: (the graph, its output)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self._body(params)
        return graph, out

    def _capture(self, params: dict) -> bool:
        """``_warm_up``, then ``_record``; False, with a warning, where CUDA
        refused the capture (``CAPTURE_REFUSED``). Any other error raises."""
        self._warm_up(params)
        try:
            self.graph, self.out = self._record(params)
        except RuntimeError as e:
            if not _capture_refused(e):
                raise
            warnings.warn(f"decode step graph not captured, its steps stay eager: {e}", RuntimeWarning)
            self.eager = True
            return False
        metrics.count("decode_graph_captures")
        return True

    def step(self, params: dict, token_embed: torch.Tensor, pos: int) -> Optional[torch.Tensor]:
        """The step at ``pos``: a replay of the graph (captured at the first
        step), the held rows of its output copied out. None where CUDA
        refused the capture."""
        self.x[: self.rows].copy_(token_embed)
        self.pos.fill_(pos)
        if self.graph is None and not self._capture(params):
            return None
        self.graph.replay()
        metrics.count("decode_graph_replays")
        return self.out[: self.rows].clone()


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies where the step graph runs: on a CUDA device."""
    return t.is_cuda


def _graph_workspace(params, cfg, token_embed, cache, cos_full, sin_full, window, start, tp):
    """The workspace whose graph this step replays, or None: the step must
    be bf16 on the card with no window, start or tp, on a workspace's cache
    and rope tables, from the call that holds it, and with the tripwires
    off (a replay checks no output)."""
    if (start is not None or tp is not None or window is not None or not on_card(token_embed)
            or token_embed.dtype != torch.bfloat16 or debug.enabled()):
        return None
    with _WORKSPACES_LOCK:
        ws = next((w for w in _WORKSPACES.values() if w.cache is cache), None)
    if (ws is None or ws.eager or ws.owner != id(params) or cfg != ws.cfg or token_embed.shape[0] != ws.rows
            or cos_full is not ws.cos or sin_full is not ws.sin):
        return None
    return ws


@contextmanager
def decode_workspace(params: dict, cfg: LlamaConfig, batch: int, max_len: int, device, dtype: torch.dtype):
    """The ``DecodeWorkspace`` of (device, ``batch_bucket(batch)``, max_len,
    dtype, cfg, the ``data_ptr`` of each tensor the step reads), made at its
    first use and held for this call's ``batch`` rows until the block ends.
    None where another call holds it, or where ``WORKSPACES`` are kept and
    none of those that no call holds has gone unused for ``IDLE_CALLS``
    calls (else the least recently used such one is dropped for it)."""
    global _calls
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    bucket = batch_bucket(batch)
    key = (device, bucket, max_len, dtype, cfg, tuple(t.data_ptr() for t in _step_weights(params)))
    with _WORKSPACES_LOCK:
        _calls += 1
        ws = _WORKSPACES.get(key)
        if ws is None:
            if len(_WORKSPACES) >= WORKSPACES:
                stale = next((k for k, w in _WORKSPACES.items() if w.owner is None and _calls - w.used > IDLE_CALLS),
                             None)
                if stale is not None:
                    del _WORKSPACES[stale]
            if len(_WORKSPACES) < WORKSPACES:
                ws = _WORKSPACES[key] = DecodeWorkspace(cfg, bucket, max_len, device, dtype)
        elif ws.owner is not None:
            ws = None
        if ws is not None:
            _WORKSPACES.move_to_end(key)
            ws._take(id(params), batch)
            ws.used = _calls
    try:
        yield ws
    finally:
        if ws is not None:
            ws.owner = None
