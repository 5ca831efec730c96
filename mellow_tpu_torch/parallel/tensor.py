"""Tensor parallelism over the mesh's ``model`` axis: the collectives XLA
inserts for the JAX package's sharded decoder, written out.

Parameters are explicit local shards (plain tensors, ``sharding.shard_params``),
so the hand-written kernels and the plain formulation take them as they are.
Megatron-LM's three autograd functions carry activations across the model
group:

  * ``copy_to``: identity forward, all-reduce (sum) backward; in front of a
    column-parallel product, whose input is replicated and whose input
    gradient is a partial sum on each rank;
  * ``reduce_from``: all-reduce (sum) forward, identity backward; after a
    row-parallel product;
  * ``gather_from``: all-gather on the last axis forward, the rank's own
    slice backward; the vocab-sharded logits.

``torch.distributed.nn.functional``'s all_gather and all_reduce are not
these: their backward passes reduce again, which multiplies a gradient by
the group's size when every rank computes the same loss.

The TP forms of the decoder follow ``mellow_tpu/parallel/sharding.py``'s
specs: the embedding and the tied logits head vocab-sharded, ``w_gate`` and
``w_up`` column-parallel, ``w_down`` row-parallel, and the attention
sharded by KV head (``wq``/``wk``/``wv`` columns, ``wo`` rows) when the KV
heads divide by the group's size, else replicated. Contiguous column shards
of ``wq`` hold the query heads of the rank's KV heads, since ``_attend``
groups the query heads as (KV, H // KV). An int8 ``{"q", "scale"}`` shard
takes ``_mm``'s weight-only formulation. The decoder code runs on
``local_config``: the configuration with the rank's head, intermediate and
vocabulary counts.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from mellow_tpu_torch.models import llama


class TP(NamedTuple):
    """The model group of this rank: its process group, size and rank, and
    whether the attention heads are sharded (``num_kv_heads % size == 0``)."""

    group: object
    size: int
    rank: int
    heads: bool


def tp_of(mesh, num_kv_heads: int) -> TP:
    """The ``TP`` of ``mesh``'s model axis for a decoder of ``num_kv_heads``."""
    size = mesh.size(mesh.mesh_dim_names.index("model"))
    return TP(mesh.get_group("model"), size, mesh.get_local_rank("model"), num_kv_heads % size == 0)


def local_config(cfg, tp: TP):
    """``cfg`` (a ``LlamaConfig``) with this rank's heads, MLP width and
    vocabulary; raises where the model axis does not divide them."""
    kw = {"intermediate_size": cfg.intermediate_size, "vocab_size": cfg.vocab_size}
    if tp.heads:
        kw.update(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads)
    bad = {k: v for k, v in kw.items() if v % tp.size}
    if bad:
        raise ValueError(f"a model axis of {tp.size} does not divide {bad}")
    return dataclasses.replace(cfg, **{k: v // tp.size for k, v in kw.items()})


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        r, w = dist.get_rank(ctx.group), ctx.width
        return grad[..., r * w : (r + 1) * w].contiguous(), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherFrom.apply(x, group)


def embed(table: torch.Tensor, ids: torch.Tensor, tp: TP) -> torch.Tensor:
    """Vocab-parallel lookup: the rank's rows ``table`` (V / size, D) for the
    ids in its range, zeros for the others, summed over the group."""
    n = table.shape[0]
    local = ids.long() - tp.rank * n
    mine = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)] * mine[..., None].to(table.dtype)
    return reduce_from(rows, tp.group)


def logits(params: dict, cfg, x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The logits head on the rank's vocabulary (the int8 head, the tied
    embedding or ``lm_head``), gathered to the full vocabulary."""
    h = copy_to(x, tp.group)
    if "lm_head_q" in params:
        part = llama._mm(h, params["lm_head_q"])
    else:
        part = h @ (params["embed"].T if cfg.tie_word_embeddings else params["lm_head"])
    return gather_from(part, tp.group)


def qkv(lcfg, x: torch.Tensor, lp: dict, cos, sin, tp: TP):
    """``llama._qkv`` on the rank's heads (``lcfg = local_config(...)``);
    every head on each rank when the attention is replicated."""
    if not tp.heads:
        return llama._qkv(lcfg, x, lp, cos, sin)
    B, S, _ = x.shape
    H, KV, hd = lcfg.num_heads, lcfg.num_kv_heads, lcfg.head_dim
    h = copy_to(llama.rms_norm(x, lp["ln_attn"], lcfg.rms_norm_eps), tp.group)
    q = llama.apply_rope(llama._mm(h, lp["wq"]).reshape(B, S, H, hd), cos, sin)
    k = llama.apply_rope(llama._mm(h, lp["wk"]).reshape(B, S, KV, hd), cos, sin)
    v = llama._mm(h, lp["wv"]).reshape(B, S, KV, hd)
    return q, k, v


def attn_out(o: torch.Tensor, wo, tp: TP) -> torch.Tensor:
    """The attention's output product: row-parallel then summed over the
    group when the heads are sharded, the replicated product otherwise."""
    out = llama._mm(o, wo)
    return reduce_from(out, tp.group) if tp.heads else out


def mlp(lcfg, x: torch.Tensor, lp: dict, tp: TP) -> torch.Tensor:
    """``x + (silu(h @ w_gate) * (h @ w_up)) @ w_down``: gate and up
    column-parallel, down row-parallel, then summed over the group."""
    h = copy_to(llama.rms_norm(x, lp["ln_mlp"], lcfg.rms_norm_eps), tp.group)
    part = llama._mm(F.silu(llama._mm(h, lp["w_gate"])) * llama._mm(h, lp["w_up"]), lp["w_down"])
    return x + reduce_from(part, tp.group)


def kv_amax(amax: torch.Tensor, tp: TP) -> torch.Tensor:
    """An int8 cache's per-position amax over every KV head: the rank's
    heads' amax, maxed over the group when the heads are sharded."""
    if tp.heads:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=tp.group)
    return amax
