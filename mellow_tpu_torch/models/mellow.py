"""Mellow assembly in PyTorch: two audio encodings + prompt -> prefix -> LM.

Port of ``mellow_tpu/models/mellow.py``'s inference path and its training
objective (``forward_train``), for both decoder families
(``cfg.decoder_family``: "llama" or "gpt2"). The port's
parameter tree is the JAX tree with the decoder's stacked layers split per
layer (``models/params.py``); ``init_params`` builds the JAX-layout tree in
numpy, so full-width random weights need no JAX.

Under a mesh (``parallel/``): ``generate_tokens_sharded`` is JAX's
shard_map path, each data rank running the single-card program on its
rows; ``tp`` (the model group, llama only) runs the decoder's TP forms and
``data_group`` makes ``forward_train``'s loss the global batch's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from mellow_tpu_torch.config import MellowConfig
from mellow_tpu_torch.models import generate as gen
from mellow_tpu_torch.models import gpt2, htsat
from mellow_tpu_torch.models.decoders import get_decoder_ops
from mellow_tpu_torch.parallel import sharding
from mellow_tpu_torch.parallel import tensor as tpar
from mellow_tpu_torch.utils.profiling import annotate


def build_prefix(
    params: dict,
    cfg: MellowConfig,
    audio_proj1: torch.Tensor,  # (B, 33, D) compact encoder outputs, or (B, 1025, D)
    audio_proj2: torch.Tensor,
    text_ids: torch.Tensor,  # (B, T) int
    text_embeds: Optional[torch.Tensor] = None,  # (B, T, D): in place of embed[text_ids]
    compact: bool = True,
    tp=None,
) -> torch.Tensor:
    """(B, 389, D) = [a1 (129) | sep | a2 (129) | sep | text (T)], sep the
    embedding of ``cfg.sep_token_id`` in the family's token table. The
    audio inputs are the compact 33-row forms, or with ``compact=False``
    the full 1025-row ones, mean-pooled (``htsat.downsample_tokens``).
    ``tp``: the vocab-parallel lookups."""
    ds = htsat.downsample_tokens_compact if compact else htsat.downsample_tokens
    a1, a2 = ds(audio_proj1), ds(audio_proj2)
    embed = get_decoder_ops(cfg.decoder_family).embed_table(params["decoder"])
    lookup = _lookup(embed, tp)
    dtext = lookup(text_ids.long()).to(a1.dtype) if text_embeds is None else text_embeds
    sep_id = cfg.sep_token_id
    sep = embed[sep_id] if tp is None else lookup(torch.full((1,), sep_id, device=a1.device))[0]
    sep = sep.to(a1.dtype).expand(a1.shape[0], 1, embed.shape[1])
    return torch.cat([a1, sep, a2, sep, dtext], dim=1)


def _lookup(embed: torch.Tensor, tp):
    """ids -> rows of the token table ``embed``; under ``tp`` (``embed`` this
    rank's vocabulary shard) the vocab-parallel lookup."""
    if tp is None:
        return lambda ids: embed[ids]
    return lambda ids: tpar.embed(embed, ids, tp)


@torch.no_grad()
def encode_and_prefix(
    params: dict, cfg: MellowConfig, audio1: torch.Tensor, audio2: torch.Tensor, text_ids: torch.Tensor,
    tp=None,
) -> torch.Tensor:
    """Encode both clips (one batch-B encoder call each) and assemble the
    prefix."""
    with annotate("mellow.encode"):
        p1 = htsat.encode_audio_compact(audio1, params, cfg.frontend, cfg.encoder)
    with annotate("mellow.encode"):
        p2 = htsat.encode_audio_compact(audio2, params, cfg.frontend, cfg.encoder)
    with annotate("mellow.prefix"):
        return build_prefix(params, cfg, p1, p2, text_ids, tp=tp)


def generate_tokens(
    params: dict,
    cfg: MellowConfig,
    audio1: torch.Tensor,  # (B, 320000)
    audio2: torch.Tensor,
    text_ids: torch.Tensor,  # (B, T)
    *,
    max_len: int,
    greedy: bool = True,
    top_p: float = 0.8,
    temperature: float = 1.0,
    rng: Optional[torch.Generator] = None,
    kv_cache_dtype=None,  # None (the compute dtype) or "int8"
    initial_done: Optional[torch.Tensor] = None,
    stop_token_id=None,  # default: cfg.stop_token_id
    top_k: int = 0,
    repetition_penalty: float = 1.0,
    w8a8: bool = False,  # W8A8 prefill blocks for int8 decoder weights
    tp=None,  # parallel.tensor.TP: the decoder's TP forms (llama)
) -> gen.GenerateResult:
    """Two waveforms + prompt ids -> token ids, in the dtype of the waves
    and the weights (float32 parity mode or bfloat16 perf mode)."""
    with annotate("mellow.generate_tokens"):
        prefix = encode_and_prefix(params, cfg, audio1, audio2, text_ids, tp=tp)
        return gen.generate(params["decoder"], cfg.decoder, prefix, tp=tp, **_decode_kwargs(
            cfg, text_ids, max_len=max_len, greedy=greedy, top_p=top_p, temperature=temperature, rng=rng,
            kv_cache_dtype=kv_cache_dtype, initial_done=initial_done, stop_token_id=stop_token_id, top_k=top_k,
            repetition_penalty=repetition_penalty, w8a8=w8a8))


def generate_tokens_sharded(
    params: dict,
    cfg: MellowConfig,
    audio1: torch.Tensor,  # (B, 320000), the whole batch on every rank
    audio2: torch.Tensor,
    text_ids: torch.Tensor,
    *,
    mesh,
    max_len: int,
    greedy: bool = True,
    top_p: float = 0.8,
    temperature: float = 1.0,
    seed: int = 0,
    kv_cache_dtype=None,
    initial_done: Optional[torch.Tensor] = None,
    stop_token_id=None,
    top_k: int = 0,
    repetition_penalty: float = 1.0,
    w8a8: bool = False,
    tp=None,
) -> gen.GenerateResult:
    """``generate_tokens`` over ``mesh``'s data axis (``mellow_tpu``'s
    ``generate_tokens_sharded``): each data rank runs the single-card
    program, kernels included, on its rows of the batch and leaves its loop
    when its own rows are done; the tokens are all-gathered over the data
    group, and ``num_steps`` is the slowest rank's. A sampled request draws
    from a generator per data index (``sharding.data_generator``), as the
    JAX package folds the device index into its key. ``tp`` (a TP mesh, its
    decoder on the TP forms) keeps the same rows on every rank of a model
    group. Raises where the data axis does not divide the batch; every rank
    calls it with the same arguments."""
    rows = sharding.data_rows(mesh, audio1.shape[0])
    if initial_done is not None:
        initial_done = initial_done[rows]
    res = generate_tokens(
        params, cfg, audio1[rows], audio2[rows], text_ids[rows], max_len=max_len, greedy=greedy, top_p=top_p,
        temperature=temperature, rng=sharding.data_generator(mesh, seed, audio1.device),
        kv_cache_dtype=kv_cache_dtype, initial_done=initial_done, stop_token_id=stop_token_id, top_k=top_k,
        repetition_penalty=repetition_penalty, w8a8=w8a8, tp=tp)
    steps = torch.tensor([res.num_steps], dtype=torch.int64, device=res.tokens.device)
    dist.all_reduce(steps, op=dist.ReduceOp.MAX, group=sharding.data_group(mesh))
    return gen.GenerateResult(tokens=sharding.gather_rows(res.tokens, sharding.data_group(mesh)),
                              num_steps=int(steps))


def generate_tokens_dynamic(
    params: dict,
    cfg: MellowConfig,
    audio1: torch.Tensor,
    audio2: torch.Tensor,
    text_ids: torch.Tensor,
    *,
    max_len: int,
    greedy: bool = True,
    top_p: float = 0.8,
    temperature: float = 1.0,
    rng: Optional[torch.Generator] = None,
    kv_cache_dtype=None,
    initial_done: Optional[torch.Tensor] = None,
    stop_token_id=None,
    top_k: int = 0,
    repetition_penalty: float = 1.0,
    w8a8: bool = False,
    min_batch: int = 32,
) -> gen.GenerateResult:
    """``generate_tokens`` with cascade compaction: finished rows stop
    costing decode steps (``generate.generate_cascade``)."""
    with annotate("mellow.generate_tokens"):
        prefix = encode_and_prefix(params, cfg, audio1, audio2, text_ids)
        return gen.generate_cascade(params["decoder"], cfg.decoder, prefix, min_batch=min_batch, **_decode_kwargs(
            cfg, text_ids, max_len=max_len, greedy=greedy, top_p=top_p, temperature=temperature, rng=rng,
            kv_cache_dtype=kv_cache_dtype, initial_done=initial_done, stop_token_id=stop_token_id, top_k=top_k,
            repetition_penalty=repetition_penalty, w8a8=w8a8))


def _decode_kwargs(cfg: MellowConfig, text_ids: torch.Tensor, *, stop_token_id, **kwargs) -> dict:
    """The decoder options of both entry points. HF's repetition penalty
    covers the whole input: the prompt's ids (the only prefix positions that
    have ids) seed its mask, the pad ids left out."""
    return dict(kwargs, stop_token_id=cfg.stop_token_id if stop_token_id is None else stop_token_id,
                family=cfg.decoder_family, prompt_tokens=text_ids, prompt_mask=text_ids != cfg.pad_token_id)


def forward_train(
    params: dict,
    cfg: MellowConfig,
    audio1: torch.Tensor,  # (B, 320000)
    audio2: torch.Tensor,
    text_ids: torch.Tensor,  # (B, T) prompt
    answer_ids: torch.Tensor,  # (B, T_ans) target tokens
    answer_mask: torch.Tensor,  # (B, T_ans) 1 for real tokens
    *,
    rng: Optional[torch.Generator] = None,
    remat: bool = False,
    mixup_lambda: Optional[torch.Tensor] = None,  # (B,) train-time mixup weights
    tp=None,
    data_group=None,
) -> tuple:
    """The training objective (``mellow.forward_train``): next-token cross
    entropy over the answer span, the prefix positions masked out. Returns
    (loss, metrics) with ``loss``, ``num_answer_tokens`` and ``accuracy``.

    Both clips go through the encoder's training route
    (``htsat.encode_audio(..., training=True)``: the plain formulation, the
    log-mel kernel on the card), with ``rng`` for SpecAugment, drop-path
    and dropout (None: none of them) and ``mixup_lambda`` for mixup, which
    halves the batch: the prompt and answer input embeddings are mixed with
    the same weights, and the loss is the convex combination ``lam *
    CE(y_even) + (1 - lam) * CE(y_odd)``, its accuracy scored against the
    labels of the row with the larger weight.

    Under a mesh the batch is the data rank's rows: ``data_group`` sums the
    log-likelihoods, the token weights and the accuracy's counts over the
    data ranks before dividing, so the loss is the global batch's token
    mean (its backward gives this rank's share of the gradient); ``tp``
    runs the decoder's TP forms."""
    p1, p2 = (htsat.encode_audio(a, params, cfg.frontend, cfg.encoder, rng=rng, mixup_lambda=mixup_lambda,
                                 training=True) for a in (audio1, audio2))
    ops = get_decoder_ops(cfg.decoder_family)
    lookup = _lookup(ops.embed_table(params["decoder"]), tp)
    answer_ids = answer_ids.long()
    ans_emb = lookup(answer_ids).to(p1.dtype)
    if mixup_lambda is None:
        prefix = build_prefix(params, cfg, p1, p2, text_ids, compact=False, tp=tp)
    else:
        from mellow_tpu_torch.train.augment import mixup

        lam = mixup_lambda.to(p1.dtype)
        dtext = mixup(lookup(text_ids.long()).to(p1.dtype), lam)
        prefix = build_prefix(params, cfg, p1, p2, text_ids, text_embeds=dtext, compact=False, tp=tp)
        ans_emb = mixup(ans_emb, lam)
    x = torch.cat([prefix, ans_emb], dim=1)
    logits = ops.forward(params["decoder"], cfg.decoder, x, remat=remat, **({} if tp is None else {"tp": tp}))
    P = prefix.shape[1]
    pred = logits[:, P - 1 : -1]  # position P - 1 + t predicts answer token t
    logp = torch.log_softmax(pred.float(), dim=-1)
    mask = answer_mask.float()
    if mixup_lambda is None:
        tok_lp = logp.gather(-1, answer_ids[..., None])[..., 0] * mask
        weight, acc_ids, acc_mask = mask, answer_ids, mask
    else:
        lam_f = mixup_lambda.float()
        w_even = lam_f[0::2, None] * mask[0::2]
        w_odd = lam_f[1::2, None] * mask[1::2]
        tok_lp = (logp.gather(-1, answer_ids[0::2, :, None])[..., 0] * w_even
                  + logp.gather(-1, answer_ids[1::2, :, None])[..., 0] * w_odd)
        weight = w_even + w_odd
        acc_ids = torch.where((lam_f[0::2] >= lam_f[1::2])[:, None], answer_ids[0::2], answer_ids[1::2])
        acc_mask = torch.where(w_even >= w_odd, mask[0::2], mask[1::2])
    n = weight.sum()
    correct = ((pred.argmax(-1) == acc_ids).float() * acc_mask).sum()
    total, acc_n = tok_lp.sum(), acc_mask.sum()
    if data_group is not None:
        total = tpar.reduce_from(total, data_group)
        counts = torch.stack([n, correct, acc_n]).detach()
        dist.all_reduce(counts, group=data_group)
        n, correct, acc_n = counts.unbind()
    loss = -total / n.clamp_min(1.0)
    metrics = {"loss": loss, "num_answer_tokens": n, "accuracy": correct / acc_n.clamp_min(1.0)}
    return loss, metrics


def init_params(cfg: MellowConfig, seed: int) -> dict:
    """Random full-model weights, as numpy float32 in the JAX package's
    tree (same keys and shapes as ``mellow_tpu.models.mellow.init_params``).
    Kernels are N(0, 0.02); biases zero; norms identity. The values differ
    from that one's (it seeds its decoder from a folded jax.random key). A
    gpt2 decoder is ``gpt2.init_params(cfg.decoder, seed)``."""
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
    if cfg.decoder_family == "gpt2":
        decoder = gpt2.init_params(dec, seed)
    else:
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
