"""Analytic operation and byte counts for roofline reporting, and the
card's peak rates.

The decode step is modeled as pure streaming: every step reads all decoder
matmul weights, the logits head and the whole KV cache once; activations
are negligible at these sizes. The encoder is modeled by its operations
(it is compute-shaped: window-attention and MLP matmuls over 4096 to 64
tokens). A least time for some work is the larger of its bytes over
``PEAK_HBM_BYTES`` and its operations over the peak rate of their type.
"""

from __future__ import annotations

from mellow_tpu_torch.config import LlamaConfig, MellowConfig

# One NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit, from NVIDIA's
# data sheet (dense rates, no sparsity): bf16 and int8 tensor cores, fp32
# without tensor cores, HBM3. A card set below 700 W runs slower under load.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def _dtype_bytes(name: str) -> float:
    return {"float32": 4, "bfloat16": 2, "int8": 1}[str(name)]


def decoder_matmul_params(cfg: LlamaConfig) -> int:
    """Per-layer matmul weights (what streams every decode step), excluding
    the embedding/logits head."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    per_layer = D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * I
    return cfg.num_layers * per_layer


def decode_step_bytes(
    cfg: LlamaConfig, batch: int, s_max: int,
    cache_dtype: str = "bfloat16", weight_dtype: str = "bfloat16",
) -> float:
    """HBM bytes read per decode step: layer weights, the logits head and
    the full KV cache, ``llama.KVCache``'s (L, B, s_max, KV, hd) k and v (an
    int8 cache adds its fp32 (L, B, s_max) scales)."""
    wb = _dtype_bytes(weight_dtype)
    layer_bytes = decoder_matmul_params(cfg) * wb
    head_bytes = cfg.vocab_size * cfg.hidden_size * wb
    row = 2 * cfg.num_kv_heads * cfg.head_dim
    cache_bytes = cfg.num_layers * batch * s_max * row * _dtype_bytes(cache_dtype)
    if cache_dtype == "int8":
        cache_bytes += 2 * cfg.num_layers * batch * s_max * 4
    return layer_bytes + head_bytes + cache_bytes


def decode_step_flops(cfg: LlamaConfig, batch: int, s_max: int) -> float:
    """MACs*2 per decode step (weight matmuls + attention contractions over
    ``s_max`` positions of each head's ``head_dim``)."""
    mm = 2 * batch * decoder_matmul_params(cfg)
    head = 2 * batch * cfg.hidden_size * cfg.vocab_size
    attn = 2 * 2 * cfg.num_layers * batch * cfg.num_heads * s_max * cfg.head_dim
    return mm + head + attn


def encoder_flops(cfg: MellowConfig) -> float:
    """FLOPs for one clip through frontend + HTSAT + heads + projection.
    Window attention: every token attends its 64-token window."""
    enc = cfg.encoder
    win = enc.window_size ** 2
    total = 0.0
    # frontend: DFT-as-matmul (re+im) + mel + bicubic-as-matmul
    frames, nfft_bins, nfft = 1001, 513, 1024
    total += 2 * 2 * frames * nfft * nfft_bins            # rFFT matmul
    total += 2 * frames * nfft_bins * 64                  # mel filterbank
    total += 2 * 1024 * 1001 * 64                         # bicubic matrix
    # patch embed conv: (spec/4)^2 tokens x (4*4*1*C)
    tokens = (256 // enc.patch_size) ** 2
    total += 2 * tokens * enc.patch_size ** 2 * enc.embed_dim
    # swin stages: per block ~ 2*T*C^2*(3+1+8) qkv/proj/mlp + 4*T*N*C attn
    T, C = tokens, enc.embed_dim
    for si, depth in enumerate(enc.depths):
        total += depth * (24 * T * C * C + 4 * T * win * C)
        if si < len(enc.depths) - 1:
            total += 2 * (T // 4) * (4 * C) * (2 * C)     # patch merging
            T, C = T // 4, C * 2
    # tscam conv + c2l + projection MLP
    nf, nc = enc.num_features, enc.num_classes
    total += 2 * 32 * nf * nc * 2 * 3                     # tscam conv (2x3)
    total += 2 * 1024 * nc * nf                           # c2l
    total += 2 * 1025 * nf * cfg.d_proj + 2 * 1025 * cfg.d_proj * cfg.d_proj
    return total


def pct(x: float) -> str:
    return f"{100.0 * x:.1f}%"
