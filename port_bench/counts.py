"""Operation and byte counts of Mellow's work, from a configuration's shapes.

Operations are 2 per multiply-add of the matrix products and attention
contractions (normalisations, activations and softmaxes are left out: they
are a fraction of a percent and run outside the tensor cores). Bytes count
each input of a unit of work read once and each output written once, in
the served dtype, whatever a kernel reads again. The front-end counts as
its real FFT (2.5 n log2 n per frame), the band-limited mel filterbank and
a 4-tap cubic interpolation, not as a DFT matrix product. The encoder is
counted in its compact form (the 33 unique rows of TSCAM's output), which
gives the prefix exactly.

``cfg`` is a configuration file's dict (``port_bench/configs/*.json``).
"""

from __future__ import annotations

import math

BF16 = 2


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def stage_shapes(enc: dict) -> list:
    """[(tokens L, channels C, heads, window tokens N, resolution)] of each
    Swin stage of one clip."""
    res = enc["spec_size"] // enc["patch_stride"]
    C = enc["embed_dim"]
    out = []
    for si in range(len(enc["depths"])):
        ws = min(enc["window_size"], res)
        out.append((res * res, C, enc["num_heads"][si], ws * ws, res))
        res //= 2
        C *= 2
    return out


def swin_block_flops(L: int, C: int, N: int, mlp_ratio: float = 4.0) -> float:
    """One Swin block on one clip: qkv (3C^2), proj (C^2), fc1 and fc2
    (2 mlp_ratio C^2) a token, and q k^T and p v over its window of N."""
    return 2 * L * C * C * (4 + 2 * mlp_ratio) + 4 * L * N * C


def swin_block_bytes(batch: int, L: int, C: int, heads: int, N: int, shifted: bool,
                     mlp_ratio: float = 4.0) -> float:
    """One Swin block's launches over ``batch`` clips: the input and output
    activations in bf16, the weights in bf16 once, and the float32 bias
    (heads, N, N) and, for a shifted window, the float32 mask (nW, N, N)."""
    hidden = int(C * mlp_ratio)
    weights = (3 * C * C + 3 * C) + (C * C + C) + (C * hidden + hidden) + (hidden * C + C) + 4 * C
    mask = (L // N) * N * N * 4 if shifted else 0
    return 2 * batch * L * C * BF16 + weights * BF16 + heads * N * N * 4 + mask


def frontend_flops(fe: dict, enc: dict) -> float:
    """One clip's log-mel, bn0 and time resize: a real FFT of each frame,
    the power, the mel filterbank's nonzero band (each bin in at most two
    triangles), and 4 taps of the cubic resize per output value."""
    frames = 1 + fe["sample_rate"] * fe["segment_seconds"] // fe["hop_length"]
    n = fe["n_fft"]
    bins = n // 2 + 1
    fft = 2.5 * n * math.log2(n)
    target = enc["spec_size"] * (enc["spec_size"] // enc["mel_bins"])
    return frames * (fft + 3 * bins + 2 * 2 * bins) + 2 * 4 * target * fe["n_mels"]


def encoder_flops(cfg: dict) -> float:
    """One clip through the front-end, HTSAT, TSCAM (compact), c2l and the
    projection."""
    enc = cfg["encoder"]
    total = frontend_flops(cfg["frontend"], enc)
    shapes = stage_shapes(enc)
    L0, C0 = shapes[0][0], shapes[0][1]
    total += 2 * L0 * enc["patch_size"] ** 2 * C0
    for si, (L, C, heads, N, res) in enumerate(shapes):
        total += enc["depths"][si] * swin_block_flops(L, C, N, enc["mlp_ratio"])
        if si < len(shapes) - 1:
            total += 2 * (L // 4) * (4 * C) * (2 * C)
    nf = shapes[-1][1]
    nc = enc["num_classes"]
    steps = shapes[-1][4] * (enc["spec_size"] // enc["mel_bins"])  # 32 TSCAM steps
    cfb = shapes[-1][4] // (enc["spec_size"] // enc["mel_bins"])
    total += 2 * steps * nf * cfb * 3 * nc  # the TSCAM conv
    total += 2 * steps * nc * nf  # c2l on the unique steps
    rows = steps + 1
    total += 2 * rows * (nf * cfg["d_proj"] + cfg["d_proj"] * cfg["d_proj"])
    return total


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _dims(dec: dict):
    return (dec["hidden_size"], dec["intermediate_size"], dec["num_heads"], dec["num_kv_heads"],
            dec["head_dim"])


def attn_block_flops(dec: dict, rows: int, S: int) -> float:
    """The prefill attention block of one layer over ``rows`` sequences of
    S tokens: the q/k/v and o projections, and the causal half of q k^T and
    p v (S (S + 1) / 2 pairs a head)."""
    D, I, H, KV, hd = _dims(dec)
    proj = 2 * rows * S * D * (H + 2 * KV) * hd + 2 * rows * S * H * hd * D
    return proj + 2 * 2 * rows * H * hd * (S * (S + 1) // 2)


def attn_block_bytes(dec: dict, rows: int, S: int) -> float:
    """Its input and output activations, its k and v written to the cache,
    the rope tables, the norm and the four weights, in bf16."""
    D, I, H, KV, hd = _dims(dec)
    weights = D * (H + 2 * KV) * hd + H * hd * D + D
    return (2 * rows * S * D + 2 * rows * S * KV * hd + 2 * S * hd + weights) * BF16


def mlp_block_flops(dec: dict, rows: int, S: int) -> float:
    D, I, H, KV, hd = _dims(dec)
    return 2 * rows * S * 3 * D * I


def mlp_block_bytes(dec: dict, rows: int, S: int) -> float:
    D, I, H, KV, hd = _dims(dec)
    return (2 * rows * S * D + 3 * D * I + D) * BF16


def decode_step_flops(dec: dict, rows: int, positions: int) -> float:
    """One decode step's layers for ``rows`` sequences attending over
    ``positions`` (the cached ones and its own)."""
    D, I, H, KV, hd = _dims(dec)
    per_token = 2 * D * (H + 2 * KV) * hd + 2 * H * hd * D + 2 * 3 * D * I + 2 * 2 * H * hd * positions
    return dec["num_layers"] * rows * per_token


def logits_flops(dec: dict, rows: int) -> float:
    return 2 * rows * dec["hidden_size"] * dec["vocab_size"]


def call_flops(cfg: dict, batch: int, max_len: int) -> float:
    """One greedy call of ``batch`` requests to ``max_len`` tokens: both
    clips of each request through the encoder, the prefill, ``max_len``
    token choices (each a logits product) and ``max_len - 1`` decode steps,
    step i at position P + i."""
    dec, P = cfg["decoder"], cfg["prefix_length"]
    total = 2 * batch * encoder_flops(cfg)
    total += dec["num_layers"] * (attn_block_flops(dec, batch, P) + mlp_block_flops(dec, batch, P))
    total += max_len * logits_flops(dec, batch)
    total += sum(decode_step_flops(dec, batch, P + i + 1) for i in range(max_len - 1))
    return total
