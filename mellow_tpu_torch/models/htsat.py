"""HTSAT Swin-Transformer audio encoder in PyTorch, eval compact path.

Port of ``mellow_tpu/models/htsat.py`` as plain functions on tensors with a
parameter dict of the same tree (see ``models/params.py``). Activations are
(B, L, C) and weights (in, out), as in the JAX package; the TSCAM conv
weight is the pre-flattened (C*cfb*3, O) im2col matrix. Cyclic shifts are
``torch.roll``; the SW-MSA mask and the relative-position index are numpy
copies of the JAX module's tables (held bit-equal by the tests).

Not ported here: the full 1025-row ``htsat_embedding`` and ``tscam_head``,
the long-audio and infer-mode paths, ``swin_features_with_attn``,
drop-path and SpecAugment.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from mellow_tpu.config import FrontendConfig, HTSATConfig
from mellow_tpu_torch.ops import frontend as fe


# ---------------------------------------------------------------------------
# constant tables (numpy)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def relative_position_index(window_size: int) -> np.ndarray:
    """(ws*ws, ws*ws) gather index into the (2ws-1)^2 bias table."""
    ws = window_size
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, N, N)
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=8)
def shifted_window_mask(resolution: int, window_size: int, shift: int) -> np.ndarray:
    """(nW, N, N) additive mask (0 / -100) for shifted-window blocks, from
    the image-region counting scheme."""
    H = W = resolution
    img = np.zeros((H, W))
    cnt = 0
    for hs in (slice(0, -window_size), slice(-window_size, -shift), slice(-shift, None)):
        for wsl in (slice(0, -window_size), slice(-window_size, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    nh = H // window_size
    mw = img.reshape(nh, window_size, nh, window_size).transpose(0, 2, 1, 3)
    mw = mw.reshape(-1, window_size * window_size)  # (nW, N)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def layer_norm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch nn.GELU's default."""
    return F.gelu(x, approximate="none")


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    out = x @ p["kernel"]
    return out + p["bias"] if "bias" in p else out


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C), windows in row-major order."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(windows: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    B = windows.shape[0] // ((H // ws) * (W // ws))
    x = windows.reshape(B, H // ws, W // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


def window_attention(
    x: torch.Tensor,  # (Bn, N, C)
    p: dict,
    num_heads: int,
    window_size: int,
    mask: Optional[np.ndarray],  # (nW, N, N) or None
) -> torch.Tensor:
    """Window MSA with relative position bias."""
    Bn, N, C = x.shape
    hd = C // num_heads
    qkv = linear(x, p["qkv"]).reshape(Bn, N, 3, num_heads, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (Bn, N, H, hd)

    idx = torch.from_numpy(relative_position_index(window_size).reshape(-1)).to(x.device)
    bias = p["rel_bias_table"][idx].reshape(N, N, num_heads).permute(2, 0, 1)  # (H, N, N)

    attn = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k) + bias[None]
    if mask is not None:
        nW = mask.shape[0]
        m = torch.from_numpy(mask).to(x.device)
        attn = (attn.reshape(Bn // nW, nW, num_heads, N, N) + m[None, :, None])
        attn = attn.reshape(Bn, num_heads, N, N)
    attn = torch.softmax(attn, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(Bn, N, C)
    return linear(out, p["proj"])


def swin_block(
    x: torch.Tensor,  # (B, L, C)
    p: dict,
    resolution: int,
    num_heads: int,
    window_size: int,
    shift: int,
) -> torch.Tensor:
    """One Swin block (eval). When the window covers the whole resolution
    the shift collapses to 0."""
    H = W = resolution
    B, L, C = x.shape
    if min(H, W) <= window_size:
        window_size = min(H, W)
        shift = 0

    shortcut = x
    x = layer_norm(x, p["norm1"]).reshape(B, H, W, C)
    if shift > 0:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    mask = shifted_window_mask(H, window_size, shift) if shift > 0 else None
    windows = window_attention(window_partition(x, window_size), p, num_heads, window_size, mask)
    x = window_reverse(windows, window_size, H, W)
    if shift > 0:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    x = shortcut + x.reshape(B, L, C)

    h = gelu(linear(layer_norm(x, p["norm2"]), p["fc1"]))
    return x + linear(h, p["fc2"])


def patch_merging(x: torch.Tensor, p: dict, resolution: int) -> torch.Tensor:
    """2x2 neighbourhood concat -> LayerNorm -> Linear 4C -> 2C."""
    H = W = resolution
    B, L, C = x.shape
    x = x.reshape(B, H, W, C)
    x = torch.cat(
        [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1
    )
    x = layer_norm(x.reshape(B, (H // 2) * (W // 2), 4 * C), p["norm"])
    return x @ p["reduction"]["kernel"]


def patch_embed(img: torch.Tensor, p: dict, patch: int) -> torch.Tensor:
    """Conv2d(1, C, patch, stride patch) as space-to-depth + matmul (no
    convolution, so cuDNN's TF32 never enters). (B, H, W) -> (B, gh*gw, C)."""
    B, H, W = img.shape
    x = img.reshape(B, H // patch, patch, W // patch, patch).permute(0, 1, 3, 2, 4)
    x = x.reshape(B, (H // patch) * (W // patch), patch * patch)
    return layer_norm(linear(x, p), p["norm"])


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def swin_features(img: torch.Tensor, params: dict, cfg: HTSATConfig) -> torch.Tensor:
    """Patch embed + Swin stages + final LayerNorm -> (B, 64, 768) tokens."""
    x = patch_embed(img, params["patch_embed"], cfg.patch_size)
    res = cfg.grid_size
    for si, depth in enumerate(cfg.depths):
        stage = params["stages"][si]
        for d in range(depth):
            shift = 0 if d % 2 == 0 else cfg.window_size // 2
            x = swin_block(x, stage["blocks"][d], res, cfg.num_heads[si], cfg.window_size, shift)
        if "downsample" in stage:
            x = patch_merging(x, stage["downsample"], res)
            res //= 2
    return layer_norm(x, params["norm"])


def _tscam_core(tokens: torch.Tensor, params: dict, cfg: HTSATConfig):
    """TSCAM up to the per-step logits: frequency grouping, latent pooling,
    and the (O, C, cfb, 3) conv as an im2col matmul against the stored
    (C*cfb*3, O) weight. Returns (latent (B, C), logits_t (B, O, 32))."""
    B, N, C = tokens.shape
    SF = ST = cfg.spec_size // (2 ** (len(cfg.depths) - 1)) // cfg.patch_stride  # 8
    x = tokens.transpose(1, 2).reshape(B, C, SF, ST)
    cfb = SF // cfg.freq_ratio  # 2
    # (B, C, chunk, cfb, ST) -> (B, C, cfb, chunk*ST): undo the time fold.
    x = x.reshape(B, C, SF // cfb, cfb, ST).permute(0, 1, 3, 2, 4)
    x = x.reshape(B, C, cfb, (SF // cfb) * ST)

    latent = x.reshape(B, C, -1).mean(-1)  # (B, C)

    xt = x.permute(0, 3, 1, 2)  # (B, T, C, cfb)
    T = xt.shape[1]
    xtp = F.pad(xt, (0, 0, 0, 0, 1, 1))
    cols = torch.stack([xtp[:, t : t + T] for t in range(3)], dim=-1)  # (B, T, C, cfb, 3)
    logits_bt = cols.reshape(B, T, -1) @ params["tscam_conv"]["kernel"]  # (B, T, O)
    logits_t = logits_bt.transpose(1, 2) + params["tscam_conv"]["bias"][None, :, None]
    return latent, logits_t


def htsat_embedding_compact(
    wave: torch.Tensor, params: dict, fe_cfg: FrontendConfig, cfg: HTSATConfig
) -> torch.Tensor:
    """(B, 33, C) = [latent | the 32 unique frame rows] of the embedding.
    The full form repeats each frame row 32 times; every op up to the
    prefix mean-pool is row-wise, so the compact form is exact."""
    enc = params["encoder"]
    img = fe.frontend_image(wave, fe_cfg, enc["bn0"], cfg.freq_ratio, cfg.target_frames)
    tokens = swin_features(img, enc, cfg)
    latent, logits_t = _tscam_core(tokens, enc, cfg)
    fpx = torch.sigmoid(logits_t).transpose(1, 2)  # (B, 32, O)
    oframe = linear(fpx, params["c2l"])
    return torch.cat([latent[:, None], oframe], dim=1)


def projection(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Residual MLP + LayerNorm into the decoder width (eval: no dropout)."""
    e1 = x @ p["linear1"]["kernel"]
    e2 = gelu(e1) @ p["linear2"]["kernel"]
    return layer_norm(e1 + e2, p["layer_norm"])


def encode_audio_compact(
    wave: torch.Tensor, params: dict, fe_cfg: FrontendConfig, cfg: HTSATConfig
) -> torch.Tensor:
    """(B, 320000) -> (B, 33, d_proj): projected [latent | 32 frame rows]."""
    return projection(htsat_embedding_compact(wave, params, fe_cfg, cfg), params["projection"])


def downsample_tokens_compact(x: torch.Tensor) -> torch.Tensor:
    """(B, 33, D) -> (B, 129, D). In the full form pooled token g averages
    frame rows [8g, 8g + 8), which all repeat unique row g // 4, so the
    mean of 8 equal rows is that row (exact in fp32)."""
    return torch.cat([x[:, :1], x[:, 1:].repeat_interleave(4, dim=1)], dim=1)
