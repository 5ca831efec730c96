"""HTSAT Swin-Transformer audio encoder in PyTorch.

Port of ``mellow_tpu/models/htsat.py`` as plain functions on tensors with a
parameter dict of the same tree (see ``models/params.py``). Activations are
(B, L, C) and weights (in, out), as in the JAX package; the TSCAM conv
weight is the pre-flattened (C*cfb*3, O) im2col matrix. Cyclic shifts are
``torch.roll``; the SW-MSA mask and the relative-position index are numpy
copies of the JAX module's tables (held bit-equal by the tests).

Everything runs in the dtype of the wave and the weights: float32 (parity
mode) or bfloat16 (perf mode). In bf16 the Swin blocks whose weights pass
the JAX package's fused-block gate (stages 1-3 at v0, stage 1 at
HTSAT-large) run as the Swin block kernel (``ops/swin_block.py``: CUDA on
the card, its plain version on the CPU), with its tanh-GELU; the rest keep
the exact-erf formulation below with an fp32 softmax, as in the JAX
package, and of those a block whose window passes the JAX per-window gate
(stage 2 at HTSAT-large) runs its attention core as the window-attention
kernel (``ops/window_attention.py``). ``return_attn`` forces the plain
formulation, as in JAX.

Entry points: the compact eval path the wrapper runs
(``encode_audio_compact``), and the full 1025-row ``htsat_embedding`` with
``tscam_head``, ``encode_audio``, ``htsat_embedding_long``,
``htsat_embedding_infer_mode``, ``swin_features_with_attn`` and
``downsample_tokens``. The long and infer-mode paths cast the fp32 log-mel
back to the wave's dtype, as ``frontend_image`` does, where the JAX package
lets it promote the trunk to fp32 (ROADMAP Queue 3).

Training (``encode_audio(..., training=True)``, which
``models/mellow.forward_train`` passes): every Swin block takes the plain
formulation (``kernel_route(..., training=True)`` is "plain"), since the
Swin-block and window-attention kernels have no backward (nor do their
Pallas originals); the log-mel kernel stays, its input the waveform, which
needs no gradient. The train-time arguments are the JAX package's: ``rng``
(a ``torch.Generator`` on the wave's device) turns on SpecAugment after
bn0, drop-path at the per-block rates ``linspace(0, drop_path_rate,
blocks)`` and the projection's dropout (p = 0.5); ``mixup_lambda`` (B,)
mixes the folded image's even rows with its odd rows and halves the batch.
The draws come from the generator in order, not from JAX's key streams.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from mellow_tpu_torch.config import FrontendConfig, HTSATConfig
from mellow_tpu_torch.ops import frontend as fe
from mellow_tpu_torch.ops import swin_block as swin_kernel
from mellow_tpu_torch.ops import window_attention as window_kernel


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


@functools.lru_cache(maxsize=16)
def _device_index(window_size: int, device: torch.device) -> torch.Tensor:
    """``relative_position_index`` flattened, as an int64 tensor on
    ``device``, copied there once."""
    return torch.from_numpy(relative_position_index(window_size).reshape(-1)).to(device)


@functools.lru_cache(maxsize=16)
def _device_mask(resolution: int, window_size: int, shift: int, device: torch.device) -> torch.Tensor:
    """``shifted_window_mask`` as a float32 tensor on ``device``, copied
    there once."""
    return torch.from_numpy(shifted_window_mask(resolution, window_size, shift)).to(device)


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
    mask,  # (nW, N, N) numpy array or float32 tensor, or None
    return_attn: bool = False,
    training: bool = False,
):
    """Window MSA with relative position bias. In bf16 eval, where one
    window passes the JAX package's 6 MB gate, the core between the qkv and
    proj products is the window-attention kernel (its plain version on the
    CPU). ``return_attn`` also returns the softmax probabilities
    (Bn, H, N, N) in x's dtype; it and ``training`` force the plain
    formulation."""
    Bn, N, C = x.shape
    hd = C // num_heads
    qkv = linear(x, p["qkv"])  # (Bn, N, 3C)

    bias = p["rel_bias_table"][_device_index(window_size, x.device)]
    bias = bias.reshape(N, N, num_heads).permute(2, 0, 1)  # (H, N, N)

    if (not return_attn and not training and x.dtype == torch.bfloat16
            and window_kernel.window_vmem_bytes(C, num_heads, N) <= window_kernel.WINDOW_BUDGET):
        m = None if mask is None else torch.as_tensor(mask, device=x.device).float().contiguous()
        out = window_kernel.window_attention(qkv, bias.float().contiguous(), m, num_heads=num_heads)
        return linear(out, p["proj"])

    qkv = qkv.reshape(Bn, N, 3, num_heads, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (Bn, N, H, hd)
    attn = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k) + bias[None]
    if mask is not None:
        nW = mask.shape[0]
        m = torch.as_tensor(mask, device=x.device).to(attn.dtype)
        attn = (attn.reshape(Bn // nW, nW, num_heads, N, N) + m[None, :, None])
        attn = attn.reshape(Bn, num_heads, N, N)
    # Softmax in fp32, back to the compute dtype (a no-op in parity mode).
    attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(Bn, N, C)
    out = linear(out, p["proj"])
    return (out, attn) if return_attn else out


def kernel_route(C: int, num_heads: int, window_size: int, resolution: int, training: bool = False) -> str:
    """The kernel a bf16 Swin block of this geometry runs, by the JAX
    package's gates: "swin_block" (the whole block, when its weights and
    activations pass the 10 MB gate), else "window_attention" (its
    attention core, when one window passes the 6 MB gate), else "plain".
    ``training``: "plain", whatever the geometry; neither kernel has a
    backward. (JAX's gate sends a bf16 block with a zero drop-path rate to
    its Swin-block kernel even under a gradient.)"""
    if training:
        return "plain"
    window_size = min(window_size, resolution)
    if (swin_kernel.fused_block_vmem_bytes(C, num_heads, window_size, resolution)
            <= swin_kernel.FUSED_BLOCK_BUDGET):
        return "swin_block"
    if window_kernel.window_vmem_bytes(C, num_heads, window_size ** 2) <= window_kernel.WINDOW_BUDGET:
        return "window_attention"
    return "plain"


def swin_block(
    x: torch.Tensor,  # (B, L, C)
    p: dict,
    resolution: int,
    num_heads: int,
    window_size: int,
    shift: int,
    *,
    drop_path_rate: float = 0.0,
    rng=None,
    return_attn: bool = False,
    training: bool = False,
):
    """One Swin block. When the window covers the whole resolution the
    shift collapses to 0. ``return_attn`` also returns the window
    attention probabilities and forces the plain formulation, as does
    ``training`` (``kernel_route``). With ``rng`` (a ``torch.Generator``)
    both residual branches take drop-path at ``drop_path_rate``."""
    H = W = resolution
    B, L, C = x.shape
    if min(H, W) <= window_size:
        window_size = min(H, W)
        shift = 0

    if (not return_attn and x.dtype == torch.bfloat16 and (drop_path_rate == 0.0 or rng is None)
            and kernel_route(C, num_heads, window_size, H, training) == "swin_block"):
        N = window_size * window_size
        bias = p["rel_bias_table"][_device_index(window_size, x.device)]
        bias = bias.reshape(N, N, num_heads).permute(2, 0, 1).float()
        mask = _device_mask(H, window_size, shift, x.device) if shift > 0 else None
        x4 = x.reshape(B, H, W, C)
        if shift > 0:
            x4 = torch.roll(x4, shifts=(-shift, -shift), dims=(1, 2))
        out = swin_kernel.swin_block(x4.contiguous(), p, bias.contiguous(), mask,
                                     num_heads=num_heads, window_size=window_size)
        if shift > 0:
            out = torch.roll(out, shifts=(shift, shift), dims=(1, 2))
        return out.reshape(B, L, C)

    shortcut = x
    x = layer_norm(x, p["norm1"]).reshape(B, H, W, C)
    if shift > 0:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    mask = _device_mask(H, window_size, shift, x.device) if shift > 0 else None
    windows = window_attention(window_partition(x, window_size), p, num_heads, window_size, mask,
                               return_attn=return_attn, training=training)
    if return_attn:
        windows, attn = windows
    x = window_reverse(windows, window_size, H, W)
    if shift > 0:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    x = shortcut + _drop_path(x.reshape(B, L, C), drop_path_rate, rng)

    h = gelu(linear(layer_norm(x, p["norm2"]), p["fc1"]))
    out = x + _drop_path(linear(h, p["fc2"]), drop_path_rate, rng)
    return (out, attn) if return_attn else out


def _drop_path(x: torch.Tensor, rate: float, rng) -> torch.Tensor:
    """Stochastic depth: each batch row of the branch kept with probability
    1 - ``rate`` and scaled by 1 / (1 - rate); the identity without ``rng``
    or at rate 0."""
    if rate == 0.0 or rng is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1), generator=rng, device=x.device) < keep
    return x / keep * mask.to(x.dtype)


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

def swin_features(img: torch.Tensor, params: dict, cfg: HTSATConfig, *, rng=None,
                  training: bool = False) -> torch.Tensor:
    """Patch embed + Swin stages + final LayerNorm -> (B, 64, num_features)
    tokens. With ``rng``, block i of all the stages' blocks takes drop-path
    at ``linspace(0, cfg.drop_path_rate, blocks)[i]``."""
    x = patch_embed(img, params["patch_embed"], cfg.patch_size)
    res = cfg.grid_size
    dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths)) if rng is not None else np.zeros(sum(cfg.depths))
    bi = 0
    for si, depth in enumerate(cfg.depths):
        stage = params["stages"][si]
        for d in range(depth):
            shift = 0 if d % 2 == 0 else cfg.window_size // 2
            x = swin_block(x, stage["blocks"][d], res, cfg.num_heads[si], cfg.window_size, shift,
                           drop_path_rate=float(dpr[bi]), rng=rng, training=training)
            bi += 1
        if "downsample" in stage:
            x = patch_merging(x, stage["downsample"], res)
            res //= 2
    return layer_norm(x, params["norm"])


def swin_features_with_attn(img: torch.Tensor, params: dict, cfg: HTSATConfig):
    """The eval-time attention-map surface: ``swin_features`` on the plain
    formulation, also returning for each stage the mean over its blocks of
    the window attention probabilities, (nW*B, H, N, N) in float32."""
    x = patch_embed(img, params["patch_embed"], cfg.patch_size)
    res = cfg.grid_size
    stage_attns = []
    for si, depth in enumerate(cfg.depths):
        stage = params["stages"][si]
        attns = []
        for d in range(depth):
            shift = 0 if d % 2 == 0 else cfg.window_size // 2
            x, attn = swin_block(x, stage["blocks"][d], res, cfg.num_heads[si], cfg.window_size, shift,
                                 return_attn=True)
            attns.append(attn)
        stage_attns.append(torch.stack(attns).float().mean(0))
        if "downsample" in stage:
            x = patch_merging(x, stage["downsample"], res)
            res //= 2
    return layer_norm(x, params["norm"]), stage_attns


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


def tscam_head(tokens: torch.Tensor, params: dict, cfg: HTSATConfig) -> dict:
    """TSCAM head: the frame-wise outputs (each of the 32 steps repeated 32
    times, (B, 1024, O)), the clip-wise outputs (B, O) and the latent
    (B, C)."""
    latent, logits_t = _tscam_core(tokens, params, cfg)
    fpx = torch.sigmoid(logits_t).transpose(1, 2)  # (B, 32, O)
    return {
        "framewise_output": fpx.repeat_interleave(32, dim=1),
        "clipwise_output": torch.sigmoid(logits_t.mean(-1)),
        "latent_output": latent,
    }


def _with_embedding(out: dict, params: dict) -> dict:
    """``out`` plus its (B, 1025, C) embedding: [latent | c2l(frames)]."""
    oframe = linear(out["framewise_output"], params["c2l"])
    out["embedding"] = torch.cat([out["latent_output"][:, None], oframe], dim=1)
    return out


def htsat_embedding(
    wave: torch.Tensor, params: dict, fe_cfg: FrontendConfig, cfg: HTSATConfig, *,
    rng=None, mixup_lambda=None, training: bool = False,
) -> dict:
    """The full forward: (B, 320000) -> ``tscam_head``'s outputs and the
    (B, 1025, C) embedding. Train-time: ``rng`` draws SpecAugment (after
    bn0) and drop-path; ``mixup_lambda`` (B,) mixes the folded image's even
    rows with its odd rows (a per-row reshape, so it commutes with the
    reference's mixup of the spectrogram) and halves the batch;
    ``training`` routes every block to the plain formulation."""
    enc = params["encoder"]
    img = fe.frontend_image(wave, fe_cfg, enc["bn0"], cfg.freq_ratio, cfg.target_frames, augment_rng=rng)
    if mixup_lambda is not None:
        from mellow_tpu_torch.train.augment import mixup

        img = mixup(img, mixup_lambda.to(img.dtype))
    tokens = swin_features(img, enc, cfg, rng=rng, training=training)
    return _with_embedding(tscam_head(tokens, enc, cfg), params)


def htsat_embedding_compact(
    wave: torch.Tensor, params: dict, fe_cfg: FrontendConfig, cfg: HTSATConfig, training: bool = False
) -> torch.Tensor:
    """(B, 33, C) = [latent | the 32 unique frame rows] of the embedding.
    The full form repeats each frame row 32 times; every op up to the
    prefix mean-pool is row-wise, so the compact form is exact."""
    enc = params["encoder"]
    img = fe.frontend_image(wave, fe_cfg, enc["bn0"], cfg.freq_ratio, cfg.target_frames)
    tokens = swin_features(img, enc, cfg, training=training)
    latent, logits_t = _tscam_core(tokens, enc, cfg)
    fpx = torch.sigmoid(logits_t).transpose(1, 2)  # (B, 32, O)
    oframe = linear(fpx, params["c2l"])
    return torch.cat([latent[:, None], oframe], dim=1)


def _log_mel_bn(wave: torch.Tensor, fe_cfg: FrontendConfig, enc: dict) -> torch.Tensor:
    """(B, T) -> (B, 1 + T // hop, 64): the fp32 log-mel of any length,
    cast back to the wave's dtype, then bn0."""
    x = fe.log_mel_auto(wave.float(), fe_cfg).to(wave.dtype)
    return fe.batchnorm_mel(x, enc["bn0"])


def htsat_embedding_long(
    wave: torch.Tensor, params: dict, fe_cfg: FrontendConfig, cfg: HTSATConfig, *,
    crop_frames: int = 689, overlap_frames: int = 344,
) -> dict:
    """Long audio (more than 10.24 s): the log-mel cut into crops of
    ``crop_frames`` every ``overlap_frames``, all crops through the trunk as
    one batch, and the outputs averaged over the crops."""
    B = wave.shape[0]
    enc = params["encoder"]
    x = _log_mel_bn(wave, fe_cfg, enc)
    T = x.shape[1]
    if T <= cfg.target_frames:
        raise ValueError("use htsat_embedding for <= 10.24 s audio")
    starts = list(range(0, T - crop_frames - 1, overlap_frames))
    crops = torch.stack([x[:, s : s + crop_frames] for s in starts])
    crops = crops.reshape(len(starts) * B, crop_frames, x.shape[2])
    img = fe.fold_time_to_freq(fe.resize_time_bicubic(crops, cfg.target_frames), cfg.freq_ratio)
    out = tscam_head(swin_features(img, enc, cfg), enc, cfg)
    avg = {k: v.reshape((len(starts), B) + v.shape[1:]).mean(0) for k, v in out.items()}
    return _with_embedding(avg, params)


def htsat_embedding_infer_mode(
    wave: torch.Tensor, params: dict, fe_cfg: FrontendConfig, cfg: HTSATConfig
) -> dict:
    """Short audio: the log-mel repeated floor(1024 / T) times along time
    (cut to 1024 frames), then the resize, fold and trunk."""
    enc = params["encoder"]
    x = _log_mel_bn(wave, fe_cfg, enc)
    x = x.repeat(1, max(1, cfg.target_frames // x.shape[1]), 1)[:, : cfg.target_frames]
    img = fe.fold_time_to_freq(fe.resize_time_bicubic(x, cfg.target_frames), cfg.freq_ratio)
    return _with_embedding(tscam_head(swin_features(img, enc, cfg), enc, cfg), params)


def projection(x: torch.Tensor, p: dict, *, dropout_rng=None, rate: float = 0.5) -> torch.Tensor:
    """Residual MLP + LayerNorm into the decoder width. With
    ``dropout_rng`` (training) the second branch takes element-wise dropout
    at ``rate``."""
    e1 = x @ p["linear1"]["kernel"]
    e2 = gelu(e1) @ p["linear2"]["kernel"]
    if dropout_rng is not None:
        e2 = _dropout(e2, rate, dropout_rng)
    return layer_norm(e1 + e2, p["layer_norm"])


def _dropout(x: torch.Tensor, rate: float, rng: torch.Generator) -> torch.Tensor:
    """Each element kept with probability 1 - ``rate`` and scaled by
    1 / (1 - rate), else 0."""
    keep = torch.rand(x.shape, generator=rng, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def encode_audio(
    wave: torch.Tensor, params: dict, fe_cfg: FrontendConfig, cfg: HTSATConfig, *,
    rng=None, mixup_lambda=None, training: bool = False,
) -> torch.Tensor:
    """(B, 320000) -> projected (B, 1025, d_proj). Without ``rng`` and
    ``mixup_lambda``: the compact rows re-expanded, each frame row 32
    times, as the JAX package does. With either: the full
    ``htsat_embedding`` (its SpecAugment, drop-path and mixup), then the
    projection with its dropout when ``rng`` is given (per element, so the
    frame rows stop repeating). ``training`` routes every Swin block to the
    plain formulation (``kernel_route``)."""
    if rng is None and mixup_lambda is None:
        c = encode_audio_compact(wave, params, fe_cfg, cfg, training=training)
        return torch.cat([c[:, :1], c[:, 1:].repeat_interleave(32, dim=1)], dim=1)
    out = htsat_embedding(wave, params, fe_cfg, cfg, rng=rng, mixup_lambda=mixup_lambda, training=training)
    return projection(out["embedding"], params["projection"], dropout_rng=rng)


def encode_audio_compact(
    wave: torch.Tensor, params: dict, fe_cfg: FrontendConfig, cfg: HTSATConfig, training: bool = False
) -> torch.Tensor:
    """(B, 320000) -> (B, 33, d_proj): projected [latent | 32 frame rows]."""
    return projection(htsat_embedding_compact(wave, params, fe_cfg, cfg, training), params["projection"])


def downsample_tokens_compact(x: torch.Tensor) -> torch.Tensor:
    """(B, 33, D) -> (B, 129, D). In the full form pooled token g averages
    frame rows [8g, 8g + 8), which all repeat unique row g // 4, so the
    mean of 8 equal rows is that row (exact in fp32)."""
    return torch.cat([x[:, :1], x[:, 1:].repeat_interleave(4, dim=1)], dim=1)


def downsample_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, 1025, D) -> (B, 129, D): token 0 kept, tokens 1..1024 mean-pooled
    in groups of 8."""
    B, N, D = x.shape
    pooled = x[:, 1:].reshape(B, (N - 1) // 8, 8, D).mean(2)
    return torch.cat([x[:, :1], pooled], dim=1)
