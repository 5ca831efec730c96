"""Plain float32 reference of Mellow (HTSAT encoder, projection, prefix,
SmolLM2-shape Llama decoder), for the benchmark's correctness check.

Written from the published architecture (the Mellow repository's
``mellow/model``, HTSAT as in LAION-CLAP's ``htsat.py``, SmolLM2 as Hugging
Face's Llama layer), in plain PyTorch, float32, with TF32 off. It imports
nothing of the program under test and takes nothing it has made: the
weights are the benchmark's own (drawn from the seed by
``port_bench/weights.py`` over the leaves that ``leaves`` lists), and the front-end tables, the rope tables, the
masks and the relative-position index are worked out here again.

The encoder runs in its compact form: the frame-wise outputs of TSCAM
repeat each of 32 steps 32 times, and every operation up to the prefix's
mean-pool over groups of 8 frames is row-wise, so the 33 unique rows give
the same prefix exactly.

Departures from the published model, each the program's as well: none in
the mathematics. The log-mel uses ``torch.stft`` (an FFT) where
torchlibrosa uses a conv1d DFT; both compute the same transform.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def no_tf32() -> None:
    """float32 products in full float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# front-end: log-mel (torchlibrosa's Spectrogram + LogmelFilterBank)
# ---------------------------------------------------------------------------

def _hz_to_mel(hz):
    """Slaney mel scale (librosa, htk=False)."""
    hz = np.asarray(hz, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(hz >= min_log_hz, min_log_hz / f_sp + np.log(np.maximum(hz, 1e-10) / min_log_hz) / logstep,
                    hz / f_sp)


def _mel_to_hz(mel):
    mel = np.asarray(mel, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mel >= min_log_mel, min_log_hz * np.exp(logstep * (mel - min_log_mel)), mel * f_sp)


@functools.lru_cache(maxsize=4)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """librosa.filters.mel(htk=False, norm='slaney'), as (n_bins, n_mels)."""
    n_bins = n_fft // 2 + 1
    freqs = np.linspace(0.0, sr / 2.0, n_bins)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (pts[2: n_mels + 2] - pts[:n_mels]))[:, None]
    return w.T.astype(np.float32)


def log_mel(wave: torch.Tensor, fe: dict) -> torch.Tensor:
    """(B, T) float32 -> (B, 1 + T // hop, n_mels): |STFT|^2 with a periodic
    Hann window, centred with reflect padding, then the mel filterbank and
    10 log10(max(., amin)) - 10 log10(max(amin, ref))."""
    win = torch.hann_window(fe["win_length"], periodic=True, dtype=torch.float32, device=wave.device)
    spec = torch.stft(wave, fe["n_fft"], hop_length=fe["hop_length"], win_length=fe["win_length"], window=win,
                      center=True, pad_mode="reflect", return_complex=True)
    power = spec.real.square() + spec.imag.square()  # (B, n_bins, frames)
    fb = torch.from_numpy(mel_filterbank(fe["sample_rate"], fe["n_fft"], fe["n_mels"], fe["fmin"],
                                         fe["fmax"])).to(wave.device)
    mel = power.transpose(1, 2) @ fb
    out = 10.0 * torch.log10(mel.clamp_min(fe["amin"])) - 10.0 * math.log10(max(fe["amin"], fe["ref"]))
    if fe.get("top_db") is not None:
        out = torch.maximum(out, out.max() - fe["top_db"])
    return out


# ---------------------------------------------------------------------------
# HTSAT
# ---------------------------------------------------------------------------

def layer_norm(x, p, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def linear(x, p, mm=torch.matmul):
    y = mm(x, p["kernel"])
    return y + p["bias"] if "bias" in p else y


@functools.lru_cache(maxsize=8)
def _rel_index(ws: int) -> np.ndarray:
    """Swin's relative-position index, (ws*ws, ws*ws) into the
    (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]


@functools.lru_cache(maxsize=8)
def _shift_mask(res: int, ws: int, shift: int) -> np.ndarray:
    """(nW, N, N) additive mask of a shifted-window block: -100 between
    tokens of different regions."""
    img = np.zeros((res, res))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(res // ws, ws, res // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return np.where(win[:, None, :] != win[:, :, None], -100.0, 0.0).astype(np.float32)


def _windows(x, ws):
    B, H, W, C = x.shape
    return x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def _unwindows(w, ws, H, W):
    B = w.shape[0] // ((H // ws) * (W // ws))
    return w.reshape(B, H // ws, W // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def swin_block(x, p, res, heads, ws, shift, mm=torch.matmul):
    B, L, C = x.shape
    if res <= ws:
        ws, shift = res, 0
    N, hd = ws * ws, C // heads
    h = layer_norm(x, p["norm1"]).reshape(B, res, res, C)
    if shift:
        h = torch.roll(h, (-shift, -shift), (1, 2))
    win = _windows(h, ws)
    qkv = linear(win, p["qkv"], mm).reshape(-1, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
    attn = mm(q, k.transpose(-1, -2))
    idx = torch.from_numpy(_rel_index(ws).reshape(-1)).to(x.device)
    attn = attn + p["rel_bias_table"][idx].reshape(N, N, heads).permute(2, 0, 1)[None]
    if shift:
        m = torch.from_numpy(_shift_mask(res, ws, shift)).to(x.device)
        nW = m.shape[0]
        attn = (attn.reshape(-1, nW, heads, N, N) + m[None, :, None]).reshape(-1, heads, N, N)
    out = mm(attn.softmax(-1), v).transpose(1, 2).reshape(-1, N, C)
    h = _unwindows(linear(out, p["proj"], mm), ws, res, res)
    if shift:
        h = torch.roll(h, (shift, shift), (1, 2))
    x = x + h.reshape(B, L, C)
    return x + linear(F.gelu(linear(layer_norm(x, p["norm2"]), p["fc1"], mm)), p["fc2"], mm)


def patch_merging(x, p, res, mm=torch.matmul):
    B, L, C = x.shape
    x = x.reshape(B, res, res, C)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
    return mm(layer_norm(x.reshape(B, -1, 4 * C), p["norm"]), p["reduction"]["kernel"])


def htsat_compact(wave, enc_p, params, cfg, mm=torch.matmul):
    """(B, 320000) float32 -> (B, 33, num_features): [latent | c2l of the 32
    TSCAM steps]."""
    fe, enc = cfg["frontend"], cfg["encoder"]
    x = log_mel(wave, fe)  # (B, 1001, 64)
    bn = enc_p["bn0"]
    x = (x - bn["mean"]) / torch.sqrt(bn["var"] + 1e-5) * bn["scale"] + bn["bias"]
    target = enc["spec_size"] * (enc["spec_size"] // enc["mel_bins"])  # 1024
    x = F.interpolate(x[:, None], (target, x.shape[2]), mode="bicubic", align_corners=True)  # (B, 1, 1024, 64)
    # HTSAT's reshape_wav2img: time chunks stacked along frequency.
    fr = enc["spec_size"] // enc["mel_bins"]
    B, _, T, Fm = x.shape
    x = x.permute(0, 1, 3, 2).reshape(B, 1, Fm, fr, T // fr).permute(0, 1, 3, 2, 4).reshape(B, 1, fr * Fm, T // fr)
    ps, C = enc["patch_size"], enc["embed_dim"]
    conv_w = enc_p["patch_embed"]["kernel"].t().reshape(C, 1, ps, ps)
    x = F.conv2d(x, conv_w, enc_p["patch_embed"]["bias"], stride=enc["patch_stride"])
    x = layer_norm(x.flatten(2).transpose(1, 2), enc_p["patch_embed"]["norm"])
    res = enc["spec_size"] // enc["patch_stride"]
    for si, depth in enumerate(enc["depths"]):
        stage = enc_p["stages"][si]
        for d in range(depth):
            x = swin_block(x, stage["blocks"][d], res, enc["num_heads"][si], enc["window_size"],
                           0 if d % 2 == 0 else enc["window_size"] // 2, mm)
        if "downsample" in stage:
            x = patch_merging(x, stage["downsample"], res, mm)
            res //= 2
    x = layer_norm(x, enc_p["norm"])  # (B, res*res, nf)
    # TSCAM: frequency bins grouped, the (cfb, 3) conv along time.
    B, N, nf = x.shape
    SF = ST = res
    cfb = SF // fr
    x = x.transpose(1, 2).reshape(B, nf, SF // cfb, cfb, ST).permute(0, 1, 3, 2, 4).reshape(B, nf, cfb, -1)
    latent = x.flatten(2).mean(-1)
    nc = enc["num_classes"]
    conv = enc_p["tscam_conv"]
    steps = F.conv2d(x, conv["kernel"].t().reshape(nc, nf, cfb, 3), conv["bias"], padding=(0, 1))  # (B, nc, 1, 32)
    frames = torch.sigmoid(steps.flatten(2)).transpose(1, 2)  # (B, 32, nc)
    return torch.cat([latent[:, None], linear(frames, params["c2l"], mm)], 1)


def projection(x, p, mm=torch.matmul):
    e1 = mm(x, p["linear1"]["kernel"])
    return layer_norm(e1 + mm(F.gelu(e1), p["linear2"]["kernel"]), p["layer_norm"])


# ---------------------------------------------------------------------------
# Llama decoder (Hugging Face's LlamaForCausalLM, tied embeddings)
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(dec, S, device):
    hd = dec["head_dim"]
    inv = 1.0 / dec["rope_theta"] ** (np.arange(0, hd, 2, dtype=np.float64) / hd)
    ang = np.outer(np.arange(S, dtype=np.float64), inv)
    ang = np.concatenate([ang, ang], -1)
    return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(ang).astype(np.float32)).to(device))


def _rot(x, cos, sin):
    x1, x2 = x.chunk(2, -1)
    return x * cos + torch.cat([-x2, x1], -1) * sin


def decoder_logits(dp, dec, x, last: int, mm=torch.matmul):
    """Causal forward over embeddings x (B, S, D) -> (the logits of the last
    ``last`` positions (B, last, V), k, v): each layer's rotated keys and
    its values at every position, stacked (L, B, S, KV, hd)."""
    B, S, D = x.shape
    H, KV, hd = dec["num_heads"], dec["num_kv_heads"], dec["head_dim"]
    cos, sin = rope(dec, S, x.device)
    cos, sin = cos[None, None], sin[None, None]
    causal = torch.full((S, S), float("-inf"), device=x.device).triu(1)
    eps = dec["rms_norm_eps"]
    ks, vs = [], []
    for lp in dp["layers"]:
        h = rms_norm(x, lp["ln_attn"], eps)
        q = _rot(mm(h, lp["wq"]).reshape(B, S, H, hd).transpose(1, 2), cos, sin)
        k = _rot(mm(h, lp["wk"]).reshape(B, S, KV, hd).transpose(1, 2), cos, sin)
        v = mm(h, lp["wv"]).reshape(B, S, KV, hd).transpose(1, 2)
        ks.append(k.transpose(1, 2))
        vs.append(v.transpose(1, 2))
        k, v = k.repeat_interleave(H // KV, 1), v.repeat_interleave(H // KV, 1)
        a = mm(q, k.transpose(-1, -2)) / math.sqrt(hd) + causal
        o = mm(a.softmax(-1), v).transpose(1, 2).reshape(B, S, H * hd)
        x = x + mm(o, lp["wo"])
        h = rms_norm(x, lp["ln_mlp"], eps)
        x = x + mm(F.silu(mm(h, lp["w_gate"])) * mm(h, lp["w_up"]), lp["w_down"])
    h = rms_norm(x[:, S - last:], dp["norm_f"], eps)
    return mm(h, dp["embed"].t()), torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------------------------------
# the weight tree
# ---------------------------------------------------------------------------

def leaves(cfg: dict) -> list:
    """[(path, shape, kind)] of the whole weight tree this reference reads,
    which is the program's (the JAX package's layout, the decoder's layers
    a list of per-layer dicts): path a tuple of dict keys and list indices,
    kind "normal", "scale" or "var" (``port_bench/weights.py``).

      encoder: bn0 {scale, bias, mean, var}, patch_embed {kernel, bias,
               norm}, stages[i] {blocks[d] {norm1, qkv, proj,
               rel_bias_table, norm2, fc1, fc2}, downsample {norm,
               reduction}}, norm, tscam_conv, head
      c2l, projection {linear1, linear2, layer_norm}
      decoder: embed, layers[l] {ln_attn, ln_mlp, wq, wk, wv, wo, w_gate,
               w_up, w_down}, norm_f

    Biases and scales are drawn, not left at 0 and 1, so the check covers
    the paths that read them."""
    enc, dec = cfg["encoder"], cfg["decoder"]
    out = []

    def ln(path, dim):
        out.append((path + ("scale",), (dim,), "scale"))
        out.append((path + ("bias",), (dim,), "normal"))

    def lin(path, i, o, bias=True):
        out.append((path + ("kernel",), (i, o), "normal"))
        if bias:
            out.append((path + ("bias",), (o,), "normal"))

    e = ("encoder",)
    mel = enc["mel_bins"]
    out += [(e + ("bn0", "scale"), (mel,), "scale"), (e + ("bn0", "bias"), (mel,), "normal"),
            (e + ("bn0", "mean"), (mel,), "normal"), (e + ("bn0", "var"), (mel,), "var")]
    C = enc["embed_dim"]
    lin(e + ("patch_embed",), enc["patch_size"] ** 2, C)
    ln(e + ("patch_embed", "norm"), C)
    ws = enc["window_size"]
    for si, depth in enumerate(enc["depths"]):
        s = e + ("stages", si)
        for d in range(depth):
            b = s + ("blocks", d)
            ln(b + ("norm1",), C)
            lin(b + ("qkv",), C, 3 * C)
            lin(b + ("proj",), C, C)
            out.append((b + ("rel_bias_table",), ((2 * ws - 1) ** 2, enc["num_heads"][si]), "normal"))
            ln(b + ("norm2",), C)
            hidden = int(C * enc["mlp_ratio"])
            lin(b + ("fc1",), C, hidden)
            lin(b + ("fc2",), hidden, C)
        if si < len(enc["depths"]) - 1:
            ln(s + ("downsample", "norm"), 4 * C)
            lin(s + ("downsample", "reduction"), 4 * C, 2 * C, bias=False)
            C *= 2
    nf, nc = C, enc["num_classes"]
    ln(e + ("norm",), nf)
    cfb = enc["spec_size"] // (2 ** (len(enc["depths"]) - 1)) // enc["patch_stride"] // (enc["spec_size"] // mel)
    lin(e + ("tscam_conv",), nf * cfb * 3, nc)
    lin(e + ("head",), nc, nc)
    lin(("c2l",), nc, nf)
    dp = cfg["d_proj"]
    lin(("projection", "linear1"), nf, dp, bias=False)
    lin(("projection", "linear2"), dp, dp, bias=False)
    ln(("projection", "layer_norm"), dp)
    D, I = dec["hidden_size"], dec["intermediate_size"]
    H, KV, hd = dec["num_heads"], dec["num_kv_heads"], dec["head_dim"]
    out.append((("decoder", "embed"), (dec["vocab_size"], D), "normal"))
    for li in range(dec["num_layers"]):
        p = ("decoder", "layers", li)
        out += [(p + ("ln_attn",), (D,), "scale"), (p + ("ln_mlp",), (D,), "scale"),
                (p + ("wq",), (D, H * hd), "normal"), (p + ("wk",), (D, KV * hd), "normal"),
                (p + ("wv",), (D, KV * hd), "normal"), (p + ("wo",), (H * hd, D), "normal"),
                (p + ("w_gate",), (D, I), "normal"), (p + ("w_up",), (D, I), "normal"),
                (p + ("w_down",), (I, D), "normal")]
    out.append((("decoder", "norm_f"), (D,), "scale"))
    return out


# ---------------------------------------------------------------------------
# the whole model, teacher-forced
# ---------------------------------------------------------------------------

def to_f32(tree):
    """A copy of a weight tree with every tensor in float32."""
    if isinstance(tree, dict):
        return {k: to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_f32(v) for v in tree]
    return tree.float()


@torch.no_grad()
def prefix(p: dict, cfg: dict, wave1, wave2, text_ids, mm=torch.matmul) -> torch.Tensor:
    """The decoder's input prefix, (B, prefix_length, D) float32: [clip 1
    (129 rows) | sep | clip 2 (129) | sep | prompt (T)]. ``p``: the weights
    in float32 (``to_f32``); float32 waves (B, 320000) and int ids (B, T)
    on one device. ``mm``: every matrix product of the encoder's blocks
    and the projection (a lower-precision product turns the reference into
    a control)."""
    no_tf32()
    embed = p["decoder"]["embed"]
    a1, a2 = (projection(htsat_compact(w.float(), p["encoder"], p, cfg, mm), p["projection"], mm)
              for w in (wave1, wave2))

    def pooled(a):  # (B, 33, D) -> (B, 129, D): group g of 8 frame rows is step g // 4
        return torch.cat([a[:, :1], a[:, 1:].repeat_interleave(4, 1)], 1)

    B = text_ids.shape[0]
    sep = embed[cfg["sep_token_id"]].expand(B, 1, -1)
    return torch.cat([pooled(a1), sep, pooled(a2), sep, embed[text_ids.long()]], 1)


@torch.no_grad()
def decode(p: dict, cfg: dict, prefix_embeds, tokens, mm=torch.matmul):
    """Teacher-forced decoding after ``prefix_embeds`` (B, P, D) with the
    served ``tokens`` (B, n) fed back -> (logits (B, n, V), k, v): row i of
    the logits is the one token i was chosen from, and k, v (L, B, P + n -
    1, KV, hd) are the rotated keys and the values the cache holds once
    the decode steps have run: the prefill's at positions [0, P), a decode
    step's at each position P .. P + n - 2, one for each fed-back token but
    the last. ``mm`` as in ``prefix``."""
    no_tf32()
    dp = p["decoder"]
    n = tokens.shape[1]
    x = torch.cat([prefix_embeds.float(), dp["embed"][tokens[:, : n - 1].long()]], 1)
    return decoder_logits(dp, cfg["decoder"], x, n, mm)
