"""Seeded inputs of the port's CUDA kernel tests, and the kernel calls whose
output digests ``tests/test_torch_kernels.py`` holds bit for bit.

``chip_smoke.py --ab`` runs the same digest cases over an earlier commit's
package and this one's, so both read the same inputs. Imports torch, numpy
and the port only; every tensor is made on the card."""

import hashlib

import numpy as np
import torch

from mellow_tpu_torch.config import FrontendConfig
from mellow_tpu_torch.models.llama import quantize_kv, quantize_weight
from mellow_tpu_torch.ops import attn_block as ab
from mellow_tpu_torch.ops import attn_block_w8a8 as aw
from mellow_tpu_torch.ops import decode_attention as da
from mellow_tpu_torch.ops import decode_attention_int8 as di
from mellow_tpu_torch.ops import flash_gqa_prefill as fp
from mellow_tpu_torch.ops import melspec
from mellow_tpu_torch.ops import mlp_block as mb
from mellow_tpu_torch.ops import mlp_block_w8a8 as mw
from mellow_tpu_torch.ops import swin_block as sb
from mellow_tpu_torch.ops import window_attention as wa


def bf16(rng, *shape, scale=1.0, device="cuda"):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(device, torch.bfloat16)


def int8_weight(rng, *shape, scale=0.05):
    """int8 (in, out) weight values and their bf16 per-column scales."""
    q = quantize_weight(torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).cuda())
    return q["q"], q["scale"].bfloat16()


def int8_decode_inputs(B, n, E, s_max=450):
    """q, an int8 cache layer of s_max positions with its scales, and E bf16
    extra rows as a slice of a flush window's (B, 8, KV, hd) buffer."""
    rng = np.random.RandomState(n + 1)
    H, KV, hd = 9, 3, 64
    q = bf16(rng, B, H, hd)
    k8, ks = quantize_kv(bf16(rng, B, s_max, KV * hd, scale=0.5))
    v8, vs = quantize_kv(bf16(rng, B, s_max, KV * hd))
    k8, v8 = k8.reshape(B, s_max, KV, hd), v8.reshape(B, s_max, KV, hd)
    extra = (bf16(rng, B, 8, KV, hd, scale=0.5)[:, :E], bf16(rng, B, 8, KV, hd)[:, :E])
    return q, k8, v8, ks, vs, extra


def rope(S, hd):
    t = torch.arange(S, dtype=torch.float32, device="cuda")[:, None]
    inv = 1.0 / (100000.0 ** (torch.arange(0, hd, 2, device="cuda").float() / hd))
    emb = torch.cat([t * inv, t * inv], dim=-1)
    return emb.cos().bfloat16(), emb.sin().bfloat16()


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


# The digest cases of #8: v0's stages 1-3 at B=1 (R, C, H, shifted).
SWIN_STAGES = {"swin_block_s1": (64, 96, 4, True), "swin_block_s2": (32, 192, 8, False),
               "swin_block_s3": (16, 384, 16, True)}


def swin_inputs(rng, B, R, C, H, shifted):
    """x (B, R, R, C), the block's weights, the (H, 64, 64) bias and the
    grid's shifted-window mask (or None)."""
    from mellow_tpu_torch.models.htsat import shifted_window_mask

    def lin(i, o):
        return {"kernel": bf16(rng, i, o, scale=0.05), "bias": bf16(rng, o, scale=0.02)}

    def ln():
        return {"scale": bf16(rng, C, scale=0.1) + 1, "bias": bf16(rng, C, scale=0.02)}

    p = {"norm1": ln(), "qkv": lin(C, 3 * C), "proj": lin(C, C), "norm2": ln(),
         "fc1": lin(C, 4 * C), "fc2": lin(4 * C, C)}
    x = bf16(rng, B, R, R, C, scale=0.5)
    bias = bf16(rng, H, 64, 64, scale=0.5).float()
    mask = torch.from_numpy(shifted_window_mask(R, 8, 4)).cuda() if shifted else None
    return x, p, bias, mask


def digest_case(name):
    """The outputs of one kernel call on seeded inputs (``attn_block_w8a8_kv``:
    #5's int8 k/v rows and scales alone)."""
    if name == "mlp_block":
        rng = np.random.RandomState(6)
        D, I = 576, 1536
        x = bf16(rng, 1, 389, D, scale=0.5)
        ws = [bf16(rng, D, scale=0.1) + 1, bf16(rng, D, I, scale=0.05), bf16(rng, D, I, scale=0.05),
              bf16(rng, I, D, scale=0.05)]
        return (mb.mlp_block_cuda(x, *ws, eps=1e-5),)
    if name.startswith("mlp_block_w8a8"):
        # v0's prefill at B=1 or B=4, int8 weights as the wrapper makes them.
        rng = np.random.RandomState(7)
        B, D, I = (1 if name.endswith("b1") else 4), 576, 1536
        x = bf16(rng, B, 389, D, scale=0.5)
        ln = bf16(rng, D, scale=0.1) + 1
        ws = [t for shape in ((D, I), (D, I), (I, D)) for t in int8_weight(rng, *shape)]
        return (mw.mlp_block_w8a8_cuda(x, ln, *ws, eps=1e-5),)
    if name in SWIN_STAGES:
        R, C, H, shifted = SWIN_STAGES[name]
        x, p, bias, mask = swin_inputs(np.random.RandomState(8), 1, R, C, H, shifted)
        return (sb.swin_block_cuda(x, p, bias, mask, num_heads=H, window_size=8),)
    if name.startswith("window_attention"):
        # SW-MSA at B=1: HTSAT-large's stage 2 (R=32, C=512, H=8; hd = 64)
        # or v0's stage 1 widths (R=64, C=96, H=4; hd = 24).
        from mellow_tpu_torch.models.htsat import shifted_window_mask

        R, C, H = (64, 96, 4) if name.endswith("hd24") else (32, 512, 8)
        rng = np.random.RandomState(9)
        qkv = bf16(rng, (R // 8) ** 2, 64, 3 * C, scale=0.5)
        bias = bf16(rng, H, 64, 64, scale=0.5).float()
        mask = torch.from_numpy(shifted_window_mask(R, 8, 4)).cuda()
        return (wa.window_attention_cuda(qkv, bias, mask, num_heads=H),)
    if name.startswith("int8_decode"):
        # At a cluster of one block the kernel repeats the single-block
        # kernel's arithmetic operation for operation.
        B, n = (1, 389) if name.endswith("b1") else (4, 420)
        q, k8, v8, ks, vs, extra = int8_decode_inputs(B, n, 1)
        return (di.decode_attention_int8_cuda(q, k8, v8, ks, vs, n, *extra, blocks=1),)
    rng = np.random.RandomState(11)
    D, H, KV, hd, S = 576, 9, 3, 64, 389
    x = bf16(rng, 1, S, D, scale=0.5)
    kw = dict(num_heads=H, num_kv_heads=KV, head_dim=hd, eps=1e-5, kv_quant=name != "attn_block")
    if name.startswith("attn_block_w8a8"):
        ln = bf16(rng, D, scale=0.1) + 1
        ws = [t for shape in ((D, H * hd), (D, KV * hd), (D, KV * hd), (H * hd, D)) for t in int8_weight(rng, *shape)]
        out = aw.attn_block_w8a8_cuda(x, ln, *ws, *rope(S, hd), **kw)
        return out[1:] if name.endswith("_kv") else out
    ws = [bf16(rng, D, scale=0.1) + 1, bf16(rng, D, H * hd, scale=0.05), bf16(rng, D, KV * hd, scale=0.05),
          bf16(rng, D, KV * hd, scale=0.05), bf16(rng, H * hd, D, scale=0.05)]
    return ab.attn_block_cuda(x, *ws, *rope(S, hd), **kw)


def _grad_call(name, device):
    """Call kernel ``name``'s CUDA wrapper once on small tensors on
    ``device``, one of its float inputs requiring grad (#1: the wave)."""
    def t(*shape, grad=False, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device=device).requires_grad_(grad)

    D, H, KV, hd, S = 64, 4, 2, 16, 8
    w = t(D, D)
    calls = {
        "log_mel": lambda: melspec.log_mel_cuda(t(1, 16000, grad=True, dtype=torch.float32), FrontendConfig()),
        "decode_attention": lambda: da.decode_attention_cuda(t(1, H, hd, grad=True), t(1, S, KV, hd),
                                                             t(1, S, KV, hd), S),
        "decode_attention_int8": lambda: di.decode_attention_int8_cuda(
            t(1, H, hd), t(1, S, KV, hd, dtype=torch.int8), t(1, S, KV, hd, dtype=torch.int8),
            t(1, S, dtype=torch.float32), t(1, S, dtype=torch.float32), S, t(1, 1, KV, hd, grad=True),
            t(1, 1, KV, hd)),
        "attn_block": lambda: ab.attn_block_cuda(t(1, S, D), t(D), w, t(D, KV * hd), t(D, KV * hd), t(D, D, grad=True),
                                                 t(S, hd), t(S, hd), num_heads=H, num_kv_heads=KV, head_dim=hd,
                                                 eps=1e-5),
        "attn_block_w8a8": lambda: aw.attn_block_w8a8_cuda(
            t(1, S, D, grad=True), t(D), t(D, D, dtype=torch.int8), t(D), t(D, KV * hd, dtype=torch.int8), t(KV * hd),
            t(D, KV * hd, dtype=torch.int8), t(KV * hd), t(D, D, dtype=torch.int8), t(D), t(S, hd), t(S, hd),
            num_heads=H, num_kv_heads=KV, head_dim=hd, eps=1e-5),
        "mlp_block": lambda: mb.mlp_block_cuda(t(1, S, D), t(D, grad=True), t(D, 128), t(D, 128), t(128, D), eps=1e-5),
        "mlp_block_w8a8": lambda: mw.mlp_block_w8a8_cuda(
            t(1, S, D, grad=True), t(D), t(D, 128, dtype=torch.int8), t(128), t(D, 128, dtype=torch.int8), t(128),
            t(128, D, dtype=torch.int8), t(D), eps=1e-5),
        "swin_block": lambda: sb.swin_block_cuda(
            t(1, 8, 8, 96), {a: {b: t(96, 96, grad=(a, b) == ("qkv", "kernel")) for b in ("kernel", "bias", "scale")}
                             for a, _ in sb.WEIGHT_KEYS},
            t(4, 64, 64, dtype=torch.float32), None, num_heads=4, window_size=8),
        "window_attention": lambda: wa.window_attention_cuda(t(4, 64, 3 * 96, grad=True),
                                                             t(4, 64, 64, dtype=torch.float32), None, num_heads=4),
        "flash_gqa_prefill": lambda: fp.flash_gqa_prefill_cuda(t(1, S, H * hd, grad=True), t(1, S, KV * hd),
                                                               t(1, S, KV * hd), num_heads=H, num_kv_heads=KV,
                                                               head_dim=hd),
    }
    return calls[name]()


GRAD_REFUSALS = ("log_mel", "decode_attention", "decode_attention_int8", "attn_block", "attn_block_w8a8",
                 "mlp_block", "mlp_block_w8a8", "swin_block", "window_attention", "flash_gqa_prefill")


def refuses_grad(name, device) -> None:
    """Kernel ``name``'s CUDA wrapper raises, naming the missing backward,
    when an input requires grad, and launches nothing."""
    mod = {"log_mel": melspec, "decode_attention": da, "decode_attention_int8": di, "attn_block": ab,
           "attn_block_w8a8": aw, "mlp_block": mb, "mlp_block_w8a8": mw, "swin_block": sb,
           "window_attention": wa, "flash_gqa_prefill": fp}[name]
    before = mod.LAUNCHES
    try:
        _grad_call(name, device)
    except RuntimeError as e:
        assert "has no backward" in str(e), e
    else:
        raise AssertionError(f"{name}: a tensor that requires grad was taken")
    assert mod.LAUNCHES == before
