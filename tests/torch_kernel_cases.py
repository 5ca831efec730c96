"""Seeded inputs of the port's CUDA kernel tests, and the kernel calls whose
output digests ``tests/test_torch_kernels.py`` holds bit for bit.

``chip_smoke.py --ab`` runs the same digest cases over an earlier commit's
package and this one's, so both read the same inputs. Imports torch, numpy
and the port only; every tensor is made on the card."""

import hashlib

import numpy as np
import torch

from mellow_tpu_torch.models.llama import quantize_kv, quantize_weight
from mellow_tpu_torch.ops import attn_block as ab
from mellow_tpu_torch.ops import attn_block_w8a8 as aw
from mellow_tpu_torch.ops import decode_attention_int8 as di


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


def digest_case(name):
    """The outputs of one kernel call on seeded inputs (``attn_block_w8a8_kv``:
    #5's int8 k/v rows and scales alone)."""
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
